"""Fused ternary decompress + add (expert merge): CUDA kernel wrappers +
plain versions.

Port of ``repro/kernels/unpack_add.py``.  Single-expert form (the oracle
of the fused form, through ``ops.apply_ternary_delta(_flat)``; no serving
path calls it):

    out[M, N] = base[M, N] + scale * (pos - neg)[M, N]

and multi-expert form (merge-on-swap and merged ensembles, through
``ops.apply_ternary_delta_many_flat``):

    out = base;  out = to_dtype(f32(out) + scales[e] * (pos_e - neg_e))  per e

rounded through the base dtype after every expert, so the fused form is
bitwise a loop of the single-expert form.  Planes are int32 words packed
along the last axis, ``ceil(N/32)`` per row; bits at or beyond N are never
applied.  Both wrappers launch the one kernel of ``csrc/unpack_add.cu``
(the single-expert form with E = 1); bases in float32 and bfloat16 are
served, any other dtype raises on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.packing import LANE
from repro_torch.kernels import build
from repro_torch.kernels.ref import unpack_add_many_ref, unpack_add_ref

unpack_add_plain = unpack_add_ref
unpack_add_many_plain = unpack_add_many_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(base, pos, neg, scales, what: str) -> torch.Tensor:
    """Check and launch the kernel on a CUDA base [M, N] with planes
    [E, M, ceil(N/32)] (any strides) and f32 scales [E]."""
    if base.device.type != "cuda":
        raise ValueError(f"unsupported device {base.device}")
    if base.dtype not in _DTYPES:
        raise ValueError(f"base dtype {base.dtype} is not served by the "
                         "kernel (float32 or bfloat16)")
    if base.dim() != 2 or not base.is_contiguous():
        raise ValueError("base must be a contiguous [M, N] tensor")
    M, N = base.shape
    want = (pos.shape[0], M, -(-N // LANE))
    for p in (pos, neg):
        if p.dtype != torch.int32 or tuple(p.shape) != want:
            raise ValueError(f"planes must be int32 {want}; got "
                             f"{p.dtype} {tuple(p.shape)}")
        if p.device != base.device:
            raise ValueError("planes and base must share a device")
    if pos.stride() != neg.stride():
        raise ValueError("pos and neg must share their strides")
    if (scales.dtype != torch.float32 or scales.numel() != pos.shape[0]
            or not scales.is_contiguous() or scales.device != base.device):
        raise ValueError("scales must be a contiguous float32 tensor with "
                         "one value per expert, on base's device")
    out = torch.empty_like(base)
    lib = build.library("unpack_add")
    stream = torch.cuda.current_stream(base.device).cuda_stream
    rc = lib.unpack_add_many(base.data_ptr(), pos.data_ptr(), neg.data_ptr(),
                             scales.data_ptr(), out.data_ptr(), pos.shape[0],
                             M, N, *pos.stride(), _DTYPES[base.dtype], stream)
    build.check(rc, what)
    return out


def unpack_add(base: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """base [M, N]; pos/neg int32 [M, ceil(N/32)] (any strides); scale f32
    (one value).  Returns base + scale * (pos - neg) in base's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (built at first use; the fused form with E = 1) or raises."""
    if base.device.type == "cpu":
        return unpack_add_plain(base, pos, neg, scale)
    out = _launch(base, pos[None], neg[None], scale.reshape(1), "unpack_add")
    unpack_add.launches += 1
    return out


def unpack_add_many(base: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """base [M, N]; pos/neg int32 [E, M, ceil(N/32)] (any strides); scales
    f32 [E], already multiplied by any ensemble weights.  Returns
    ``base + sum_e scales[e] * (pos_e - neg_e)`` in base's dtype, rounded
    after every expert.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (built at first use) or raises."""
    if base.device.type == "cpu":
        return unpack_add_many_plain(base, pos, neg, scales)
    out = _launch(base, pos, neg, scales, "unpack_add_many")
    unpack_add_many.launches += 1
    return out


unpack_add.launches = 0
unpack_add_many.launches = 0
