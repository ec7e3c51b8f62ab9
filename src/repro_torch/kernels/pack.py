"""Fused threshold + sign + bit-plane pack: CUDA kernel wrappers + plain
versions.

Port of ``repro/kernels/pack.py``.  The segmented form
(``pack_ternary_planes_segmented``, the streaming compression) is one
launch over the flat ``[R, C]`` segment buffer that holds every leaf of a
task vector, with one threshold per row,

    keep = |tau| >= thr[r];  pos = pack(keep & tau > 0);
    neg = pack(keep & tau < 0)

into int32 words ``[R, C/32]`` (32 little-endian bits each).  The scalar
form (``pack_ternary_planes``, the exact compression and
``ops.compress_to_planes``) packs one ``[M, N]`` tensor against one
threshold into ``[M, ceil(N/32)]`` words, with zero bits past N.  Both
kernels are in ``csrc/pack.cu``.
"""

from __future__ import annotations

import torch

from repro_torch.core.packing import LANE
from repro_torch.kernels import build
from repro_torch.kernels.ref import (pack_ternary_planes_ref,
                                     pack_ternary_planes_segmented_ref)

pack_ternary_planes_segmented_plain = pack_ternary_planes_segmented_ref
pack_ternary_planes_plain = pack_ternary_planes_ref


def pack_ternary_planes_segmented(tau: torch.Tensor, thr_rows: torch.Tensor):
    """tau [R, C] f32 (C % 32 == 0), thr_rows [R] f32 -> (pos, neg) int32
    [R, C/32].  CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if tau.device.type == "cpu":
        return pack_ternary_planes_segmented_plain(tau, thr_rows)
    if tau.device.type != "cuda":
        raise ValueError(f"unsupported device {tau.device}")
    if tau.dtype != torch.float32 or tau.dim() != 2 or not tau.is_contiguous():
        raise ValueError("tau must be a contiguous [R, C] float32 tensor")
    R, C = tau.shape
    if C % LANE:
        raise ValueError(f"C={C} must be a multiple of {LANE}")
    if (thr_rows.dtype != torch.float32 or thr_rows.shape != (R,)
            or not thr_rows.is_contiguous()
            or thr_rows.device != tau.device):
        raise ValueError("thr_rows must be a contiguous [R] float32 tensor "
                         "on tau's device")
    pos = torch.empty((R, C // LANE), dtype=torch.int32, device=tau.device)
    neg = torch.empty_like(pos)
    lib = build.library("pack")
    stream = torch.cuda.current_stream(tau.device).cuda_stream
    rc = lib.pack_ternary_planes_segmented(
        tau.data_ptr(), thr_rows.data_ptr(), pos.data_ptr(), neg.data_ptr(),
        R, C, stream)
    build.check(rc, "pack_ternary_planes_segmented")
    pack_ternary_planes_segmented.launches += 1
    return pos, neg


pack_ternary_planes_segmented.launches = 0


def pack_ternary_planes(tau: torch.Tensor, thr: torch.Tensor):
    """tau [M, N] float (any N; cast to f32), thr one f32 value on tau's
    device -> (pos, neg) int32 [M, ceil(N/32)], zero bits past N.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if tau.device.type == "cpu":
        return pack_ternary_planes_plain(tau, thr)
    if tau.device.type != "cuda":
        raise ValueError(f"unsupported device {tau.device}")
    if tau.dim() != 2 or not tau.is_floating_point():
        raise ValueError("tau must be a floating [M, N] tensor")
    if thr.numel() != 1 or thr.device != tau.device:
        raise ValueError("thr must be one value on tau's device")
    tau = tau.to(torch.float32).contiguous()
    thr = thr.to(torch.float32).reshape(1).contiguous()
    M, N = tau.shape
    pos = torch.empty((M, -(-N // LANE)), dtype=torch.int32,
                      device=tau.device)
    neg = torch.empty_like(pos)
    lib = build.library("pack")
    stream = torch.cuda.current_stream(tau.device).cuda_stream
    rc = lib.pack_ternary_planes(tau.data_ptr(), thr.data_ptr(),
                                 pos.data_ptr(), neg.data_ptr(), M, N, stream)
    build.check(rc, "pack_ternary_planes")
    pack_ternary_planes.launches += 1
    return pos, neg


pack_ternary_planes.launches = 0
