"""Dense x packed-ternary matmul: CUDA kernel wrappers + plain versions.

Port of ``repro/kernels/ternary_matmul.py``.  The grouped form
(``ternary_matmul_grouped``) is the zero-merge serving hot path: one
launch contracts a batch whose rows carry different experts against the
experts' stacked bit planes,

    y[m, :] = scales[e(m)] * (x[m, :] @ T_{e(m)})     (e(m) = -1 -> 0)

and a row's result never depends on the other rows or on which experts
they carry.  The single-expert form (``ternary_matmul``, through
``ops.ternary_matvec``) computes ``scale * (x @ T)`` in the grouped
kernel's summation order, so a grouped row equals it bitwise.  Both
kernels are in ``csrc/ternary_matmul.cu`` (see its header for the design,
its summation order and what bounds them).
"""

from __future__ import annotations

import torch

from repro_torch.core.packing import LANE
from repro_torch.kernels import build
from repro_torch.kernels.ref import (ternary_matmul_grouped_ref,
                                     ternary_matmul_ref)

# the plain versions: the oracles of the JAX package, in PyTorch
ternary_matmul_grouped_plain = ternary_matmul_grouped_ref
ternary_matmul_plain = ternary_matmul_ref

H100_SMS = 132          # streaming multiprocessors of the target card


def launch_cols(N: int, transpose_rhs: bool) -> int:
    """Plane-word columns per block of the normal form (1 or 2): 2 where
    that still gives a launch one block per SM (1 in the transposed form,
    where a warp takes one output row).  It
    decides which block computes an output, never the order of its sum:
    the K partition is fixed in ``csrc/ternary_matmul.cu`` by K alone.
    It takes no M, so the launch geometry cannot follow the batch."""
    if transpose_rhs:
        return 1
    W = -(-N // LANE)
    return 2 if -(-W // 2) >= H100_SMS else 1


def _check_planes(pos, neg, device):
    if pos.dtype != torch.int32 or neg.dtype != torch.int32:
        raise TypeError("planes must be int32 words")
    if pos.dim() != 3 or pos.shape != neg.shape:
        raise ValueError(f"planes must be [E, A, W]; got {tuple(pos.shape)} "
                         f"and {tuple(neg.shape)}")
    if pos.device != device or neg.device != device:
        raise ValueError("planes and x must share a device")
    A, W = pos.shape[1], pos.shape[2]
    for p in (pos, neg):
        if p.stride(2) != 1 or (A > 1 and p.stride(1) != W):
            raise ValueError("each expert's [A, W] plane block must be "
                             "contiguous")
    if pos.stride(0) != neg.stride(0):
        raise ValueError("pos and neg must share the expert stride")


def ternary_matmul_grouped(x: torch.Tensor, pos: torch.Tensor,
                           neg: torch.Tensor, scales: torch.Tensor,
                           expert_idx: torch.Tensor, *,
                           transpose_rhs: bool = False) -> torch.Tensor:
    """x [M, K] f32; pos/neg int32 [E, K, N/32] ([E, N, ceil(K/32)] when
    ``transpose_rhs``); scales [E] f32; expert_idx [M] int32 in [-1, E).
    Returns the f32 delta [M, N].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (built at first use) or raises.  ``expert_idx`` is not read
    back to the host, so its range is the caller's contract.
    """
    if x.device.type == "cpu":
        return ternary_matmul_grouped_plain(x, pos, neg, scales, expert_idx,
                                            transpose_rhs=transpose_rhs)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [M, K] float32 tensor")
    _check_planes(pos, neg, x.device)
    M, K = x.shape
    E, A, W = pos.shape
    if transpose_rhs:
        N = A
        if W != -(-K // LANE):
            raise ValueError(f"transposed planes need ceil(K/32)={-(-K // LANE)}"
                             f" words per row; got {W}")
    else:
        N = W * LANE
        if A != K:
            raise ValueError(f"planes have K={A}; x has K={K}")
    if (scales.dtype != torch.float32 or scales.shape != (E,)
            or not scales.is_contiguous() or scales.device != x.device):
        raise ValueError("scales must be a contiguous [E] float32 tensor on "
                         "x's device")
    if (expert_idx.dtype != torch.int32 or expert_idx.shape != (M,)
            or not expert_idx.is_contiguous()
            or expert_idx.device != x.device):
        raise ValueError("expert_idx must be a contiguous [M] int32 tensor "
                         "on x's device")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = build.library("ternary_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ternary_matmul_grouped(
        x.data_ptr(), pos.data_ptr(), neg.data_ptr(), scales.data_ptr(),
        expert_idx.data_ptr(), out.data_ptr(), M, K, N, W, E, pos.stride(0),
        int(transpose_rhs), launch_cols(N, transpose_rhs), stream)
    build.check(rc, "ternary_matmul_grouped")
    ternary_matmul_grouped.launches += 1
    return out


ternary_matmul_grouped.launches = 0


def ternary_matmul(x: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] f32; pos/neg int32 [K, N/32] (contiguous); scale one f32
    value.  Returns ``scale * (x @ T)``, f32 [M, N].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (built at first use) or raises."""
    if x.device.type == "cpu":
        return ternary_matmul_plain(x, pos, neg, scale)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous [M, K] float32 tensor")
    M, K = x.shape
    for p in (pos, neg):
        if (p.dtype != torch.int32 or p.dim() != 2 or p.shape[0] != K
                or p.shape != pos.shape or not p.is_contiguous()
                or p.device != x.device):
            raise ValueError(f"planes must be contiguous int32 [K={K}, W] "
                             "tensors on x's device")
    if (scale.dtype != torch.float32 or scale.numel() != 1
            or scale.device != x.device):
        raise ValueError("scale must be one float32 value on x's device")
    W = pos.shape[1]
    out = torch.empty((M, W * LANE), dtype=torch.float32, device=x.device)
    scale = scale.reshape(1).contiguous()
    lib = build.library("ternary_matmul")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.ternary_matmul(x.data_ptr(), pos.data_ptr(), neg.data_ptr(),
                            scale.data_ptr(), out.data_ptr(), M, K, W * LANE,
                            W, launch_cols(W * LANE, False), stream)
    build.check(rc, "ternary_matmul")
    ternary_matmul.launches += 1
    return out


ternary_matmul.launches = 0
