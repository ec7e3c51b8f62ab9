"""Ternary dot product by AND + POPCNT: CUDA kernel wrapper + plain version.

Port of ``repro/kernels/popcount_dot.py``: for two ternary vectors held
as flat bit planes of W int32 words (the uint32 bits of the reference),

    dot = popc(a+ & b+) + popc(a- & b-) - popc(a+ & b-) - popc(a- & b+)

as a 0-d int32 tensor; scales are applied by the caller.  The kernel is
``csrc/popcount_dot.cu``.  The sum is an integer, so the kernel and the
plain version agree bitwise whatever their order.
"""

from __future__ import annotations

import torch

from repro_torch.core.packing import LANE
from repro_torch.kernels import build
from repro_torch.kernels.ref import popcount_dot_ref

popcount_dot_plain = popcount_dot_ref

MAX_WORDS = (2 ** 31 - 1) // LANE   # |dot| <= 32 W must fit in an int32


def popcount_dot(a_pos: torch.Tensor, a_neg: torch.Tensor,
                 b_pos: torch.Tensor, b_neg: torch.Tensor) -> torch.Tensor:
    """Four contiguous flat int32 plane arrays of one length W -> the
    integer ternary dot (0-d int32).  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    if a_pos.device.type == "cpu":
        return popcount_dot_plain(a_pos, a_neg, b_pos, b_neg)
    if a_pos.device.type != "cuda":
        raise ValueError(f"unsupported device {a_pos.device}")
    W = a_pos.numel()
    for p in (a_pos, a_neg, b_pos, b_neg):
        if (p.dtype != torch.int32 or p.dim() != 1 or p.numel() != W
                or not p.is_contiguous() or p.device != a_pos.device):
            raise ValueError("planes must be four contiguous flat int32 "
                             "tensors of one length on one device")
    if W > MAX_WORDS:
        raise ValueError(f"{W} words: the dot could overflow an int32")
    out = torch.zeros((1,), dtype=torch.int32, device=a_pos.device)
    lib = build.library("popcount_dot")
    stream = torch.cuda.current_stream(a_pos.device).cuda_stream
    rc = lib.popcount_dot(a_pos.data_ptr(), a_neg.data_ptr(),
                          b_pos.data_ptr(), b_neg.data_ptr(), W,
                          out.data_ptr(), stream)
    build.check(rc, "popcount_dot")
    popcount_dot.launches += 1
    return out[0]


popcount_dot.launches = 0
