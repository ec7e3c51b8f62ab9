"""Entry points over the port's kernels, dispatched by tensor device.

Replaces the backend flag of ``repro/kernels/ops.py`` (``INTERPRET``): a
CPU tensor takes a kernel's plain PyTorch version, a CUDA tensor launches
the hand-written kernel or raises.  The model and the compression path
reach every kernel through :func:`kernel`; inside :func:`plain_versions`
it hands out the plain versions instead, so that a check on the card can
run the same path through both on the same inputs.

Each kernel wrapper counts its launches in a plain integer
(``wrapper.launches``); :func:`reset_launch_counts` and
:func:`launch_counts` read them, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.histogram_quantile import (segment_hist_moments,
                                                    segment_hist_moments_plain)
from repro_torch.kernels.pack import (pack_ternary_planes_segmented,
                                      pack_ternary_planes_segmented_plain)
from repro_torch.kernels.ternary_matmul import (ternary_matmul_grouped,
                                                ternary_matmul_grouped_plain)

KERNELS = {
    "ternary_matmul_grouped": ternary_matmul_grouped,
    "pack_ternary_planes_segmented": pack_ternary_planes_segmented,
    "segment_hist_moments": segment_hist_moments,
}
PLAIN = {
    "ternary_matmul_grouped": ternary_matmul_grouped_plain,
    "pack_ternary_planes_segmented": pack_ternary_planes_segmented_plain,
    "segment_hist_moments": segment_hist_moments_plain,
}
_table = KERNELS


def kernel(name: str):
    """The function the path calls for kernel ``name``: its device-
    dispatching wrapper, or its plain version inside :func:`plain_versions`."""
    return _table[name]


@contextlib.contextmanager
def plain_versions():
    """Within the block, :func:`kernel` hands out the plain versions on
    every device.  For checks that hold the kernels against them; the
    main path never enters it."""
    global _table
    prev, _table = _table, PLAIN
    try:
        yield
    finally:
        _table = prev


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def grouped_delta_matmul(x: torch.Tensor, pos: torch.Tensor,
                         neg: torch.Tensor, scales: torch.Tensor,
                         expert_idx: torch.Tensor, *,
                         transpose_rhs: bool = False,
                         n_out: int | None = None) -> torch.Tensor:
    """Zero-merge hot path: per-row-expert delta contraction.

    x: [M, K]; pos/neg: stacked int32 [E, K, N/32] ([E, N, ceil(K/32)]
    when ``transpose_rhs``); scales [E]; expert_idx [M] int32 (-1 -> zero
    delta).  Returns the f32 delta [M, N] to add onto ``x @ W_base``.
    """
    x = x.to(torch.float32).contiguous()
    expert_idx = expert_idx.to(torch.int32).contiguous()
    y = kernel("ternary_matmul_grouped")(x, pos, neg, scales, expert_idx,
                                         transpose_rhs=transpose_rhs)
    return y if n_out is None else y[:, :n_out]
