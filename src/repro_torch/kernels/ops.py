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
through the kernels.  A wrapper called while a CUDA graph is captured
counts a launch that the capture only records; the graph's owner takes
those counts back and adds them again on every replay
(:func:`add_launches`), so the counts keep meaning launches.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels.histogram_quantile import (_segment_absmax,
                                                    segment_absmax,
                                                    segment_hist_moments,
                                                    segment_hist_moments_plain)
from repro_torch.kernels.pack import (pack_ternary_planes,
                                      pack_ternary_planes_plain,
                                      pack_ternary_planes_segmented,
                                      pack_ternary_planes_segmented_plain)
from repro_torch.kernels.popcount_dot import popcount_dot, popcount_dot_plain
from repro_torch.kernels.sample import sample_tokens, sample_tokens_plain
from repro_torch.kernels.ternary_matmul import (ternary_matmul,
                                                ternary_matmul_grouped,
                                                ternary_matmul_grouped_plain,
                                                ternary_matmul_plain)
from repro_torch.kernels.unpack_add import (unpack_add, unpack_add_many,
                                            unpack_add_many_plain,
                                            unpack_add_plain)

KERNELS = {
    "ternary_matmul_grouped": ternary_matmul_grouped,
    "pack_ternary_planes_segmented": pack_ternary_planes_segmented,
    "segment_hist_moments": segment_hist_moments,
    "segment_absmax": segment_absmax,
    "unpack_add_many": unpack_add_many,
    "unpack_add": unpack_add,
    "ternary_matmul": ternary_matmul,
    "pack_ternary_planes": pack_ternary_planes,
    "popcount_dot": popcount_dot,
    "sample_tokens": sample_tokens,
}
PLAIN = {
    "ternary_matmul_grouped": ternary_matmul_grouped_plain,
    "pack_ternary_planes_segmented": pack_ternary_planes_segmented_plain,
    "segment_hist_moments": segment_hist_moments_plain,
    "segment_absmax": _segment_absmax,
    "unpack_add_many": unpack_add_many_plain,
    "unpack_add": unpack_add_plain,
    "ternary_matmul": ternary_matmul_plain,
    "pack_ternary_planes": pack_ternary_planes_plain,
    "popcount_dot": popcount_dot_plain,
    "sample_tokens": sample_tokens_plain,
}
_table = KERNELS


def kernel(name: str):
    """The function the path calls for kernel ``name``: its device-
    dispatching wrapper, or its plain version inside :func:`plain_versions`."""
    return _table[name]


def table() -> dict:
    """The dispatch table in force: a cache of work done through
    :func:`kernel` (a CUDA graph) keys by it."""
    return _table


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


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches, negative to take back) to
    the wrappers' counters: a CUDA graph's launches per replay."""
    for name, n in counts.items():
        KERNELS[name].launches += n


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


# ---------------------------------------------------------------------------
# Expert merges (merge-on-swap and merged ensembles)
# ---------------------------------------------------------------------------

def apply_ternary_delta(base: torch.Tensor, pt) -> torch.Tensor:
    """Expert loading of a 2-D leaf whose planes are padded per row:
    base [M, N] + scale * (pos - neg), fused."""
    M = base.shape[0]
    return kernel("unpack_add")(base, pt.pos.reshape(M, -1),
                                pt.neg.reshape(M, -1),
                                pt.scale.to(torch.float32))


def apply_ternary_delta_flat(base: torch.Tensor, pt) -> torch.Tensor:
    """Rank-agnostic fused merge: base (any shape) + scale * (pos - neg),
    over the [1, n] view of the leaf.  Traffic is the base read and
    written once plus 2 bits per element; no dense delta exists.

    The reference pads each leaf to rows of 4096 elements; the planes are
    packed over the flat C-order leaf, so ceil(n/32) words of one [1, n]
    row cover it and the kernel masks the ragged tail, giving the same
    bits without a padded copy of the base."""
    n = base.numel()
    out = kernel("unpack_add")(base.reshape(1, n), pt.pos.reshape(1, -1),
                               pt.neg.reshape(1, -1),
                               pt.scale.to(torch.float32))
    return out.reshape(base.shape)


def apply_ternary_delta_many_flat(base: torch.Tensor, pts,
                                  weights=None) -> torch.Tensor:
    """Fused multi-expert merge of one leaf: base + sum_e w_e * scale_e *
    Delta_e in one sweep, bitwise a loop of :func:`apply_ternary_delta_flat`
    over the weight-scaled experts.

    ``pts``: PackedTernary over the leaf's shape; ``weights`` (len E) the
    ensemble coefficients, multiplied into the scales in f32 here, as the
    reference does, never inside the kernel.  One expert's planes pass as
    a view; several are stacked into one [E, 1, W] buffer.
    """
    n = base.numel()
    if len(pts) == 1:
        pos = pts[0].pos.reshape(1, 1, -1)
        neg = pts[0].neg.reshape(1, 1, -1)
    else:
        pos = torch.stack([pt.pos.reshape(1, -1) for pt in pts])
        neg = torch.stack([pt.neg.reshape(1, -1) for pt in pts])
    scales = torch.stack([pt.scale.to(torch.float32).reshape(())
                          for pt in pts])
    if weights is not None:
        scales = scales * torch.as_tensor(weights, dtype=torch.float32,
                                          device=scales.device)
    out = kernel("unpack_add_many")(base.reshape(1, n), pos, neg, scales)
    return out.reshape(base.shape)


# ---------------------------------------------------------------------------
# Single-expert entry points (the reference's ``benchmarks/run.py`` drives
# them; the artifact path and the ternary algebra reach the last two)
# ---------------------------------------------------------------------------

def ternary_matvec(x: torch.Tensor, pt) -> torch.Tensor:
    """y = x @ (scale * ternary[K, N]) without materialising the matrix.

    x: [K] or [M, K]; pt: PackedTernary of a [K, N] leaf with N % 32 == 0
    (its flat planes are then [K, N/32] row by row).  x is cast to f32."""
    K, N = pt.shape
    if N % 32:
        raise ValueError(f"leaf {pt.shape}: the flat planes split into "
                         "[K, N/32] rows only when N % 32 == 0")
    squeeze = x.dim() == 1
    x2 = (x[None] if squeeze else x).to(torch.float32).contiguous()
    y = kernel("ternary_matmul")(x2, pt.pos.reshape(K, -1),
                                 pt.neg.reshape(K, -1),
                                 pt.scale.to(torch.float32))[:, :N]
    return y[0] if squeeze else y


def compress_to_planes(tau: torch.Tensor, thr):
    """Fused threshold + sign + pack of a [M, N] task-vector leaf against
    one threshold: (pos, neg) int32 [M, ceil(N/32)]."""
    thr = torch.as_tensor(thr, dtype=torch.float32, device=tau.device)
    return kernel("pack_ternary_planes")(tau, thr)


def expert_dot(a, b) -> torch.Tensor:
    """Scaled ternary dot of two PackedTernary via AND + POPCNT (f32)."""
    d = kernel("popcount_dot")(a.pos.reshape(-1), a.neg.reshape(-1),
                               b.pos.reshape(-1), b.neg.reshape(-1))
    return d.to(torch.float32) * a.scale * b.scale
