"""ComPEFT (Algorithm 1) straight to packed bitplanes, in PyTorch.

Port of the streaming path of ``repro/core/compeft.py``: every leaf of a
task vector goes into one flat segment buffer, a two-pass histogram finds
each leaf's top-k magnitude threshold and its std in O(n), and one pack
launch writes the sign planes of all leaves:

  1. keep the signs of the top-``k`` fraction of entries by magnitude;
  2. replace every surviving magnitude by ``alpha * std(tau)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core.packing import LANE, PackedTernary


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """Hyper-parameters of Algorithm 1 (the JAX package's fields).

    density: fraction ``k`` of entries whose sign survives; alpha: the
    multiplier on ``std(tau)``; per_tensor: one threshold and scale per
    leaf (True) or one over the whole vector; scale_mode: 'std' (paper),
    'mean_abs' or 'none'.
    """

    density: float = 0.05
    alpha: float = 1.0
    per_tensor: bool = True
    scale_mode: str = "std"

    def __post_init__(self):
        if not (0.0 < self.density <= 1.0):
            raise ValueError(f"density must be in (0, 1], got {self.density}")
        if self.alpha <= 0.0:
            raise ValueError(f"alpha must be > 0, got {self.alpha}")
        if self.scale_mode not in ("std", "mean_abs", "none"):
            raise ValueError(f"unknown scale_mode {self.scale_mode!r}")


STREAM_COLS = 8192  # segment-buffer row width; a multiple of the 32-bit lane


def _build_segment_buffer(leaves, cols: int, device):
    """Copy flattened leaves into a zero-padded [R, cols] f32 buffer.

    Each leaf is padded to whole rows, so every row belongs to exactly one
    leaf (segment) and a per-row threshold is a per-leaf threshold.
    Returns the buffer, the row->segment map and per-row valid counts
    (int32 [R]), per-segment element counts (int32 [S]) and each leaf's
    (row_start, row_end).
    """
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves]
    rows = [-(-n // cols) for n in sizes]
    buf = torch.zeros((sum(rows), cols), dtype=torch.float32, device=device)
    flat = buf.view(-1)
    row_seg, row_valid, spans = [], [], []
    r = 0
    for i, (leaf, n, nr) in enumerate(zip(leaves, sizes, rows)):
        flat[r * cols:r * cols + n] = leaf.reshape(-1).to(device, torch.float32)
        row_seg.append(np.full(nr, i, np.int32))
        valid = np.full(nr, cols, np.int32)
        valid[-1] = n - (nr - 1) * cols
        row_valid.append(valid)
        spans.append((r, r + nr))
        r += nr
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)  # noqa: E731
    return (buf, as_t(np.concatenate(row_seg)),
            as_t(np.concatenate(row_valid)), as_t(np.asarray(sizes)), spans)


def compress_packed(tau: dict, cfg: CompressionConfig | None = None, *,
                    cols: int = STREAM_COLS, return_stats: bool = False):
    """Algorithm 1 on a nested-dict task vector, straight to bitplanes.

    Runs on the device the leaves are on.  Returns a tree of
    :class:`PackedTernary` with the structure of ``tau`` (and the threshold
    statistics with ``return_stats``).
    """
    from repro_torch.kernels import ops
    from repro_torch.kernels.histogram_quantile import \
        segmented_quantile_moments

    cfg = cfg or CompressionConfig()
    flat = tree_util.flatten_with_paths(tau)
    if not flat:
        return ({}, {}) if return_stats else {}
    leaves = [leaf for _, leaf in flat]
    device = leaves[0].device
    buf, row_seg, row_valid, seg_count, spans = _build_segment_buffer(
        leaves, cols, device)
    if cfg.per_tensor:
        n_seg, seg_ids = len(leaves), row_seg
    else:       # one global threshold and scale over the whole vector
        n_seg, seg_ids = 1, torch.zeros_like(row_seg)
        seg_count = seg_count.sum(dtype=torch.int32, dim=0, keepdim=True)
    stats = segmented_quantile_moments(buf, seg_ids, row_valid, seg_count,
                                       cfg.density, n_seg=n_seg)
    if cfg.scale_mode == "std":
        sigma = stats["std"]
    elif cfg.scale_mode == "mean_abs":
        sigma = stats["mean_abs"]
    else:
        sigma = torch.ones((n_seg,), dtype=torch.float32, device=device)
    scales = torch.tensor(cfg.alpha, dtype=torch.float32,
                          device=device) * sigma

    thr_rows = stats["threshold"][seg_ids.to(torch.int64)].contiguous()
    pos, neg = ops.kernel("pack_ternary_planes_segmented")(buf, thr_rows)
    del buf

    out = {}
    for i, (path, leaf) in enumerate(flat):
        nw = -(-int(np.prod(leaf.shape)) // LANE)
        r0, r1 = spans[i]
        out[path] = PackedTernary(
            pos=pos[r0:r1].reshape(-1)[:nw], neg=neg[r0:r1].reshape(-1)[:nw],
            scale=scales[i if cfg.per_tensor else 0],
            shape=tuple(leaf.shape), orig_dtype=leaf.dtype)
    packed = tree_util.unflatten_paths(out)
    return (packed, stats) if return_stats else packed
