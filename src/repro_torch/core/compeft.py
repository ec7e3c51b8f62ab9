"""ComPEFT (Algorithm 1): sparsify and ternary-quantize task vectors, in
PyTorch.  Port of ``repro/core/compeft.py``:

  1. keep the signs of the top-``k`` fraction of entries by magnitude;
  2. replace every surviving magnitude by ``alpha * std(tau)``.

Two routes compute it.  The sort-based ``compress`` (one exact quantile
per leaf, int8 signs: the TERNARY form) is the numerics oracle; its
planes come from :func:`compress_packed_exact`, the same thresholds fed
to the ``pack_ternary_planes`` kernel.  The streaming
:func:`compress_packed` puts every leaf into one flat segment buffer, a
two-pass histogram finds each leaf's threshold and its std in O(n), and
one pack launch writes the sign planes of all leaves.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree as tree_util


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


@dataclasses.dataclass
class CompressedTensor:
    """One compressed leaf: int8 signs in {-1, 0, +1} in the leaf's shape,
    the f32 scalar ``alpha * sigma(tau)`` and the leaf's dtype."""

    signs: torch.Tensor
    scale: torch.Tensor
    orig_dtype: Any = torch.bfloat16

    @property
    def shape(self):
        return tuple(self.signs.shape)

    @property
    def density(self) -> torch.Tensor:
        return self.signs.abs().to(torch.float32).mean()

    def decompress(self) -> torch.Tensor:
        return (self.signs.to(torch.float32) * self.scale).to(self.orig_dtype)


def _is_ct(x) -> bool:
    return isinstance(x, CompressedTensor)


def _round_f32(x: Fraction) -> np.float32:
    """The f32 nearest to an exact rational (ties to even)."""
    c = np.float32(float(x))
    cands = (c, np.nextafter(c, np.float32(np.inf)),
             np.nextafter(c, np.float32(-np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(v.view(np.int32)) & 1))


def _topk_threshold(mag: torch.Tensor, density: float) -> torch.Tensor:
    """Magnitude cut-off such that ~density of the entries survive: the
    reference's ``jnp.quantile(mag, 1 - density)`` (linear method) as it
    runs on the CPU, to the bit.  Its index arithmetic is f32, so the
    index rounds the same way above 2**24 elements; its values come from
    a sorted copy; and its interpolation ``lo * (1 - w) + hi * w`` is
    compiled by XLA into ``fma(hi, w, round(lo * (1 - w)))``, which the
    host reproduces in exact rationals.  (``torch.quantile`` interpolates
    otherwise and refuses inputs above 2**24 elements.)"""
    flat = mag.reshape(-1).to(torch.float32)
    f32 = np.float32
    q = f32(min(max(1.0 - density, 0.0), 1.0))
    n = f32(flat.numel())
    q = f32(q * (n - f32(1)))
    low, high = np.floor(q), np.ceil(q)
    hw = f32(q - low)
    lw = f32(f32(1) - hw)
    # clamped in f32 as JAX does, then to the last element as its gather
    # clamps an index past the end (f32(n - 1) rounds up to n above 2**24)
    last = flat.numel() - 1
    lo = min(int(np.clip(low, f32(0), n - f32(1))), last)
    hi = min(int(np.clip(high, f32(0), n - f32(1))), last)
    vals = torch.sort(flat).values[[lo, hi]].tolist()
    v_lo, v_hi = f32(vals[0]), f32(vals[1])
    thr = _round_f32(Fraction(float(v_hi)) * Fraction(float(hw))
                     + Fraction(float(f32(v_lo * lw))))
    return torch.tensor(float(thr), dtype=torch.float32, device=flat.device)


def _scale_of(tau: torch.Tensor, mode: str) -> torch.Tensor:
    t = tau.to(torch.float32)
    if mode == "std":
        return torch.std(t, correction=0)          # jnp.std: ddof 0
    if mode == "mean_abs":
        return t.abs().mean()
    return torch.tensor(1.0, dtype=torch.float32, device=t.device)


def _threshold_and_scale(tau: torch.Tensor, cfg: CompressionConfig,
                         threshold=None, scale=None):
    """One leaf in f32, its keep threshold and its scale alpha * sigma
    (the threshold and sigma computed here unless given)."""
    t = tau.to(torch.float32)
    thr = _topk_threshold(t.abs(), cfg.density) if threshold is None \
        else threshold
    sigma = _scale_of(tau, cfg.scale_mode) if scale is None else scale
    return t, thr, torch.tensor(cfg.alpha, dtype=torch.float32,
                                device=t.device) * sigma


def compress_leaf(tau: torch.Tensor, cfg: CompressionConfig,
                  threshold: torch.Tensor | None = None,
                  scale: torch.Tensor | None = None) -> CompressedTensor:
    """Algorithm 1 on a single tensor."""
    t, thr, scale = _threshold_and_scale(tau, cfg, threshold, scale)
    signs = torch.where(t.abs() >= thr, torch.sign(t), 0.0).to(torch.int8)
    return CompressedTensor(signs=signs, scale=scale, orig_dtype=tau.dtype)


def _leaf_thresholds(leaves, cfg: CompressionConfig):
    """Per-leaf (threshold, sigma); with ``per_tensor=False`` one pair
    over the concatenated vector, shared by every leaf."""
    if cfg.per_tensor:
        return [(None, None)] * len(leaves)
    flat = torch.cat([l.reshape(-1).to(torch.float32) for l in leaves])
    pair = (_topk_threshold(flat.abs(), cfg.density),
            _scale_of(flat, cfg.scale_mode))
    return [pair] * len(leaves)


def compress(tau: dict, cfg: CompressionConfig | None = None) -> dict:
    """Algorithm 1 over a nested-dict task vector: a tree of
    :class:`CompressedTensor` with the structure of ``tau``."""
    cfg = cfg or CompressionConfig()
    flat = tree_util.flatten_with_paths(tau)
    pairs = _leaf_thresholds([l for _, l in flat], cfg)
    return tree_util.unflatten_like(tau, [
        compress_leaf(leaf, cfg, threshold=thr, scale=sigma)
        for (_, leaf), (thr, sigma) in zip(flat, pairs)])


def compress_packed_exact(tau: dict, cfg: CompressionConfig | None = None
                          ) -> dict:
    """The planes of :func:`compress` without its int8 signs: each leaf's
    exact threshold and scale, then the ``pack_ternary_planes`` kernel over
    the leaf's flat ``[1, n]`` view (the flat C-order packing of
    ``PackedTernary``).  Bitwise ``pack_tree(compress(tau, cfg))``."""
    from repro_torch.core.packing import PackedTernary
    from repro_torch.kernels import ops
    cfg = cfg or CompressionConfig()
    flat = tree_util.flatten_with_paths(tau)
    pairs = _leaf_thresholds([l for _, l in flat], cfg)
    out = {}
    for (path, leaf), (thr, sigma) in zip(flat, pairs):
        t, thr, scale = _threshold_and_scale(leaf, cfg, thr, sigma)
        pos, neg = ops.compress_to_planes(t.reshape(1, -1), thr)
        out[path] = PackedTernary(pos=pos.reshape(-1), neg=neg.reshape(-1),
                                  scale=scale, shape=tuple(leaf.shape),
                                  orig_dtype=leaf.dtype)
    return tree_util.unflatten_like(tau, list(out.values()))


def decompress(compressed: dict) -> dict:
    """Inverse map back to dense task-vector leaves."""
    return tree_util.tree_map(lambda c: c.decompress(), compressed,
                              is_leaf=_is_ct)


def apply_compressed(theta_init: dict, compressed: dict) -> dict:
    """Reconstruct expert parameters: ``theta = theta_init + tau_tilde``."""
    return tree_util.tree_map(
        lambda w, c: (w.to(torch.float32) + c.signs.to(torch.float32)
                      * c.scale).to(w.dtype),
        theta_init, compressed, is_leaf=_is_ct)


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
    from repro_torch.core.packing import LANE, PackedTernary
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
        # int64: a whole model can pass 2**31 elements (qwen1.5-110b's
        # unit holds 3.85 B)
        seg_count = seg_count.sum(dtype=torch.int64, dim=0, keepdim=True)
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
    packed = tree_util.unflatten_like(tau, list(out.values()))
    return (packed, stats) if return_stats else packed


# ---------------------------------------------------------------------------
# Alpha calibration (paper §2.1: "alpha is the only parameter tuned")
# ---------------------------------------------------------------------------

ALPHA_GRID = (0.5, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0)
DENSITY_GRID = (0.05, 0.1, 0.2, 0.3, 0.5)


def rescale(compressed: dict, old_alpha: float, new_alpha: float) -> dict:
    """Retarget a compressed tree to another alpha (scales only)."""
    r = new_alpha / old_alpha
    return tree_util.tree_map(
        lambda c: CompressedTensor(signs=c.signs, scale=c.scale * r,
                                   orig_dtype=c.orig_dtype),
        compressed, is_leaf=_is_ct)


def calibrate_alpha(tau: dict, eval_fn: Callable[[dict], float],
                    density: float, alpha_grid: tuple = ALPHA_GRID,
                    per_tensor: bool = True):
    """Grid-search alpha on a validation metric (higher is better).

    ``eval_fn`` maps a reconstructed dense task vector to a score; the
    signs are computed once and only the scale is swept.  Returns
    (best_alpha, best_score, best_compressed_tree)."""
    base = compress(tau, CompressionConfig(density=density, alpha=1.0,
                                           per_tensor=per_tensor))
    best = (None, -np.inf, None)
    for a in alpha_grid:
        cand = rescale(base, 1.0, a)
        score = float(eval_fn(decompress(cand)))
        if score > best[1]:
            best = (a, score, cand)
    return best


def compression_summary(tau: dict, compressed: dict) -> dict:
    """Diagnostics: density achieved, reconstruction error, bit
    accounting (the reference's keys)."""
    from repro_torch.core.packing import entropy_bits
    taus = tree_util.leaves(tau)
    comps = tree_util.leaves(compressed, is_leaf=_is_ct)
    n = sum(int(np.prod(t.shape)) for t in taus)
    nnz = sum(int(c.signs.abs().to(torch.int32).sum()) for c in comps)
    dense_bits = 16 * n
    ent_bits = sum(entropy_bits(int(np.prod(c.shape)), float(c.density))
                   for c in comps)
    bitplane_bits = sum(2 * int(np.prod(c.shape)) + 16 for c in comps)
    err = 0.0
    for t, c in zip(taus, comps):
        d = c.decompress().to(torch.float32) - t.to(torch.float32)
        err += float((d * d).sum())
    norm = sum(float((t.to(torch.float32) ** 2).sum()) for t in taus)
    return {
        "n_params": n,
        "nnz": nnz,
        "density": nnz / max(n, 1),
        "dense_bits": dense_bits,
        "entropy_bits": ent_bits,
        "bitplane_bits": bitplane_bits,
        "compression_x_entropy": dense_bits / max(ent_bits, 1e-9),
        "compression_x_bitplane": dense_bits / max(bitplane_bits, 1),
        "rel_recon_err": float(np.sqrt(err / max(norm, 1e-30))),
    }
