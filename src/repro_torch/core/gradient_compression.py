"""ComPEFT-style ternary gradient compression for data parallelism across
pods (port of ``repro/core/gradient_compression.py``).

The same sparsify + ternarize + scale transform as Algorithm 1 compresses
a gradient exchange: each pod ternarizes its local mean gradient, packs
it into two bitplanes of 32-bit words (2 bits a parameter against 32) and
one f32 scale, all-gathers the packed planes, and decompresses and
averages locally.  Error feedback keeps the residual
``e_t = g_t - decompress(compress(g_t))`` and adds it to the next step's
gradient (EF-SGD; Karimireddy et al. 2019).

Planes are int32 words with the reference's uint32 bits (the CPU build of
torch cannot shift ``uint32``), packed along the last axis only.  The
threshold is a Gaussian-quantile approximation (``torch.special.erfinv``;
it may round an ulp away from JAX's) or, with ``exact_threshold``, the
reference's ``jnp.quantile`` to the bit.  The exchange runs over a
``torch.distributed`` process group where the reference runs inside
``shard_map``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree as tree_util
from repro_torch.core.compeft import (_interpolate, _quantile_points,
                                      _topk_threshold)
from repro_torch.core.packing import (LANE, lane_shifts, lane_weights,
                                      words_to_int32)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class GradCompressionConfig:
    density: float = 0.05          # fraction of entries kept per tensor
    enabled: bool = True
    exact_threshold: bool = False  # True: the quantile; False: Gaussian approx


def gaussian_topk_threshold(x: torch.Tensor, density: float) -> torch.Tensor:
    """|x| cut-off keeping ~density of entries assuming x ~ N(mu, sigma):
    t = sigma * sqrt(2) * erfinv(1 - k)."""
    f32 = dict(dtype=x.dtype, device=x.device)
    sigma = torch.std(x, correction=0) + 1e-12
    t = torch.sqrt(torch.tensor(2.0, **f32)) * torch.special.erfinv(
        torch.tensor(1.0 - density, **f32))
    return sigma * t


def _threshold(x: torch.Tensor, cfg: GradCompressionConfig) -> torch.Tensor:
    if cfg.exact_threshold:
        return _topk_threshold(torch.abs(x), cfg.density)
    return gaussian_topk_threshold(x, cfg.density)


_CHUNK_WORDS = 1 << 20       # words packed or unpacked at a time


def _pack_planes(signs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """{-1, 0, 1} values -> two int32 planes packed along the LAST axis
    only: [..., L] -> [..., ceil(L/32)].  Leading dims are untouched.
    Words are packed ``_CHUNK_WORDS`` at a time (an int64 lane a value
    would otherwise take 8 bytes per element of the leaf at once)."""
    L = signs.shape[-1]
    pad = (-L) % LANE
    s = signs
    if pad:
        s = torch.cat([s, s.new_zeros(s.shape[:-1] + (pad,))], dim=-1)
    lanes = s.reshape(-1, LANE)
    w = lane_weights(s.device)
    pos, neg = [], []
    for i in range(0, max(lanes.shape[0], 1), _CHUNK_WORDS):
        part = lanes[i:i + _CHUNK_WORDS]
        pos.append(words_to_int32(((part > 0).to(torch.int64) * w).sum(-1)))
        neg.append(words_to_int32(((part < 0).to(torch.int64) * w).sum(-1)))
    shape = s.shape[:-1] + (-1,)
    return torch.cat(pos).reshape(shape), torch.cat(neg).reshape(shape)


def _unpack_planes(pos: torch.Tensor, neg: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Inverse of :func:`_pack_planes` -> f32 {-1, 0, 1} with last dim n
    (``_CHUNK_WORDS`` words at a time)."""
    shifts = lane_shifts(pos.device)
    pw, nw = pos.reshape(-1), neg.reshape(-1)
    out = torch.empty((pw.numel(), LANE), dtype=torch.float32,
                      device=pos.device)
    for i in range(0, max(pw.numel(), 1), _CHUNK_WORDS):
        j = slice(i, i + _CHUNK_WORDS)
        pb = ((pw[j, None] >> shifts) & 1).to(torch.float32)
        nb = ((nw[j, None] >> shifts) & 1).to(torch.float32)
        out[j] = pb - nb
    return out.reshape(pos.shape[:-1] + (-1,))[..., :n]


def compress_leaf_for_allgather(g: torch.Tensor, err: torch.Tensor,
                                cfg: GradCompressionConfig):
    """-> (pos_planes, neg_planes, scale, new_err)."""
    g32 = g.to(torch.float32) + err
    thr = _threshold(g32, cfg)
    mag = torch.abs(g32)
    mask = mag >= thr
    nnz = torch.clamp_min(torch.sum(mask.to(torch.float32)), 1.0)
    # STC scale: mean magnitude of survivors
    scale = torch.sum(torch.where(mask, mag, 0.0)) / nnz
    del mag
    signs = torch.where(mask, torch.sign(g32), 0.0).to(torch.int8)
    new_err = g32 - signs.to(torch.float32) * scale
    pos, neg = _pack_planes(signs)
    return pos, neg, scale, new_err


def compressed_cross_pod_mean(grads: PyTree, errors: PyTree,
                              cfg: GradCompressionConfig,
                              group=None) -> tuple[PyTree, PyTree]:
    """EF-ternary all-reduce (mean) over the ranks of ``group`` (default:
    the world), each rank one pod.  Returns (mean_grads, new_errors).

    Per leaf, every rank all-gathers the others' packed planes and
    scales (2 * ceil(n/32) words and one f32) and sums their
    reconstructions in rank order, then divides by the number of ranks,
    as the reference does inside ``shard_map``."""
    import torch.distributed as dist
    n_pods = dist.get_world_size(group)

    def leaf(g, e):
        n_last = g.shape[-1] if g.ndim else 1
        g2 = g if g.ndim else g.reshape(1)
        e2 = e if e.ndim else e.reshape(1)
        pos, neg, scale, new_err = compress_leaf_for_allgather(g2, e2, cfg)
        new_err = new_err.to(e.dtype).reshape(e.shape)
        gathered = []
        for t in (pos.contiguous(), neg.contiguous(), scale.reshape(1)):
            parts = [torch.empty_like(t) for _ in range(n_pods)]
            dist.all_gather(parts, t, group=group)
            gathered.append(parts)
        pos_all, neg_all, scale_all = gathered
        acc = torch.zeros(g2.shape, dtype=torch.float32, device=g.device)
        for p in range(n_pods):
            acc = acc + _unpack_planes(pos_all[p], neg_all[p],
                                       n_last) * scale_all[p][0]
        mean = (acc / n_pods).reshape(g.shape).to(g.dtype)
        return mean, new_err

    out = tree_util.tree_map(leaf, grads, errors)
    return (tree_util.tree_map(lambda o: o[0], out),
            tree_util.tree_map(lambda o: o[1], out))


def _sharded_threshold(g32: torch.Tensor, cfg: GradCompressionConfig,
                       shards, spec, n: int) -> torch.Tensor:
    """:func:`_threshold` of the logical leaf, from this rank's block
    ``g32`` and the blocks of the ranks holding its other blocks."""
    if cfg.exact_threshold:
        # the two sorted positions the quantile reads lie among the union
        # of every block's largest n - lo magnitudes
        lo, hi, hw, lw = _quantile_points(n, cfg.density)
        top = min(n - lo, g32.numel())
        mine = torch.topk(torch.abs(g32).reshape(-1), top).values
        union = shards.gather(mine, spec).reshape(-1)
        desc = torch.sort(union, descending=True).values
        vals = desc[[n - 1 - lo, n - 1 - hi]].tolist()
        return _interpolate(vals[0], vals[1], hw, lw, g32.device)
    f32 = dict(dtype=torch.float32, device=g32.device)
    mean = shards.total(torch.sum(g32), spec) / n
    var = shards.total(torch.sum(torch.square(g32 - mean)), spec) / n
    sigma = torch.sqrt(var) + 1e-12
    t = torch.sqrt(torch.tensor(2.0, **f32)) * torch.special.erfinv(
        torch.tensor(1.0 - cfg.density, **f32))
    return sigma * t


def compress_block_for_allgather(g: torch.Tensor, err: torch.Tensor,
                                 cfg: GradCompressionConfig, shards, spec):
    """:func:`compress_leaf_for_allgather` of this rank's block of a leaf
    cut by ``spec`` over a training mesh: the threshold, the survivors'
    count and their magnitude sum are the logical leaf's, each block's
    partial summed in rank order (``shards``, a
    :class:`repro_torch.train.within_pod.Shards`); the signs, the planes
    and the error are the block's.  The Gaussian threshold takes the
    leaf's standard deviation as two passes of sums (the mean, then the
    squared deviations).  -> (pos_planes, neg_planes, scale, new_err)."""
    n = g.numel()
    for entry in spec:
        n *= shards.blocks(entry)
    if n == g.numel():
        return compress_leaf_for_allgather(g, err, cfg)
    g32 = g.to(torch.float32) + err
    thr = _sharded_threshold(g32, cfg, shards, spec, n)
    mask = torch.abs(g32) >= thr
    nnz = torch.clamp_min(shards.total(torch.sum(mask.to(torch.float32)),
                                       spec), 1.0)
    scale = shards.total(torch.sum(torch.where(mask, torch.abs(g32), 0.0)),
                         spec) / nnz
    signs = torch.where(mask, torch.sign(g32), 0.0).to(torch.int8)
    new_err = g32 - signs.to(torch.float32) * scale
    pos, neg = _pack_planes(signs)
    return pos, neg, scale, new_err


def compressed_cross_pod_mean_sharded(grads: PyTree, errors: PyTree,
                                      cfg: GradCompressionConfig, shards,
                                      specs: PyTree):
    """:func:`compressed_cross_pod_mean` on a ("pod", "data", "model")
    mesh: every rank compresses its block of each leaf with the logical
    leaf's threshold and scale (:func:`compress_block_for_allgather`)
    and gathers only that block's planes and scale across the pods,
    summing the reconstructions in pod order.  Returns (mean_grads,
    new_errors), this rank's blocks."""
    n_pods = shards.sizes.get("pod", 1)

    def leaf(g, e, spec):
        n_last = g.shape[-1] if g.ndim else 1
        g2 = g if g.ndim else g.reshape(1)
        e2 = e if e.ndim else e.reshape(1)
        spec2 = spec if g.ndim else (None,)
        pos, neg, scale, new_err = compress_block_for_allgather(
            g2, e2, cfg, shards, spec2)
        new_err = new_err.to(e.dtype).reshape(e.shape)
        planes = shards.comm.gather(torch.cat([pos.reshape(-1),
                                               neg.reshape(-1)]), ("pod",))
        scales = shards.comm.gather(scale.reshape(1), ("pod",))
        w = pos.numel()
        acc = torch.zeros(g2.shape, dtype=torch.float32, device=g.device)
        for p in range(n_pods):
            acc.add_(_unpack_planes(planes[p, :w].reshape(pos.shape),
                                    planes[p, w:].reshape(neg.shape),
                                    n_last) * scales[p][0])
        mean = acc.div_(n_pods).reshape(g.shape).to(g.dtype)
        return mean, new_err

    out = tree_util.tree_map(leaf, grads, errors, specs)
    return (tree_util.tree_map(lambda o: o[0], out),
            tree_util.tree_map(lambda o: o[1], out))


def init_error_state(params: PyTree) -> PyTree:
    """Zero error-feedback accumulators (f32, same shapes as params)."""
    return tree_util.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def compression_ratio(cfg: GradCompressionConfig) -> float:
    """Wire bytes dense-f32 / compressed (ignoring the scalar)."""
    return 32.0 / 2.0 if cfg.enabled else 1.0
