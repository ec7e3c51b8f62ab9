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
from repro_torch.core.compeft import _topk_threshold
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


def _pack_planes(signs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """{-1, 0, 1} values -> two int32 planes packed along the LAST axis
    only: [..., L] -> [..., ceil(L/32)].  Leading dims are untouched."""
    L = signs.shape[-1]
    pad = (-L) % LANE
    s = signs
    if pad:
        s = torch.cat([s, s.new_zeros(s.shape[:-1] + (pad,))], dim=-1)
    lanes = s.reshape(s.shape[:-1] + (-1, LANE))
    w = lane_weights(s.device)
    pos = words_to_int32(((lanes > 0).to(torch.int64) * w).sum(dim=-1))
    neg = words_to_int32(((lanes < 0).to(torch.int64) * w).sum(dim=-1))
    return pos, neg


def _unpack_planes(pos: torch.Tensor, neg: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Inverse of :func:`_pack_planes` -> f32 {-1, 0, 1} with last dim n."""
    shifts = lane_shifts(pos.device)
    pb = ((pos[..., None] >> shifts) & 1).to(torch.float32)
    nb = ((neg[..., None] >> shifts) & 1).to(torch.float32)
    out = (pb - nb).reshape(pos.shape[:-1] + (-1,))
    return out[..., :n]


def compress_leaf_for_allgather(g: torch.Tensor, err: torch.Tensor,
                                cfg: GradCompressionConfig):
    """-> (pos_planes, neg_planes, scale, new_err)."""
    g32 = g.to(torch.float32) + err
    thr = _threshold(g32, cfg)
    mask = torch.abs(g32) >= thr
    nnz = torch.clamp_min(torch.sum(mask.to(torch.float32)), 1.0)
    # STC scale: mean magnitude of survivors
    scale = torch.sum(torch.where(mask, torch.abs(g32), 0.0)) / nnz
    signs = torch.where(mask, torch.sign(g32), 0.0).to(torch.int8)
    recon = signs.to(torch.float32) * scale
    new_err = g32 - recon
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


def init_error_state(params: PyTree) -> PyTree:
    """Zero error-feedback accumulators (f32, same shapes as params)."""
    return tree_util.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def compression_ratio(cfg: GradCompressionConfig) -> float:
    """Wire bytes dense-f32 / compressed (ignoring the scalar)."""
    return 32.0 / 2.0 if cfg.enabled else 1.0
