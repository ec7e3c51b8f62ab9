"""Adafactor with a factored second moment (port of
``repro/optim/adafactor.py``): optimizer state ~ O(n/d) instead of
O(2n).

Functional ``init`` / ``update`` over nested dicts of tensors with the
reference's state layout (``slots`` of ``vr``/``vc`` or ``v``, and
``count``) and its formulas in its order of operations.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree as tree_util

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    decay: float = 0.8          # beta2_t = 1 - step^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_dim_factored: int = 128


def _factored(shape) -> bool:
    return len(shape) >= 2 and min(shape[-2:]) >= 2


def init(params: PyTree, cfg: AdafactorConfig) -> PyTree:
    def leaf(p):
        z = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}
    dev = tree_util.leaves(params)[0].device
    return {"slots": tree_util.tree_map(leaf, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _means(shards, spec):
    """(mean over one dim, mean over the whole leaf) of this rank's block
    of a leaf placed by ``spec``: a dim cut over the mesh sums each
    block's partial in rank order (:class:`repro_torch.train.within_pod.
    Shards`) and divides by the logical length; an uncut dim, or no
    mesh, takes ``torch.mean``."""
    def mean_dim(x, dim, entry, keepdim=False):
        n = 1 if shards is None else shards.blocks(entry)
        if n == 1:
            return torch.mean(x, dim=dim, keepdim=keepdim)
        part = torch.sum(x, dim=dim, keepdim=keepdim)
        return shards.total(part, (entry,)) / (x.shape[dim] * n)

    def mean_all(x):
        if shards is None:
            return torch.mean(x)
        n = 1
        for entry in spec:
            n *= shards.blocks(entry)
        if n == 1:
            return torch.mean(x)
        return shards.total(torch.sum(x), spec) / (x.numel() * n)
    return mean_dim, mean_all


@torch.no_grad()
def update(grads: PyTree, state: PyTree, params: PyTree, lr: torch.Tensor,
           cfg: AdafactorConfig, shards=None, specs=None):
    """-> (new_params, new_state, metrics).  ``shards``/``specs``: the
    leaves are this rank's blocks of a training mesh; the factored means
    and the update's RMS then reduce across the blocks in rank order
    (:func:`_means`)."""
    f32 = torch.float32
    count = state["count"] + 1
    beta2 = 1.0 - torch.pow(count.to(f32), -cfg.decay)

    def upd(g, slot, p, spec):
        mean_dim, mean_all = _means(shards, spec)
        g32 = g.to(f32)
        g2 = g32 * g32 + cfg.eps
        if "vr" in slot:
            vr = beta2 * slot["vr"] + (1 - beta2) * mean_dim(g2, -1,
                                                             spec[-1])
            vc = beta2 * slot["vc"] + (1 - beta2) * mean_dim(g2, -2,
                                                             spec[-2])
            denom = torch.clamp_min(mean_dim(vr, -1, spec[-2], keepdim=True),
                                    cfg.eps)
            v_hat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
            new_slot = {"vr": vr, "vc": vc}
        else:
            v_hat = beta2 * slot["v"] + (1 - beta2) * g2
            new_slot = {"v": v_hat}
        u = g32 / torch.sqrt(v_hat + cfg.eps)
        rms_u = torch.sqrt(mean_all(u * u) + 1e-30)
        u = u / torch.clamp_min(rms_u / cfg.clip_threshold, 1.0)
        newp = p.to(f32) - lr * u
        if cfg.weight_decay and p.ndim >= 2:
            newp = newp - lr * cfg.weight_decay * p.to(f32)
        return newp.to(p.dtype), new_slot

    if specs is None:
        specs = tree_util.tree_map(lambda g: (None,) * g.dim(), grads)
    out = tree_util.tree_map(upd, grads, state["slots"], params, specs)
    new_params = tree_util.tree_map(lambda o: o[0], out)
    new_slots = tree_util.tree_map(lambda o: o[1], out)
    return new_params, {"slots": new_slots, "count": count}, {}
