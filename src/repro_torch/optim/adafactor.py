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


@torch.no_grad()
def update(grads: PyTree, state: PyTree, params: PyTree, lr: torch.Tensor,
           cfg: AdafactorConfig):
    """-> (new_params, new_state, metrics)."""
    f32 = torch.float32
    count = state["count"] + 1
    beta2 = 1.0 - torch.pow(count.to(f32), -cfg.decay)

    def upd(g, slot, p):
        g32 = g.to(f32)
        g2 = g32 * g32 + cfg.eps
        if "vr" in slot:
            vr = beta2 * slot["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * slot["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
            denom = torch.clamp_min(torch.mean(vr, dim=-1, keepdim=True),
                                    cfg.eps)
            v_hat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
            new_slot = {"vr": vr, "vc": vc}
        else:
            v_hat = beta2 * slot["v"] + (1 - beta2) * g2
            new_slot = {"v": v_hat}
        u = g32 / torch.sqrt(v_hat + cfg.eps)
        rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
        u = u / torch.clamp_min(rms_u / cfg.clip_threshold, 1.0)
        newp = p.to(f32) - lr * u
        if cfg.weight_decay and p.ndim >= 2:
            newp = newp - lr * cfg.weight_decay * p.to(f32)
        return newp.to(p.dtype), new_slot

    out = tree_util.tree_map(upd, grads, state["slots"], params)
    new_params = tree_util.tree_map(lambda o: o[0], out)
    new_slots = tree_util.tree_map(lambda o: o[1], out)
    return new_params, {"slots": new_slots, "count": count}, {}
