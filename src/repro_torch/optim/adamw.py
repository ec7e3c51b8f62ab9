"""AdamW with a configurable moment dtype and decoupled weight decay
(port of ``repro/optim/adamw.py``).

Functional ``init`` / ``update`` over nested dicts of tensors, with the
reference's state layout (``mu``, ``nu``, ``count``) and its formulas in
its order of operations, so a state crosses between the packages through
a checkpoint.  ``torch.optim`` is not used: its order of operations
differs, and its state is keyed by parameter objects.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree as tree_util
from repro_torch.models.common import _DTYPES

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"   # "bfloat16" halves optimizer memory
    grad_clip_norm: float = 1.0


def init(params: PyTree, cfg: AdamWConfig) -> PyTree:
    mdt = _DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt,  # noqa: E731
                                  device=p.device)
    dev = tree_util.leaves(params)[0].device
    return {"mu": tree_util.tree_map(zeros, params),
            "nu": tree_util.tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: PyTree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_util.leaves(tree)]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return torch.sqrt(total)


@torch.no_grad()
def update(grads: PyTree, state: PyTree, params: PyTree, lr: torch.Tensor,
           cfg: AdamWConfig):
    """-> (new_params, new_state, metrics)."""
    f32 = torch.float32
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip_norm / (gnorm + 1e-9), 1.0)
    count = state["count"] + 1
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=f32, device=count.device),
                         count.to(f32))
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=f32, device=count.device),
                         count.to(f32))

    def upd(g, m, v, p):
        g = g.to(f32) * scale
        m32 = m.to(f32) * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.to(f32) * cfg.b2 + (1 - cfg.b2) * g * g
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        p32 = p.to(f32)
        if p.ndim >= 2:
            step = step + cfg.weight_decay * p32
        newp = p32 - lr * step
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_util.tree_map(upd, grads, state["mu"], state["nu"], params)
    new = [tree_util.tree_map(lambda o, i=i: o[i], out) for i in range(3)]
    return new[0], {"mu": new[1], "nu": new[2], "count": count}, \
        {"grad_norm": gnorm}
