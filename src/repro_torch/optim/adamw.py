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
_CHUNK = 1 << 24        # elements of a leaf updated at a time


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


def global_norm(tree: PyTree, shards=None, specs=None) -> torch.Tensor:
    """The l2 norm over every leaf.  With ``shards`` (a training mesh's
    :class:`repro_torch.train.within_pod.Shards`) each leaf of ``tree`` is
    this rank's block under its placement in ``specs``: each block's sum
    of squares is summed in rank order over the ranks holding the leaf's
    other blocks, then the leaves in order."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_util.leaves(tree)]
    if shards is not None:
        sq = shards.totals(sq, tree_util.leaves(specs))
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return torch.sqrt(total)


@torch.no_grad()
def update(grads: PyTree, state: PyTree, params: PyTree, lr: torch.Tensor,
           cfg: AdamWConfig, shards=None, specs=None):
    """-> (new_params, new_state, metrics).  ``shards``/``specs``: the
    leaves are this rank's blocks of a training mesh (the update is
    elementwise but for the global norm, see :func:`global_norm`)."""
    f32 = torch.float32
    gnorm = global_norm(grads, shards, specs)
    scale = torch.clamp_max(cfg.grad_clip_norm / (gnorm + 1e-9), 1.0)
    count = state["count"] + 1
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=f32, device=count.device),
                         count.to(f32))
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=f32, device=count.device),
                         count.to(f32))

    def part(g, m, v, p, decay: bool):
        g = g.to(f32) * scale
        m32 = m.to(f32) * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.to(f32) * cfg.b2 + (1 - cfg.b2) * g * g
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
        p32 = p.to(f32)
        if decay:
            step = step + cfg.weight_decay * p32
        newp = p32 - lr * step
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    def upd(g, m, v, p):
        # elementwise, so a large leaf is updated _CHUNK elements at a
        # time into its outputs (the f32 temporaries of a whole
        # embedding would otherwise coexist)
        if p.numel() <= _CHUNK:
            return part(g, m, v, p, p.ndim >= 2)
        flat = [t.reshape(-1) for t in (g, m, v, p)]
        outs = [torch.empty(p.numel(), dtype=t.dtype, device=t.device)
                for t in (p, m, v)]
        for i in range(0, p.numel(), _CHUNK):
            j = slice(i, i + _CHUNK)
            for o, r in zip(outs, part(*(t[j] for t in flat),
                                       p.ndim >= 2)):
                o[j] = r
        return tuple(o.reshape(p.shape) for o in outs)

    out = tree_util.tree_map(upd, grads, state["mu"], state["nu"], params)
    new = [tree_util.tree_map(lambda o, i=i: o[i], out) for i in range(3)]
    return new[0], {"mu": new[1], "nu": new[2], "count": count}, \
        {"grad_norm": gnorm}
