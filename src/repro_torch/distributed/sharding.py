"""Serving placement rules: which dim of each leaf a serving mesh shards.

Port of the serve rules of ``repro/distributed/sharding.py`` (mesh axes
("expert", "model")).  A placement here is the tuple a JAX
``PartitionSpec`` would hold, one entry per dim: an axis name for the
one dim that is cut along that axis, ``None`` elsewhere.  The port is
SPMD by process, so a rule's use is :func:`local_shard`, which cuts a
rank's contiguous block of that dim out of a logical tensor; nothing
places a logical array and lets a partitioner insert collectives.

The engine's contract is that a mesh gives the single-device engine's
tokens, which rules out any placement that shards a contraction dim
(partial sums reorder the f32 accumulation).  These rules shard only dims
where every output element is still computed by exactly one rank:

* embed / lm_head: vocab-parallel along "model" (the logits gather this
  induces is the one all-gather of the head),
* the expert slots [E, ...]: expert-parallel along "expert" (each row
  contracts against exactly one expert's planes; pad slots carry zero
  scales, so the sum over shards adds only exact zeros),
* KV caches: batch rows along "model" (rows are independent end to end),
  paged block pools along the block dim (pure gather and scatter).  A
  wave's rows are cut where its batch divides (:func:`serve_row_shards`);
  each rank's pool serves the rows it runs.

The training rules (``param_pspec`` and the rules built on it) and
``serve_cache_shardings`` come with the within-pod training mesh: the
latter replicates a cache's row vectors, which the port cuts with the
rows.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.launch.mesh import mesh_axes

PyTree = Any
Spec = tuple   # one axis name or None per dim


def serve_mesh_axes(mesh) -> tuple[int, int]:
    """(n_expert_shards, n_model_shards) of a serving mesh."""
    axes = mesh_axes(mesh)
    return axes.get("expert", 1), axes.get("model", 1)


def serve_param_pspec(path: str, shape: tuple, mesh) -> Spec:
    """Placement of one base parameter: ``embed`` rows and ``lm_head`` /
    ``unembed`` columns along "model" when the vocab divides, every other
    leaf replicated."""
    n_model = mesh_axes(mesh).get("model", 1)
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "embed" and len(shape) >= 2 and shape[0] % n_model == 0:
        return ("model",) + (None,) * (len(shape) - 1)
    if (leaf in ("lm_head", "unembed") and len(shape) >= 2
            and shape[-1] % n_model == 0):
        return (None,) * (len(shape) - 1) + ("model",)
    return (None,) * len(shape)


def serve_param_shardings(params: PyTree, mesh) -> PyTree:
    """:func:`serve_param_pspec` for every leaf of a parameter tree."""
    flat = {p: serve_param_pspec(p, tuple(leaf.shape), mesh)
            for p, leaf in tree_util.flatten_with_paths(params)}
    return tree_util.unflatten_paths(flat)


def serve_stack_shardings(mesh) -> tuple[Spec, Spec]:
    """(plane placement, scale placement) of one stacked slot entry:
    planes ``[E, W]`` and scales ``[E]`` both cut along "expert" on
    dim 0."""
    return ("expert",), ("expert",)


def serve_kv_sharding(mesh, shape: tuple, *, layout: str = "dense") -> Spec:
    """Placement of one 5-D KV buffer.

    dense  [U, B,  S,  Hkv, D]: batch rows along "model";
    paged  [U, NB, BS, Hkv, D]: the block pool along "model".
    A dim that does not divide stays replicated."""
    n_model = mesh_axes(mesh).get("model", 1)
    if len(shape) == 5 and shape[1] % n_model == 0:
        return (None, "model", None, None, None)
    return (None,) * len(shape)


def serve_row_shards(mesh, batch: int) -> int:
    """How many "model" shards the rows of a ``batch``-row wave are cut
    into: the "model" axis where :func:`serve_kv_sharding` cuts the dense
    KV's batch dim, else 1 (every rank runs every row, as the reference
    replicates a batch that does not divide).  The engine's dense KV, its
    paged block pools and the decode step's rows all follow it."""
    if serve_kv_sharding(mesh, (0, batch, 0, 0, 0))[1] is None:
        return 1
    return mesh_axes(mesh).get("model", 1)


def local_shard(t: torch.Tensor, spec: Spec, mesh,
                index: Optional[dict] = None) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: along the one dim named
    by an axis, the contiguous block of that axis's rank (``index`` gives
    {axis: rank} explicitly), copied; ``t`` itself when replicated."""
    axes = mesh_axes(mesh)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = axes[axis]
        if n == 1:
            return t
        i = index[axis] if index is not None else mesh.get_local_rank(axis)
        size = t.shape[dim] // n
        return t.narrow(dim, i * size, size).contiguous()
    return t


def shard_params(params: PyTree, mesh,
                 index: Optional[dict] = None) -> PyTree:
    """A rank's shard of a logical parameter tree by the serve rules (a
    replicated leaf is the caller's tensor itself, not a copy)."""
    return tree_util.tree_map(
        lambda leaf, spec: local_shard(leaf, spec, mesh, index), params,
        serve_param_shardings(params, mesh))
