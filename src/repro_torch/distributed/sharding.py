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

The training rules (mesh axes ("pod", "data", "model")) follow the serve
rules: ``param_pspec`` and the rules built on it (``param_shardings``,
``train_state_shardings``, ``batch_shardings``, ``decode_layout``,
``cache_pspec``, ``cache_shardings``, and ``cache_placement``, the
placements a serving rank holds).  "pod" is pure data parallelism
(parameters replicated), "data" is FSDP (a non-contraction dim of each
weight, and the batch), "model" is tensor, expert or sequence
parallelism.  A placement entry may name a tuple of axes (the batch over
("pod", "data"), a cache's sequence over every axis): the dim is then cut
into the product of their sizes, row-major.  ``heads_shardable`` is the
one piece of the reference's ``make_shard_fn`` with a counterpart here:
the rest of it places activations for a partitioner, which an
SPMD-by-process port does not have.  The rules read only axis sizes, so
they take a device mesh or anything :func:`mesh_axes` accepts.
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


def _axes_of(entry) -> tuple:
    """The axes a placement entry names: () for None, (a,) for one axis,
    the tuple itself for several."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _block_index(axes: tuple, sizes: dict, index: dict) -> tuple[int, int]:
    """(block, number of blocks) of a dim cut over ``axes``, row-major."""
    i, n = 0, 1
    for a in axes:
        i, n = i * sizes[a] + index[a], n * sizes[a]
    return i, n


def local_shard(t: torch.Tensor, spec: Spec, mesh,
                index: Optional[dict] = None) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: along each dim that
    names an axis (or a tuple of axes, cut row-major), the contiguous
    block of the rank's coordinates (``index`` gives {axis: rank}
    explicitly), copied; ``t`` itself when nothing is cut.  A dim that
    does not divide raises."""
    sizes = mesh_axes(mesh)
    out = t
    for dim, entry in enumerate(spec):
        axes = tuple(a for a in _axes_of(entry) if sizes.get(a, 1) > 1)
        if not axes:
            continue
        coords = {a: (index[a] if index is not None
                      else mesh.get_local_rank(a)) for a in axes}
        i, n = _block_index(axes, sizes, coords)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                             f"over {axes} ({n} blocks)")
        size = t.shape[dim] // n
        out = out.narrow(dim, i * size, size)
    return t if out is t else out.contiguous()


def assemble(blocks: dict, spec: Spec, sizes: dict) -> torch.Tensor:
    """The inverse of :func:`local_shard`: the logical tensor from every
    rank's block, ``blocks`` keyed by coordinate tuples over the axes of
    ``sizes`` (in its order).  Replicated dims take rank 0's block."""
    names = tuple(sizes)
    key0 = tuple(0 for _ in names)
    shape = list(blocks[key0].shape)
    cut = {}
    for dim, entry in enumerate(spec):
        axes = tuple(a for a in _axes_of(entry) if sizes.get(a, 1) > 1)
        if axes:
            cut[dim] = axes
            shape[dim] *= _block_index(axes, sizes, {a: 0 for a in axes})[1]
    out = blocks[key0].new_empty(shape)
    used = {a for axes in cut.values() for a in axes}
    for key, b in blocks.items():
        coords = dict(zip(names, key))
        if any(coords[a] for a in names if a not in used):
            continue
        view = out
        for dim, axes in cut.items():
            i, _ = _block_index(axes, sizes, coords)
            view = view.narrow(dim, i * b.shape[dim], b.shape[dim])
        view.copy_(b)
    return out


def shard_tree(tree: PyTree, specs: PyTree, mesh,
               index: Optional[dict] = None) -> PyTree:
    """A rank's block of every leaf of ``tree`` under the matching
    placements of ``specs`` (a tree of the same paths), e.g. a whole
    train state under :func:`train_state_shardings`."""
    flat = dict(tree_util.flatten_with_paths(specs))
    return tree_util.unflatten_paths({
        p: local_shard(leaf, flat[p], mesh, index)
        for p, leaf in tree_util.flatten_with_paths(tree)})


def shard_params(params: PyTree, mesh,
                 index: Optional[dict] = None) -> PyTree:
    """A rank's shard of a logical parameter tree by the serve rules (a
    replicated leaf is the caller's tensor itself, not a copy)."""
    return tree_util.tree_map(
        lambda leaf, spec: local_shard(leaf, spec, mesh, index), params,
        serve_param_shardings(params, mesh))


# ---------------------------------------------------------------------------
# Serving: a whole decode cache
# ---------------------------------------------------------------------------


def serve_cache_shardings(cache: PyTree, mesh, *,
                          layout: str = "dense") -> PyTree:
    """Placements of a whole decode cache on the serving mesh, the
    reference's rule: each 5-D KV buffer by :func:`serve_kv_sharding`,
    every other leaf (lens, starts, tables, flags) replicated."""
    return tree_util.tree_map(
        lambda leaf: (serve_kv_sharding(mesh, tuple(leaf.shape),
                                        layout=layout) if leaf.dim() == 5
                      else (None,) * leaf.dim()), cache)


# ---------------------------------------------------------------------------
# Training: ("pod", "data", "model")
# ---------------------------------------------------------------------------


def _entry(axes):
    """A placement entry as a ``PartitionSpec`` normalises it: None for
    no axis, the name for one, the tuple for several."""
    if axes is None:
        return None
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _last(path: str) -> str:
    return path.split("/")[-1]


def batch_axes(mesh) -> tuple:
    """The axes the batch dim is cut over: ("pod", "data"), or ("data",)
    on a mesh without pods."""
    return ("pod", "data") if "pod" in mesh_axes(mesh) else ("data",)


def param_pspec(path: str, shape: tuple, cfg, mesh) -> Spec:
    """Placement of one parameter (the reference's rules, branch for
    branch).  FSDP ("data") sits on a non-contraction dim; "model" cuts
    heads, d_ff, experts, mamba's d_inner or the vocab where the
    configuration allows (``cfg.sharding``)."""
    name = _last(path)
    head_tp = cfg.sharding.head_tp
    ep = cfg.sharding.expert_parallel
    n_model = mesh_axes(mesh).get("model", 1)
    stacked = path.startswith(("blocks", "enc_blocks"))

    def S(*spec):      # the unit axis in front of a stacked weight
        return ((None,) + spec) if stacked else spec

    if name == "embed":
        # vocab-parallel only; an odd vocab stays replicated
        return ("model", None) if shape[0] % n_model == 0 else (None, None)
    if name == "lm_head":
        return ("data", "model") if shape[1] % n_model == 0 \
            else ("data", None)
    if name == "frontend_proj":
        return (None, "data")

    # attention: FSDP on the output dims, heads over "model"
    if name in ("wq", "wo") and len(shape) - stacked == 3:
        hq = shape[1] if stacked else shape[0]
        if name == "wq":
            hq = shape[2] if stacked else shape[1]
        if head_tp and hq % n_model == 0:
            return S("data", "model", None) if name == "wq" \
                else S("model", None, "data")
        return S(None, None, "data")
    if name in ("wk", "wv") and len(shape) - stacked == 3:
        hkv = shape[2] if stacked else shape[1]
        if head_tp and hkv % n_model == 0:
            return S("data", "model", None)
        return S(None, None, "data")
    if name in ("bq", "bk", "bv"):
        h = shape[1] if stacked else shape[0]
        if head_tp and h % n_model == 0:
            return S("model", None)
        return S(None, None)

    # dense / shared-expert FFN
    if name in ("wg", "wu", "wg_s", "wu_s", "cm_Wk"):
        return S("data", "model")
    if name in ("wo", "wo_s", "cm_Wv"):
        return S("model", "data")

    # MoE experts
    if name == "router":
        return S("data", None)
    if name in ("wg_e", "wu_e"):
        E = shape[1] if stacked else shape[0]
        if ep and E % n_model == 0:
            return S("model", "data", None)
        return S(None, "data", "model")
    if name == "wo_e":
        E = shape[1] if stacked else shape[0]
        if ep and E % n_model == 0:
            return S("model", None, "data")
        return S(None, "model", "data")

    # mamba (d_inner over "model")
    if name == "in_proj":
        return S("data", "model")
    if name == "conv_w":
        return S(None, "model")
    if name in ("conv_b", "dt_bias", "D_skip"):
        return S("model")
    if name in ("x_proj", "A_log"):
        return S("model", None)
    if name == "dt_proj":
        return S(None, "model")
    if name == "out_proj":
        return S("model", "data")

    # rwkv time mix (FSDP on the output dims)
    if name in ("Wr", "Wk", "Wv", "Wg", "cm_Wr", "Wo", "mix_w1", "decay_w1",
                "decay_w2"):
        return S(None, "data")
    if name == "mix_w2":
        return S(None, None, "data")

    # norms, scalars, small vectors
    return (None,) * len(shape)


def heads_shardable(cfg, mesh, n_heads: int) -> bool:
    """Whether ``n_heads`` attention heads are cut over "model": the
    configuration allows head parallelism and the count divides (the
    reference's ``make_shard_fn(...).heads_shardable``)."""
    return (cfg.sharding.head_tp
            and n_heads % mesh_axes(mesh).get("model", 1) == 0)


def param_shardings(params: PyTree, cfg, mesh) -> PyTree:
    """:func:`param_pspec` for every leaf of a parameter tree (tensors or
    anything with a ``shape``, e.g. meta tensors)."""
    return tree_util.unflatten_paths({
        p: param_pspec(p, tuple(leaf.shape), cfg, mesh)
        for p, leaf in tree_util.flatten_with_paths(params)})


def train_state_shardings(state: PyTree, cfg, mesh) -> PyTree:
    """Placements of a whole train state: parameters, AdamW's ``mu`` and
    ``nu`` and the error feedback ``ef`` as their parameters; Adafactor's
    factored slots as the parameter minus the reduced dim (``vr`` drops
    the last, ``vc`` the second to last) and ``v`` as the parameter;
    ``step`` and ``count`` replicated."""
    def f(path: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        parts = path.split("/")
        top = parts[0]
        if top == "step" or parts[-1] == "count":
            return ()
        if top in ("params", "ef"):
            return param_pspec("/".join(parts[1:]), shape, cfg, mesh)
        if top == "opt":
            rest = parts[1:]
            if rest and rest[0] in ("mu", "nu"):
                return param_pspec("/".join(rest[1:]), shape, cfg, mesh)
            if rest and rest[0] == "slots":
                slot, ppath = rest[-1], "/".join(rest[1:-1])
                if slot == "v":
                    return param_pspec(ppath, shape, cfg, mesh)
                if slot == "vr":
                    return param_pspec(ppath, shape + (1,), cfg, mesh)[:-1]
                if slot == "vc":
                    sp = param_pspec(ppath, shape[:-1] + (1, shape[-1]),
                                     cfg, mesh)
                    return sp[:-2] + (sp[-1],)
        return (None,) * len(shape)

    return tree_util.unflatten_paths({
        p: f(p, leaf) for p, leaf in tree_util.flatten_with_paths(state)})


def batch_shardings(batch: PyTree, mesh) -> PyTree:
    """Every batch leaf cut on dim 0 over :func:`batch_axes`."""
    b = _entry(batch_axes(mesh))
    return tree_util.tree_map(lambda x: (b,) + (None,) * (x.dim() - 1),
                              batch)


def replicated(mesh) -> Spec:
    """The placement of a replicated value (``P()``)."""
    return ()


def decode_layout(mesh, global_batch: int) -> tuple:
    """(batch axes or None, sequence axes) of a decode cache: the batch
    over the data axes and the sequence over "model" where the batch
    divides; else the batch whole and the sequence over every axis
    (flash decoding across all ranks, the long-context layout)."""
    axes = mesh_axes(mesh)
    baxes = batch_axes(mesh)
    dp = 1
    for a in baxes:
        dp *= axes[a]
    if global_batch % dp == 0:
        return baxes, ("model",)
    return None, tuple(axes)


def cache_pspec(path: str, shape: tuple, mesh, global_batch: int,
                seq_shard: bool = True) -> Spec:
    """Placement of one decode-cache leaf: KV [U, B, S, Hkv, D] with the
    batch and the sequence as :func:`decode_layout` says, ``pos`` [U, S]
    with the sequence; mamba's states with d_inner over "model" when the
    batch is whole, other recurrent states over the batch."""
    name = _last(path)
    baxes, seq_axes = decode_layout(mesh, global_batch)
    b, sq = _entry(baxes), _entry(seq_axes)
    if name in ("k", "v") and len(shape) == 5:
        return (None, b, sq if seq_shard else None, None, None)
    if name == "pos" and len(shape) == 2:
        return (None, sq if seq_shard else None)
    if name in ("h", "conv"):
        if baxes is None:
            if name == "conv":
                return (None, None) + (None,) * (len(shape) - 3) + ("model",)
            return (None, None, "model", None)
        return (None, b) + (None,) * (len(shape) - 2)
    if name in ("S", "tm", "cm") or len(shape) >= 2:
        if baxes is None:
            return (None,) * len(shape)
        return (None, b) + (None,) * (len(shape) - 2)
    return (None,) * len(shape)


def cache_shardings(cache: PyTree, mesh, global_batch: int,
                    seq_shard: bool = True) -> PyTree:
    """:func:`cache_pspec` for every leaf of a decode cache."""
    return tree_util.unflatten_paths({
        p: cache_pspec(p, tuple(leaf.shape), mesh, global_batch, seq_shard)
        for p, leaf in tree_util.flatten_with_paths(cache)})


def cache_placement(cache: PyTree, mesh, global_batch: int) -> PyTree:
    """:func:`cache_shardings` with every dim that does not divide over
    its axes kept whole: the port's convention for a ring or an encoder
    length that does not divide over the sequence shards (it runs local
    attention, as the reference's sequence-parallel decode falls back
    to).  These are the placements a serving rank holds."""
    sizes = mesh_axes(mesh)

    def fit(spec, shape):
        out = []
        for d, entry in zip(shape, spec):
            n = 1
            for a in _axes_of(entry):
                n *= sizes.get(a, 1)
            out.append(entry if d % n == 0 else None)
        return tuple(out)

    return tree_util.unflatten_paths({
        p: fit(cache_pspec(p, tuple(leaf.shape), mesh, global_batch),
               tuple(leaf.shape))
        for p, leaf in tree_util.flatten_with_paths(cache)})
