"""The train step inside a pod: a ("pod", "data", "model") mesh under the
reference's training rules (``repro/distributed/sharding.py``).

The reference places a logical train state by ``train_state_shardings``
and lets GSPMD partition its step.  The port is SPMD by process: every
rank holds only its block of each parameter, optimizer slot and
error-feedback leaf (:func:`repro_torch.distributed.sharding.
train_state_shardings`, cut by :func:`shard_train_state`) and its rows of
the global batch (``batch_shardings``: dim 0 over ("pod", "data")), and
the collectives are written out:

* **"data" is FSDP.**  Each unit's leaves are all-gathered along their
  "data" dim before the unit runs, inside a checkpoint, so they are
  dropped after its forward and gathered again for its backward
  (:class:`_Gather`).  A gradient comes back to the rank's block summed
  over the data ranks in rank order and divided by their number (a
  reduce-scatter: each rank receives the other ranks' copies of its
  block only): the mean over the global batch when every rank's rows
  hold as many targets.
* **"model" is tensor parallelism** for the attention-only dense family
  (:func:`tensor_parallel_family`): heads are cut where
  ``heads_shardable`` holds and the FFN on d_ff, as ``param_pspec``
  places them; one sum over "model" follows the attention's ``wo`` and
  one the FFN's down projection (Megatron's f and g operators,
  :class:`TensorParallel`); the embedding is the vocab-parallel lookup
  with a vocab-parallel head and cross-entropy (:class:`_VocabCE`).  A
  leaf used inside a cut region but not cut itself (q/k norms, K/V
  projections whose heads do not divide) gets its gradient summed over
  "model".  Every other family gathers each leaf whole over both axes:
  the same arithmetic as one rank, on the rank's rows.
* **Statistics across blocks** (AdamW's global norm, Adafactor's
  factored moments, the compression's threshold and scale) sum each
  block's partial in rank order over the ranks holding the leaf's other
  blocks (:class:`Shards`).
* **Pods** exchange each rank's block compressed with the logical leaf's
  threshold and scale
  (:func:`repro_torch.core.gradient_compression.
  compressed_cross_pod_mean_sharded`).

Every sum across ranks exchanges the parts (an all-gather, or an
``all_to_all`` for the gradients' data sum and the tensor-parallel sums)
and adds them in rank order,
so the result does not depend on a backend's reduction order, and
:func:`within_pod_in_one_process` reproduces a mesh without a "model"
axis bit for bit in one process: each rank's gradients on its rows with
the logical parameters, the same rank-order means, then every rank's
update in a thread of its own whose collectives are exchanges between
the threads (:class:`ThreadComm`).
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from repro_torch import tree as tree_util
from repro_torch.distributed.collectives import (all_gather_dim0,
                                                 all_reduce_ordered,
                                                 gather_axes,
                                                 make_vp_embed_lookup,
                                                 ordered_sum,
                                                 reduce_scatter_ordered)
from repro_torch.distributed.sharding import (_axes_of, assemble,
                                              batch_axes, batch_shardings,
                                              local_shard, param_shardings,
                                              train_state_shardings)
from repro_torch.launch.mesh import TRAIN_AXES, mesh_axes

PyTree = Any


def tensor_parallel_family(cfg) -> bool:
    """Whether "model" runs tensor parallelism for ``cfg``: a decoder-only
    model of attention blocks with dense FFNs (qwen2.5, llama, gemma2,
    qwen3, qwen1.5).  MoE, mamba, rwkv, enc-dec and frontend models
    gather their leaves whole instead."""
    return (cfg.enc_n_units == 0 and not cfg.cross_attn
            and cfg.frontend is None
            and all(b.kind == "attn" and (b.ffn is None or b.ffn.moe is None)
                    for b in cfg.pattern))


class AxisSizes:
    """A mesh's axis sizes without process groups (for the rules and the
    one-process oracle): ``mesh_axes`` reads ``shape``."""

    def __init__(self, sizes: dict):
        self.shape = dict(sizes)


def _cut_axes(sizes: dict, spec) -> tuple:
    """The axes of size above 1 that ``spec`` cuts, in mesh order."""
    named = {a for entry in spec for a in _axes_of(entry)}
    return tuple(a for a in sizes if a in named and sizes[a] > 1)


# ---------------------------------------------------------------------------
# Collectives: a mesh's, or threads' in one process
# ---------------------------------------------------------------------------


class MeshComm:
    """The gathers of one rank of a training mesh."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = mesh_axes(mesh)
        self.coords = {a: mesh.get_local_rank(a) for a in self.sizes}

    def gather(self, t: torch.Tensor, axes: tuple) -> torch.Tensor:
        """[n, *t.shape]: ``t`` of the ranks differing along ``axes``."""
        return gather_axes(t, self.mesh, axes)


class _Hub:
    """What the threads of :func:`within_pod_in_one_process` exchange
    through: one slot per rank and a barrier over all of them."""

    def __init__(self, sizes: dict):
        n = 1
        for v in sizes.values():
            n *= v
        self.barrier = threading.Barrier(n)
        self.slots: dict = {}


class ThreadComm:
    """:class:`MeshComm`'s gathers between threads: every rank of the
    mesh is a thread making the same calls in the same order."""

    def __init__(self, hub: _Hub, sizes: dict, coords: dict):
        self.hub, self.sizes, self.coords = hub, dict(sizes), dict(coords)

    def gather(self, t: torch.Tensor, axes: tuple) -> torch.Tensor:
        names = tuple(self.sizes)
        self.hub.slots[tuple(self.coords[a] for a in names)] = t
        self.hub.barrier.wait()
        keys = [()]
        for a in names:
            vals = range(self.sizes[a]) if a in axes else [self.coords[a]]
            keys = [k + (v,) for k in keys for v in vals]
        out = torch.stack([self.hub.slots[k] for k in keys])
        self.hub.barrier.wait()
        return out


class Shards:
    """Rank-order reductions of per-block partials of a leaf cut by a
    placement: over the axes that cut it (ranks that differ along any
    other axis hold the same block)."""

    def __init__(self, comm):
        self.comm = comm
        self.sizes = comm.sizes

    def blocks(self, entry) -> int:
        """How many blocks one placement entry cuts its dim into."""
        n = 1
        for a in _axes_of(entry):
            n *= self.sizes.get(a, 1)
        return n

    def gather(self, t: torch.Tensor, spec) -> torch.Tensor:
        """[n, ...]: ``t`` of every block of the leaf, in rank order."""
        return self.comm.gather(t, _cut_axes(self.sizes, spec))

    def total(self, partial: torch.Tensor, spec) -> torch.Tensor:
        """The sum over the leaf's blocks of each block's ``partial``."""
        if not _cut_axes(self.sizes, spec):
            return partial
        return ordered_sum(self.gather(partial, spec))

    def totals(self, partials: list, specs: list) -> list:
        """:meth:`total` of 0-d partials, one gather per set of axes."""
        out = list(partials)
        groups: dict = {}
        for i, spec in enumerate(specs):
            groups.setdefault(_cut_axes(self.sizes, spec), []).append(i)
        for axes, idx in groups.items():
            if not axes:
                continue
            got = ordered_sum(self.comm.gather(
                torch.stack([partials[i].reshape(()) for i in idx]), axes))
            for j, i in enumerate(idx):
                out[i] = got[j]
        return out


# ---------------------------------------------------------------------------
# Autograd pieces of the forward
# ---------------------------------------------------------------------------


def _gather_dim(t: torch.Tensor, dim: int, run: "PodRun",
                axis: str) -> torch.Tensor:
    """``t`` of every rank along ``axis`` concatenated on ``dim``."""
    n = run.sizes[axis]
    out = all_gather_dim0(t.movedim(dim, 0), run.mesh.get_group(axis), n)
    return out.movedim(0, dim)


class _Gather(torch.autograd.Function):
    """A leaf as the unit uses it: this rank's block gathered along the
    dims ``cuts`` names ((dim, axis) pairs).  The backward reduces the
    leaf's gradient to the block (:meth:`PodRun.reduce_grad`)."""

    @staticmethod
    def forward(ctx, block, run, cuts, partial):
        ctx.run, ctx.cuts, ctx.partial = run, cuts, partial
        ctx.dtype = block.dtype
        out = block
        for dim, axis in cuts:
            out = _gather_dim(out, dim, run, axis)
        return out if out is not block else block.view_as(block)

    @staticmethod
    def backward(ctx, g):
        return (ctx.run.reduce_grad(g, ctx.cuts, ctx.partial).to(ctx.dtype),
                None, None, None)


class _Enter(torch.autograd.Function):
    """Megatron's f: identity forward; the backward sums the gradient
    over "model" (each rank's heads or d_ff slice gave a part)."""

    @staticmethod
    def forward(ctx, x, run):
        ctx.run = run
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.run.model_sum(g).to(g.dtype), None


class _Reduce(torch.autograd.Function):
    """Megatron's g: the forward sums the ranks' partial outputs over
    "model" in rank order; identity backward."""

    @staticmethod
    def forward(ctx, x, run):
        return run.model_sum(x).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _VocabCE(torch.autograd.Function):
    """Mean cross-entropy over targets >= 0 of vocab-cut logits [..., V
    / n] (this rank's contiguous slice): the max, the sum of exps and the
    target's logit reduced over "model" in rank order; the backward is
    the rank's slice of softmax minus one-hot."""

    @staticmethod
    def forward(ctx, logits, targets, run):
        l32 = logits.to(torch.float32)
        cols = l32.shape[-1]
        lo = run.coords["model"] * cols
        m = run.model_gather(l32.amax(dim=-1)).amax(dim=0)
        e = torch.exp(l32 - m[..., None])
        se = run.model_sum(e.sum(dim=-1))
        tgt = torch.clamp(targets.to(torch.int64), 0,
                          cols * run.sizes["model"] - 1) - lo
        mine = (tgt >= 0) & (tgt < cols)
        tloc = tgt.clamp(0, cols - 1)
        picked = torch.where(mine, torch.gather(l32, -1, tloc[..., None])[
            ..., 0], 0.0)
        picked = run.model_sum(picked)
        nll = torch.log(se) + m - picked
        mask = (targets >= 0).to(torch.float32)
        count = torch.clamp_min(torch.sum(mask), 1.0)
        ctx.save_for_backward(e, se, tloc, mine, mask, count)
        ctx.dtype = logits.dtype
        return torch.sum(nll * mask) / count

    @staticmethod
    def backward(ctx, g):
        e, se, tloc, mine, mask, count = ctx.saved_tensors
        p = e / se[..., None]
        onehot = torch.zeros_like(p).scatter_(
            -1, tloc[..., None], mine[..., None].to(p.dtype))
        grad = (p - onehot) * (mask / count * g)[..., None]
        return grad.to(ctx.dtype), None, None


class TensorParallel:
    """The hooks of a tensor-parallel block
    (:func:`repro_torch.models.transformer._apply_block`)."""

    def __init__(self, run: "PodRun"):
        self.run = run

    def heads_cut(self, attn: dict, a) -> bool:
        """Whether this attention's heads are cut (its ``wq`` holds fewer
        heads than the configuration)."""
        return attn["wq"].shape[-2] != a.n_q

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(h, self.run)

    def reduce(self, out: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(out, self.run)

    def local_kv(self, k: torch.Tensor, v: torch.Tensor, hq_local: int, a):
        """K/V for this rank's query heads: as they are when the KV heads
        are cut alike; else the KV head of each local query head (a group
        of one)."""
        if k.shape[2] != a.n_kv:
            return k, v
        G = a.n_q // a.n_kv
        m = self.run.coords["model"]
        idx = torch.arange(m * hq_local, (m + 1) * hq_local,
                           device=k.device) // G
        return k.index_select(2, idx), v.index_select(2, idx)


class PodRun:
    """One rank's forward on a training mesh: what the model code asks of
    ``run`` (:func:`repro_torch.models.transformer.forward_train`).
    ``specs`` are the parameters' placements (:func:`param_shardings`
    of the logical tree)."""

    def __init__(self, cfg, mesh, specs: PyTree):
        self.cfg, self.mesh = cfg, mesh
        self.sizes = mesh_axes(mesh)
        self.coords = {a: mesh.get_local_rank(a) for a in self.sizes}
        self.specs = dict(tree_util.flatten_with_paths(specs))
        self.n_data = self.sizes.get("data", 1)
        self.n_model = self.sizes.get("model", 1)
        self.tp_mode = self.n_model > 1 and tensor_parallel_family(cfg)
        self.tp = TensorParallel(self) if self.tp_mode else None
        # whether a unit gathers leaves (then every unit is recomputed in
        # the backward, so what it gathered is dropped after its forward)
        self.gathers = self.n_data > 1 or (self.n_model > 1
                                           and not self.tp_mode)
        self.vocab_parallel = (self.tp_mode
                               and "model" in self.specs["embed"])
        self._lookup = make_vp_embed_lookup(mesh)

    # ---- collectives over "model" and the gradient reduction ----
    def model_gather(self, x: torch.Tensor) -> torch.Tensor:
        return gather_axes(x, self.mesh, ("model",))

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_ordered(x, self.mesh.get_group("model"),
                                  self.n_model)

    def reduce_grad(self, g: torch.Tensor, cuts, partial: bool):
        """A used leaf's gradient -> this rank's block's: summed over
        "model" when each rank's part saw only its heads, cut back along
        the gathered "model" dims (the model ranks of one data rank saw
        the same rows), then summed over the data ranks in rank order and
        divided by their number: a reduce-scatter along the leaf's "data"
        dim (:func:`reduce_scatter_ordered`), or, for a leaf that every
        data rank holds whole, an all-reduce (:func:`all_reduce_ordered`);
        either sums each element in rank order."""
        if partial:
            g = self.model_sum(g)
        data_dim = None
        for dim, axis in cuts:
            if axis == "data":
                data_dim = dim
                continue
            size = g.shape[dim] // self.sizes[axis]
            g = g.narrow(dim, self.coords[axis] * size, size)
        if self.n_data == 1:
            return g.contiguous()
        if data_dim is None:
            g = all_reduce_ordered(g, self.mesh.get_group("data"),
                                   self.n_data)
        else:
            g = reduce_scatter_ordered(g, data_dim,
                                       self.mesh.get_group("data"),
                                       self.n_data)
        return g.div_(self.n_data).contiguous()

    # ---- leaves ----
    def _cuts(self, spec) -> tuple:
        """(dim, axis) pairs a leaf is gathered along before use: its
        "data" dims, and its "model" dims outside tensor parallelism."""
        out = []
        for dim, entry in enumerate(spec):
            for a in _axes_of(entry):
                if self.sizes.get(a, 1) > 1 and (a == "data"
                                                 or not self.tp_mode):
                    out.append((dim, a))
        return tuple(out)

    def leaf(self, t: torch.Tensor, spec, partial: bool = False):
        cuts = self._cuts(spec)
        if not cuts and not partial and self.n_data == 1:
            return t
        return _Gather.apply(t, self, cuts, partial)

    def top(self, params: dict) -> dict:
        """The top-level leaves gathered; the block stacks as they are
        (:meth:`unit` gathers them unit by unit)."""
        return {k: v if k in ("blocks", "enc_blocks")
                else self.leaf(v, self.specs[k]) for k, v in params.items()}

    def _partial(self, stack: str, path: str) -> bool:
        """Whether a unit leaf's gradient is partial over "model": an
        uncut leaf of a head-cut attention."""
        parts = path.split("/")
        if not self.tp_mode or len(parts) < 3 or parts[1] != "attn":
            return False
        wq = self.specs[f"{stack}/{parts[0]}/attn/wq"]
        return "model" in wq and "model" not in self.specs[
            f"{stack}/{path}"]

    def unit(self, stack: str, unit_params: dict) -> dict:
        """One unit's leaves (this rank's blocks, the unit axis taken)
        as the unit uses them."""
        return tree_util.unflatten_paths({
            p: self.leaf(t, self.specs[f"{stack}/{p}"][1:],
                         self._partial(stack, p))
            for p, t in tree_util.flatten_with_paths(unit_params)})

    # ---- embedding, head, loss ----
    def embed(self, table: torch.Tensor, tokens: torch.Tensor):
        if self.vocab_parallel:
            return self._lookup(table, tokens)
        return table[tokens]

    def head_input(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self) if self.vocab_parallel else x

    def cross_entropy(self, logits, targets):
        if self.vocab_parallel:
            return _VocabCE.apply(logits, targets, self)
        from repro_torch.models.model import cross_entropy
        return cross_entropy(logits, targets)


# ---------------------------------------------------------------------------
# State, batch and the step
# ---------------------------------------------------------------------------


def logical_specs(cfg, mesh) -> PyTree:
    """The parameters' placements, from their shapes on the meta device
    (no weight is allocated)."""
    from repro_torch.models.transformer import init_params
    return param_shardings(init_params(cfg, device="meta"), cfg, mesh)


def shard_train_state(state: dict, cfg, mesh, index=None) -> dict:
    """This rank's block of every leaf of a logical train state under
    :func:`train_state_shardings`."""
    from repro_torch.distributed.sharding import shard_tree
    return shard_tree(state, train_state_shardings(state, cfg, mesh), mesh,
                      index)


def local_rows(batch: PyTree, mesh, index=None) -> PyTree:
    """This rank's rows of a global batch (dim 0 over ("pod", "data")).
    A batch that does not divide raises."""
    sizes = mesh_axes(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    what = (f"{n} pods" if sizes.get("data", 1) == 1 and n > 1
            else f"{n} data ranks")
    for leaf in tree_util.leaves(batch):
        if leaf.shape[0] % n:
            raise ValueError(f"a global batch of {leaf.shape[0]} rows does "
                             f"not divide over {what}")
    specs = batch_shardings(batch, mesh)
    return tree_util.tree_map(lambda x, s: local_shard(x, s, mesh, index),
                              batch, specs)


def sharded_update(state: dict, grads: PyTree, loss: torch.Tensor, tcfg,
                   shards: Shards, specs: PyTree):
    """Everything of a step after this rank's gradients: the loss's mean
    over the data ranks and pods, the pods' exchange, and the optimizer
    on the rank's blocks.  The exchange is compressed with error
    feedback when compression is on and the state carries it (a
    multi-pod state, ``init_train_state(multi_pod=True)``), on a mesh
    with a "pod" axis of any size, as the reference compresses on any
    "pod" axis; else a dense mean over more than one pod.
    -> (new state, metrics)."""
    from repro_torch.core.gradient_compression import (
        compressed_cross_pod_mean_sharded)
    from repro_torch.train.train_step import _apply_optimizer
    sizes = shards.sizes
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    losses = shards.comm.gather(loss.to(torch.float32),
                                tuple(a for a in ("pod", "data")
                                      if a in sizes))
    new_ef = None
    n_pods = sizes.get("pod", 1)
    if ("pod" in sizes and tcfg.grad_compression.enabled
            and "ef" in state):
        grads, new_ef = compressed_cross_pod_mean_sharded(
            grads, state["ef"], tcfg.grad_compression, shards, specs)
    elif n_pods > 1:
        grads = tree_util.tree_map(
            lambda g: (ordered_sum(shards.comm.gather(g, ("pod",)))
                       / n_pods).to(g.dtype), grads)
    new_state, metrics = _apply_optimizer(state, grads, tcfg, shards=shards,
                                          specs=specs)
    if new_ef is not None:
        new_state["ef"] = new_ef
    metrics["loss"] = ordered_sum(losses) / dp
    return new_state, metrics


def make_within_pod_step(api, tcfg, mesh):
    """-> step_fn(state, batch) -> (new_state, metrics) of one rank of a
    ("pod", "data", "model") mesh; ``state`` is the rank's blocks
    (:func:`shard_train_state`), ``batch`` the global batch on every
    rank."""
    from repro_torch.train.train_step import _microbatch_grads, deterministic
    made: dict = {}

    def step(state, batch):
        if not made:        # the mesh's groups are read at the first step
            made["specs"] = logical_specs(api.cfg, mesh)
            made["run"] = PodRun(api.cfg, mesh, made["specs"])
            made["shards"] = Shards(MeshComm(mesh))
        dev = tree_util.leaves(state["params"])[0].device
        rows = local_rows(batch, mesh)
        with deterministic(dev):
            loss, grads = _microbatch_grads(api, state["params"], rows,
                                            tcfg.microbatches,
                                            run=made["run"])
            return sharded_update(state, grads, loss, tcfg, made["shards"],
                                  made["specs"])

    return step


# ---------------------------------------------------------------------------
# The one-process oracles' pieces
# ---------------------------------------------------------------------------


def _coords(sizes: dict) -> list:
    keys = [()]
    for a in sizes:
        keys = [k + (v,) for k in keys for v in range(sizes[a])]
    return keys


def pod_grads(api, tcfg, params: PyTree, batch: PyTree, n_pods: int,
              n_data: int) -> tuple[list, list]:
    """Each pod's gradients as a mesh of (``n_pods``, ``n_data``, 1)
    computes them, in one process with the logical ``params``: per pod
    and microbatch, each data rank's gradients on its rows, their
    rank-order sum divided by the data ranks (in the leaf's dtype, as the
    gather's backward returns it), accumulated over microbatches in f32
    as the step does.  -> (grads[pod], losses[pod][data])."""
    from repro_torch.train.train_step import deterministic, value_and_grad
    mesh = AxisSizes({"pod": n_pods, "data": n_data, "model": 1})
    n_micro = tcfg.microbatches
    dev = tree_util.leaves(params)[0].device

    def loss_fn(p, mb):
        return api.loss_and_logits(p, mb)[0]

    grads, losses = [], []
    with deterministic(dev):
        for pod in range(n_pods):
            per = [local_rows(batch, mesh, {"pod": pod, "data": d,
                                            "model": 0})
                   for d in range(n_data)]
            micro = [tree_util.tree_map(
                lambda x: x.reshape((n_micro, x.shape[0] // n_micro)
                                    + tuple(x.shape[1:])), r) for r in per]
            acc, lsum = None, [None] * n_data
            for i in range(n_micro):
                outs = [value_and_grad(loss_fn, params,
                                       tree_util.tree_map(
                                           lambda x: x[i], m))  # noqa: B023
                        for m in micro]
                if n_data > 1:
                    g = tree_util.tree_map(
                        lambda *gs: (ordered_sum(torch.stack(gs))
                                     / n_data).to(gs[0].dtype),
                        *[o[1] for o in outs])
                else:
                    g = outs[0][1]
                if n_micro == 1:
                    acc = g
                    lsum = [o[0] for o in outs]
                    continue
                if acc is None:
                    acc = tree_util.tree_map(
                        lambda q: torch.zeros(q.shape, dtype=torch.float32,
                                              device=q.device), params)
                    lsum = [torch.zeros((), dtype=torch.float32,
                                        device=dev) for _ in range(n_data)]
                acc = tree_util.tree_map(lambda a, b: a + b.to(torch.float32),
                                         acc, g)
                lsum = [s + o[0] for s, o in zip(lsum, outs)]
            if n_micro > 1:
                inv = 1.0 / n_micro
                acc = tree_util.tree_map(lambda q: q * inv, acc)
                lsum = [s * inv for s in lsum]
            grads.append(acc)
            losses.append(lsum)
    return grads, losses


def in_threads(sizes: dict, fn, device=None) -> dict:
    """``fn(coords, shards)`` for every rank of a mesh of ``sizes``, each
    rank a thread whose :class:`Shards` exchange through the others
    (:class:`ThreadComm`).  -> {coordinate tuple: what ``fn`` returned};
    a rank that raises frees the others and its error is raised."""
    from repro_torch.train.train_step import deterministic
    hub = _Hub(sizes)
    results: dict = {}
    errors: list = []

    def rank(c):
        coords = dict(zip(sizes, c))
        try:
            with torch.no_grad():
                results[c] = fn(coords, Shards(ThreadComm(hub, sizes,
                                                          coords)))
        except BaseException as e:      # a failed rank frees the others
            errors.append(e)
            hub.barrier.abort()

    with deterministic(device or "cpu"):
        threads = [threading.Thread(target=rank, args=(c,))
                   for c in _coords(sizes)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    return results


def within_pod_in_one_process(api, tcfg, shape, states: dict,
                              batch: PyTree) -> dict:
    """The within-pod step of a mesh ``shape`` = (pod, data, 1) in one
    process, the version the SPMD step is held to bit for bit.
    ``states`` maps each rank's coordinates (pod, data, model) to its
    blocks.  Each pod's gradients as :func:`pod_grads` gives them, then
    every rank's :func:`sharded_update` on its blocks, each rank a
    thread (:func:`in_threads`).  It shares :func:`sharded_update` with
    the step, so it holds the step's collectives and their order; the
    statistics across blocks are held to the logical leaf's by
    :func:`repro_torch.train.train_step.pods_in_one_process` and
    ``tests/test_torch_within_pod.py``.
    -> {coordinates: (new blocks, metrics)}."""
    sizes = dict(zip(TRAIN_AXES, shape))
    if sizes["model"] != 1:
        raise ValueError("the one-process oracle runs meshes without a "
                         "'model' axis")
    mesh = AxisSizes(sizes)
    specs = logical_specs(api.cfg, mesh)
    flat_specs = dict(tree_util.flatten_with_paths(specs))
    dev = tree_util.leaves(states[(0, 0, 0)]["params"])[0].device
    params = tree_util.unflatten_paths({
        p: assemble({c: dict(tree_util.flatten_with_paths(
            s["params"]))[p] for c, s in states.items()}, flat_specs[p],
            sizes) for p in flat_specs})
    grads, losses = pod_grads(api, tcfg, params, batch, sizes["pod"],
                              sizes["data"])

    def rank(coords, shards):
        c = tuple(coords.values())
        g = tree_util.tree_map(lambda x, s: local_shard(x, s, mesh, coords),
                               grads[c[0]], specs)
        return sharded_update(states[c], g, losses[c[0]][c[1]], tcfg,
                              shards, specs)

    return in_threads(sizes, rank, dev)
