"""The train step inside a pod: a ("pod", "data", "model") mesh under the
reference's training rules (``repro/distributed/sharding.py``).

The reference places a logical train state by ``train_state_shardings``
and lets GSPMD partition its step.  The port is SPMD by process: every
rank holds only its block of each parameter, optimizer slot and
error-feedback leaf (:func:`repro_torch.distributed.sharding.
train_state_shardings`, cut by :func:`shard_train_state`) and its rows of
the global batch (``batch_shardings``: dim 0 over ("pod", "data")), and
the collectives are written out:

* **The loss is the reference's.**  The reference cuts a pod's batch
  into microbatches of contiguous rows and GSPMD partitions each
  microbatch's logical loss.  Here microbatch i of a pod is its rows
  [i b, (i + 1) b) and data rank d takes its contiguous share of each
  (:func:`local_rows`); its loss is its share of the microbatch's: the
  cross-entropy of its rows over the valid targets of every data rank,
  and the MoE aux with f_e over every data rank's tokens and p_e summed
  over its own (:meth:`PodRun.data_total`, a sum of counts over
  "data").  The data ranks' losses and gradients then add up to the
  logical ones; the reported loss is their sum, averaged over pods as
  ``lax.pmean`` averages it.
* **"data" is FSDP.**  Each unit's leaves are all-gathered along their
  "data" dim before the unit runs, inside a checkpoint, so they are
  dropped after its forward and gathered again for its backward
  (:class:`_Gather`); the decoder's last unit keeps them, as its
  backward follows at once.  A gradient comes back to the rank's block
  summed over the data ranks in rank order (a reduce-scatter: each rank
  receives the other ranks' copies of its block only).
* **"model" is tensor parallelism** for every family, as ``param_pspec``
  places the leaves (Megatron's f and g operators,
  :class:`TensorParallel`): attention heads are cut where
  ``heads_shardable`` holds (self- and cross-attention; the encoder's
  as the decoder's), the FFN on d_ff (rwkv's channel mix too), the
  experts on d_ff or E, and mamba on d_inner; one sum over "model"
  follows each cut region (the attention's ``wo``, the FFN, dense, MoE
  or channel mix, mamba's ``out_proj``); the embedding is the
  vocab-parallel lookup with a vocab-parallel head and cross-entropy
  where the vocab divides (:class:`_VocabCE`).  An MoE's router, top-k
  and aux run on every model rank alike, outside the cut region; its
  experts run cut inside it (:func:`repro_torch.models.ffn.moe_ffn`):
  mixtral (``expert_parallel=False``) a d_ff slice of every expert,
  llama4 and jamba their E / M whole experts on every token of the data
  rank, with the slots of the routing over all E, so no token is
  exchanged.  rwkv's time mix (``head_tp=False``) and its channel mix's
  receptance run alike on every model rank; f enters only the key
  path's input.  A mamba rank runs its d_inner slice: ``in_proj``'s
  placed block is a contiguous run of the [x_in | z] columns, so before
  the unit runs each rank's block is regrouped over "model" into x_in's
  and z's slice of the rank (:class:`_Regroup`, an exchange of weight
  blocks; the backward sends each gradient block back to where it is
  placed), and the sum after ``x_proj`` (cut on its contraction dim)
  feeds each rank's own slice, so an f follows that g and its backward
  sums over "model" too.  A cross-attention's K/V projections enter
  ``enc_out`` with an f of their own.  A rank holds 1 / (D M) of a cut
  leaf between units and 1 / M while a unit runs; no leaf is gathered
  over "model".  A leaf used inside a cut region but not cut itself
  (q/k norms, K/V projections whose heads do not divide) gets its
  gradient summed over "model".
* **Statistics across blocks** (AdamW's global norm, Adafactor's
  factored moments, the compression's threshold and scale) sum each
  block's partial in rank order over the ranks holding the leaf's other
  blocks (:class:`Shards`).
* **Pods** exchange each rank's block compressed with the logical leaf's
  threshold and scale
  (:func:`repro_torch.core.gradient_compression.
  compressed_cross_pod_mean_sharded`).

**Serving inside a pod** (:func:`make_pod_serve`) runs the reference's
prefill and decode cells as it lowers them: the parameters placed by
``param_shardings`` (:func:`pod_serve_params`), each unit gathered over
"data" only and run with the tensor-parallel hooks above, the decode
cache placed by ``cache_pspec`` (:class:`PodServe`): every head of the
rank's sequence slice of each attention ring and of the cross-KV (one
all-to-all over "model" after the prefill computed the rank's heads),
mamba's states on the rank's d_inner slice (gathered over "model" where
the batch divides and ``cache_pspec`` holds them whole), rwkv's by the
batch.  A decode step gathers the rank's q, k and v heads over "model"
(``[rows, 1, H, D]``), attends over its slice with every head, combines
the partials over the sequence shards and keeps its heads of the output
for the cut ``wo``.  No leaf is gathered over "model" here either.

Every sum across ranks exchanges the parts (an all-gather, or an
``all_to_all`` for the gradients' data sum and the tensor-parallel sums)
and adds them in rank order, so the result does not depend on a backend's reduction
order, and
:func:`within_pod_in_one_process` reproduces a mesh without a "model"
axis bit for bit in one process: each rank's gradients on its rows with
the logical parameters (its counts over "data" from a first forward of
every rank, :class:`_OneRank`), the same rank-order sums, then every
rank's update in a thread of its own whose collectives are exchanges
between the threads (:class:`ThreadComm`).
"""

from __future__ import annotations

import threading
from typing import Any

import torch

from repro_torch import tree as tree_util
from repro_torch.distributed.collectives import (MeshComm, _seq_index,
                                                 all_reduce_ordered,
                                                 make_sp_cross_attn,
                                                 make_sp_decode_attn,
                                                 make_vp_embed_lookup,
                                                 ordered_sum,
                                                 reduce_scatter_ordered)
from repro_torch.distributed.sharding import (_axes_of, assemble,
                                              batch_axes, batch_shardings,
                                              cache_placement, decode_layout,
                                              local_shard, param_shardings,
                                              shard_tree,
                                              train_state_shardings)
from repro_torch.launch.mesh import TRAIN_AXES, mesh_axes

PyTree = Any


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

    def total(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """:meth:`MeshComm.total`: the ranks' ``t`` summed in rank order,
        f32."""
        return ordered_sum(self.gather(t, (axis,)))

    def all_to_all(self, send: torch.Tensor, to, frm,
                   axis: str) -> torch.Tensor:
        """:meth:`MeshComm.all_to_all` between the threads."""
        names = tuple(self.sizes)
        self.hub.slots[tuple(self.coords[a] for a in names)] = dict(
            zip(to, send))
        self.hub.barrier.wait()
        me = self.coords[axis]
        out = torch.stack([self.hub.slots[tuple(
            r if a == axis else self.coords[a] for a in names)][me]
            for r in frm])
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
    """``t`` of every rank along ``axis`` concatenated on ``dim``, made
    contiguous: a product then reads the leaf in the logical leaf's
    layout, as the one-process oracle's does (a strided operand may take
    another kernel that sums in another order)."""
    out = run.comm.gather(t.movedim(dim, 0), (axis,)).flatten(0, 1)
    return out.movedim(0, dim).contiguous()


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


def regrouped(path: str) -> bool:
    """Whether a unit leaf runs regrouped over "model" under tensor
    parallelism (:class:`_Regroup`): mamba's ``in_proj``."""
    return path.endswith("mamba/in_proj")


def _regroup(t: torch.Tensor, run, back: bool) -> torch.Tensor:
    """Mamba's ``in_proj`` columns [x_in | z] are 2 M chunks of Din / M.
    Model rank m holds chunks 2m and 2m + 1 (its placed block's halves)
    and runs chunks m and M + m (x_in's and z's slice m): one all-to-all
    sends its halves to ranks 2m and 2m + 1 (mod M) and takes the chunks
    it runs from ranks m // 2 and (M + m) // 2; ``back`` sends them the
    other way round.  For an even M (d_inner is a power of two) both
    pairs are in rank order, as the all-to-all's parts are.  ``run``
    brings ``coords``, ``n_model`` and ``model_all_to_all``."""
    m, M = run.coords["model"], run.n_model
    held = ((2 * m) % M, (2 * m + 1) % M)
    used = (m // 2, (M + m) // 2)
    to, frm = (used, held) if back else (held, used)
    send = t.unflatten(-1, (2, -1)).movedim(-2, 0).contiguous()
    return run.model_all_to_all(send, to, frm).movedim(0, -2).flatten(-2)


class _Regroup(torch.autograd.Function):
    """Mamba's ``in_proj`` block as the rank runs it: its placed block
    (a contiguous run of the [x_in | z] columns) exchanged over "model"
    for x_in's and z's slice of the rank (:func:`_regroup`).  The
    backward is the inverse exchange, so each gradient block lands on
    the rank that holds it, with no sum."""

    @staticmethod
    def forward(ctx, block, run):
        ctx.run = run
        return _regroup(block, run, back=False)

    @staticmethod
    def backward(ctx, g):
        return _regroup(g, ctx.run, back=True), None


class _VocabCE(torch.autograd.Function):
    """Mean cross-entropy over targets >= 0 of vocab-cut logits [..., V
    / n] (this rank's contiguous slice), its rows' share of the
    microbatch's (over the valid targets of every data rank): the max,
    the sum of exps and the target's logit reduced over "model" in rank
    order; the backward is the rank's slice of softmax minus one-hot."""

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
        count = torch.clamp_min(run.data_total(torch.sum(mask)), 1.0)
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
        self.rank = run.coords["model"]

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

    def all_heads(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """[B, T, h, D] of this rank's heads -> all ``n`` heads, gathered
        over "model" in rank order (``wq``/``wk`` cut them contiguously);
        heads held whole are returned as they are."""
        if t.shape[2] == n:
            return t
        return self.run.model_gather(t).movedim(0, 2).flatten(2, 3)

    def own_heads(self, o: torch.Tensor) -> torch.Tensor:
        """This rank's heads of [B, T, H, D] (for the cut ``wo``)."""
        h = o.shape[2] // self.run.n_model
        return o[:, :, self.rank * h:(self.rank + 1) * h]


class PodRun:
    """One rank's forward on a training mesh: what the model code asks of
    ``run`` (:func:`repro_torch.models.transformer.forward_train`).
    ``specs`` are the parameters' placements (:func:`param_shardings`
    of the logical tree).  ``comm`` carries the collectives (the mesh's
    own :class:`MeshComm` by default; :class:`ThreadComm` for ranks that
    are threads, ``mesh`` then their :class:`AxisSizes`).  ``serve``
    (``(global_batch, cache_len)``) makes it a serving rank's
    (:func:`make_pod_serve`): ``run.serve`` holds the decode cache's
    placement (:class:`PodServe`), no unit is recomputed and an MoE
    takes no load-balancing sum."""

    def __init__(self, cfg, mesh, specs: PyTree, comm=None, serve=None):
        self.cfg, self.mesh = cfg, mesh
        self.comm = comm if comm is not None else MeshComm(mesh)
        self.sizes = dict(self.comm.sizes)
        self.coords = dict(self.comm.coords)
        self.specs = dict(tree_util.flatten_with_paths(specs))
        self.n_data = self.sizes.get("data", 1)
        self.n_model = self.sizes.get("model", 1)
        self.tp = TensorParallel(self) if self.n_model > 1 else None
        self.serving = serve is not None
        # whether a unit gathers leaves (then every unit but the last is
        # recomputed in the backward, so what it gathered is dropped
        # after its forward)
        self.gathers = self.n_data > 1 and not self.serving
        self.vocab_parallel = (self.tp is not None
                               and "model" in self.specs["embed"])
        self._lookup = make_vp_embed_lookup(mesh, self.comm)
        self.serve = PodServe(self, cfg, *serve) if self.serving else None

    # ---- collectives over "model" and the gradient reduction ----
    def model_gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.gather(x, ("model",))

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.comm.total(x, "model")

    def model_all_to_all(self, send: torch.Tensor, to,
                         frm) -> torch.Tensor:
        """Row i of ``send`` to the i-th of the model ranks ``to`` (in rank
        order) -> what the model ranks ``frm`` sent this rank, a row each
        in rank order."""
        return self.comm.all_to_all(send, to, frm, "model")

    def data_total(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data ranks of this rank's pod in rank
        order, the same bits on each (f32): the microbatch's counts of
        valid targets and of tokens routed to each expert.  ``t`` carries
        no gradient."""
        if self.n_data == 1:
            return t
        return ordered_sum(self.comm.gather(t.detach(), ("data",)))

    def reduce_grad(self, g: torch.Tensor, cuts, partial: bool):
        """A used leaf's gradient -> this rank's block's: summed over
        "model" when each rank's part saw only its heads, then summed
        over the data ranks in rank order
        (each rank's loss is its share of the microbatch's): a
        reduce-scatter along the leaf's "data" dim
        (:func:`reduce_scatter_ordered`), or, for a leaf that every data
        rank holds whole, an all-reduce (:func:`all_reduce_ordered`);
        either sums each element in rank order."""
        if partial:
            g = self.model_sum(g)
        data_dim = next((dim for dim, _ in cuts), None)
        if self.n_data == 1:
            return g.contiguous()
        if data_dim is None:
            g = all_reduce_ordered(g, self.mesh.get_group("data"),
                                   self.n_data)
        else:
            g = reduce_scatter_ordered(g, data_dim,
                                       self.mesh.get_group("data"),
                                       self.n_data)
        return g.contiguous()

    # ---- leaves ----
    def _cuts(self, spec) -> tuple:
        """(dim, axis) pairs a leaf is gathered along before use: its
        "data" dim (its "model" dims stay cut)."""
        return tuple((dim, "data") for dim, entry in enumerate(spec)
                     if "data" in _axes_of(entry) and self.n_data > 1)

    def leaf(self, t: torch.Tensor, spec, partial: bool = False,
             regroup: bool = False):
        """A leaf as the unit uses it; ``regroup`` (mamba's ``in_proj``
        under tensor parallelism) first exchanges its columns over
        "model" (:class:`_Regroup`)."""
        if regroup:
            t = _Regroup.apply(t, self)
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
        uncut leaf of a head-cut self- or cross-attention."""
        parts = path.split("/")
        if (self.tp is None or len(parts) < 3
                or parts[1] not in ("attn", "cross")):
            return False
        wq = self.specs[f"{stack}/{parts[0]}/{parts[1]}/wq"]
        return "model" in wq and "model" not in self.specs[
            f"{stack}/{path}"]

    def unit(self, stack: str, unit_params: dict) -> dict:
        """One unit's leaves (this rank's blocks, the unit axis taken)
        as the unit uses them."""
        return tree_util.unflatten_paths({
            p: self.leaf(t, self.specs[f"{stack}/{p}"][1:],
                         self._partial(stack, p),
                         self.tp is not None and regrouped(p))
            for p, t in tree_util.flatten_with_paths(unit_params)})

    # ---- embedding, head, loss ----
    def embed(self, table: torch.Tensor, tokens: torch.Tensor):
        if self.vocab_parallel:
            return self._lookup(table, tokens)
        return table[tokens]

    def head_input(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self) if self.vocab_parallel else x

    def whole_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Logits of every vocab entry: a vocab-parallel head's slices
        [..., V / M] gathered over "model" in rank order."""
        if not self.vocab_parallel:
            return logits
        return self.model_gather(logits).movedim(0, -2).flatten(-2)

    def cross_entropy(self, logits, targets):
        if self.vocab_parallel:
            return _VocabCE.apply(logits, targets, self)
        from repro_torch.models.model import cross_entropy
        return cross_entropy(logits, targets, total=self.data_total)


class PodServe:
    """A serving rank's decode cache (``run.serve``, read by
    :func:`repro_torch.models.transformer.prefill` and ``decode_step``):
    placed by :func:`repro_torch.distributed.sharding.cache_placement`
    for ``global_batch`` rows (``cache_pspec``, a dim that does not
    divide kept whole), and the exchanges that put each prefilled leaf
    there.  The batch is cut over the data axes where it divides, else
    every rank runs every row and the sequence is cut over every axis
    (``decode_layout``)."""

    def __init__(self, run: PodRun, cfg, global_batch: int,
                 cache_len: int):
        self.run, self.cfg = run, cfg
        self.global_batch, self.cache_len = global_batch, cache_len
        self.mesh = AxisSizes(run.sizes)
        baxes, self.seq_axes = decode_layout(self.mesh, global_batch)
        # the batch cut over the data axes; then cache_pspec holds
        # mamba's states whole over "model", else on d_inner
        self.rows_cut = baxes is not None
        self.n_seq = 1
        for a in self.seq_axes:
            self.n_seq *= run.sizes[a]
        self.seq_me = _seq_index(run.comm, self.seq_axes)
        self.decode_attn = make_sp_decode_attn(self.mesh, global_batch,
                                               cache_len, comm=run.comm)
        self.cross_attn = (make_sp_cross_attn(
            self.mesh, global_batch, cfg.frontend.n_tokens, run.comm)
            if cfg.cross_attn else None)

    def rows(self, tree: PyTree) -> PyTree:
        """This rank's rows of a global batch (every row when the batch
        does not divide)."""
        if not self.rows_cut:
            return tree
        return local_rows(tree, self.mesh, self.run.coords)

    def every_row(self, t: torch.Tensor) -> torch.Tensor:
        """[rows, ...] of this rank -> [B, ...] of every rank's rows."""
        if not self.rows_cut:
            return t
        return self.run.comm.gather(t, batch_axes(self.mesh)).flatten(0, 1)

    def new_cache(self, dtype, device) -> dict:
        """A decode cache of this rank's blocks: zeros, ``pos`` -1."""
        from repro_torch.models.transformer import init_decode_cache
        meta = init_decode_cache(self.cfg, self.global_batch, self.cache_len,
                                 dtype=dtype, device="meta")
        specs = cache_placement(meta, self.mesh, self.global_batch)
        return tree_util.unflatten_paths({
            p: torch.full(local_shard(t, s, self.mesh,
                                      self.run.coords).shape,
                          -1 if p.endswith("/pos") else 0, dtype=t.dtype,
                          device=device)
            for (p, t), s in zip(tree_util.flatten_with_paths(meta),
                                 tree_util.leaves(specs))})

    def _slice(self, t: torch.Tensor, dim: int, j: int) -> torch.Tensor:
        L = t.shape[dim] // self.n_seq
        return t.narrow(dim, j * L, L)

    def place_seq(self, t: torch.Tensor, n_heads: int) -> torch.Tensor:
        """A sequence [B, S, h, D] this rank computed for its heads (a
        filled ring, or the cross-KV over the encoder positions) -> its
        placed block: every head over the rank's sequence slice, by one
        all-to-all over "model" when the heads are cut (model rank j
        receives slice ``seq_me - m + j``: "model" is the layout's last
        sequence axis); a length that does not divide stays whole, its
        heads gathered."""
        cut = t.shape[2] != n_heads
        if t.shape[1] % self.n_seq:
            return self.run.tp.all_heads(t, n_heads) if cut else t
        if not cut:
            return self._slice(t, 1, self.seq_me)
        M, m = self.run.n_model, self.run.coords["model"]
        send = torch.stack([self._slice(t, 1, self.seq_me - m + j)
                            for j in range(M)])
        recv = self.run.model_all_to_all(send, range(M), range(M))
        return recv.movedim(0, 2).flatten(2, 3)

    def place_pos(self, pos: torch.Tensor) -> torch.Tensor:
        """A ring's slot positions [S] -> the rank's slice."""
        if pos.shape[0] % self.n_seq:
            return pos
        return self._slice(pos, 0, self.seq_me)

    def _mamba_cut(self) -> bool:
        """Whether the rank runs a d_inner slice of mamba that
        ``cache_pspec`` holds whole over "model" (the batch divides)."""
        return self.run.tp is not None and self.rows_cut

    def place_state(self, kind: str, st: tuple) -> tuple:
        """A recurrent block's state the rank computed -> its placed
        block.  Mamba's ``h`` [B, d, N] and conv ring [B, K - 1, d] of the
        rank's d_inner slice are gathered over "model" where the batch
        divides; rwkv's (its time mix runs whole on every rank) are kept."""
        if kind != "mamba" or not self._mamba_cut():
            return st
        h, conv = (self.run.model_gather(t) for t in st)
        return h.movedim(0, 1).flatten(1, 2), conv.movedim(0, 2).flatten(2, 3)

    def mamba_state(self, h: torch.Tensor, conv: torch.Tensor,
                    d_local: int) -> tuple:
        """The rank's d_inner slice of a placed mamba state (views)."""
        if not self._mamba_cut():
            return h, conv
        lo = self.run.coords["model"] * d_local
        return h.narrow(1, lo, d_local), conv.narrow(2, lo, d_local)


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


def local_rows(batch: PyTree, mesh, index=None,
               microbatches: int = 1) -> PyTree:
    """This rank's rows of a global batch, as the reference's step cuts
    them: pod p takes its contiguous block of rows (dim 0 over ("pod",
    "data")), cut into ``microbatches`` contiguous microbatches, and data
    rank d its contiguous share of each, in microbatch order (so that
    ``_microbatch_grads`` cuts them into the rank's shares).  A batch, a
    pod's batch or a microbatch that does not divide raises."""
    sizes = mesh_axes(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= sizes[a]
    n_pods, n_data = sizes.get("pod", 1), sizes.get("data", 1)
    what = (f"{n} pods" if n_data == 1 and n > 1 else f"{n} data ranks")
    for leaf in tree_util.leaves(batch):
        B = leaf.shape[0]
        if B % n:
            raise ValueError(f"a global batch of {B} rows does not divide "
                             f"over {what}")
        b = B // n_pods
        if b % microbatches:
            raise ValueError(f"a pod's batch of {b} rows does not divide "
                             f"into {microbatches} microbatches")
        if (b // microbatches) % n_data:
            raise ValueError(f"a microbatch of {b // microbatches} rows "
                             f"does not divide over {n_data} data ranks")

    def rows(x, spec):
        if microbatches > 1 and n_data > 1:
            # each data rank's shares of the microbatches made contiguous
            x = x.reshape((n_pods, microbatches, n_data, -1)
                          + tuple(x.shape[1:])).transpose(1, 2).reshape(
                              x.shape)
        return local_shard(x, spec, mesh, index)

    return tree_util.tree_map(rows, batch, batch_shardings(batch, mesh))


def sharded_update(state: dict, grads: PyTree, loss: torch.Tensor, tcfg,
                   shards: Shards, specs: PyTree):
    """Everything of a step after this rank's gradients: the loss (the
    sum of the data ranks' shares, averaged over pods), the pods'
    exchange, and the optimizer on the rank's blocks.  The exchange is
    compressed with error feedback when compression is on and the state
    carries it (a multi-pod state, ``init_train_state(multi_pod=True)``),
    on a mesh with a "pod" axis of any size, as the reference compresses
    on any "pod" axis; else a dense mean over more than one pod.
    -> (new state, metrics)."""
    from repro_torch.core.gradient_compression import (
        compressed_cross_pod_mean_sharded)
    from repro_torch.train.train_step import _apply_optimizer
    sizes = shards.sizes
    n_pods = sizes.get("pod", 1)
    losses = shards.comm.gather(loss.to(torch.float32),
                                tuple(a for a in ("pod", "data")
                                      if a in sizes)).reshape(n_pods, -1)
    new_ef = None
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
    metrics["loss"] = ordered_sum(torch.stack(
        [ordered_sum(pod) for pod in losses])) / n_pods
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
        rows = local_rows(batch, mesh, microbatches=tcfg.microbatches)
        with deterministic(dev):
            loss, grads = _microbatch_grads(api, state["params"], rows,
                                            tcfg.microbatches,
                                            run=made["run"])
            return sharded_update(state, grads, loss, tcfg, made["shards"],
                                  made["specs"])

    return step


def pod_serve_params(params: PyTree, cfg, mesh, index=None,
                     device="cuda") -> PyTree:
    """This rank's blocks of a mesh-free parameter tree (from ``init``
    or :mod:`repro_torch.convert`) under :func:`param_shardings`: FSDP
    over "data", tensor parallelism over "model", on ``device``.
    ``index`` gives the rank's coordinates explicitly (a mesh of axis
    sizes alone)."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    return tree_util.tree_map(
        lambda t: t.to(dev),
        shard_tree(params, param_shardings(params, cfg, mesh), mesh, index))


def make_pod_serve(api, mesh, global_batch: int, cache_len: int,
                   comm=None):
    """-> (prefill, decode_step) of one rank of a ("pod", "data",
    "model") mesh: the reference's prefill and decode cells as it lowers
    them under ``param_shardings`` (``api.prefill(params, batch, rt,
    cache_len)`` and ``api.decode_step(params, token, cache, rt)``, no
    expert).

    ``prefill(params, batch) -> (logits [B, 1, V], cache)`` and
    ``decode_step(params, token, cache) -> (logits [B, 1, V], cache)``:
    ``params`` are the rank's blocks (:func:`pod_serve_params`),
    ``batch`` and ``token`` ([B, 1]) the global ones on every rank, which
    runs its rows (:meth:`PodServe.rows`); each unit is gathered over
    "data" and runs cut over "model" (no leaf is gathered over it), and
    the cache is the rank's blocks (:class:`PodServe`), written in
    place by the decode.  The logits are every row's, on every rank (the
    reference's replicated ``out_shardings``).  ``comm`` as in
    :class:`PodRun`."""
    run = PodRun(api.cfg, mesh, logical_specs(api.cfg, mesh), comm=comm,
                 serve=(global_batch, cache_len))
    serve = run.serve

    def prefill(params, batch):
        with torch.no_grad():
            lg, cache = api.prefill(params, serve.rows(batch), cache_len,
                                    run=run)
            return serve.every_row(lg), cache

    def decode_step(params, token, cache):
        with torch.no_grad():
            lg, cache = api.decode_step(
                params, serve.rows({"token": token})["token"], cache,
                run=run, decode_attn=serve.decode_attn)
            return serve.every_row(lg), cache

    return prefill, decode_step


# ---------------------------------------------------------------------------
# The one-process oracles' pieces
# ---------------------------------------------------------------------------


def _coords(sizes: dict) -> list:
    keys = [()]
    for a in sizes:
        keys = [k + (v,) for k in keys for v in range(sizes[a])]
    return keys


class _OneRank:
    """The forward hooks of one data rank in :func:`pod_grads`: the
    logical leaves as they are, and the sums over the data ranks
    (:meth:`PodRun.data_total`) taken from a first forward of every rank,
    which records each rank's parts (``totals`` None), then replayed in
    call order, summed in rank order (``totals`` set).  The forward must
    not recompute a unit (a run without remat)."""

    tp = None
    gathers = False
    serving = False

    def __init__(self):
        self.parts: list = []
        self.totals = None

    def data_total(self, t: torch.Tensor) -> torch.Tensor:
        if self.totals is None:
            self.parts.append(t.detach().to(torch.float32))
            return t
        if not self.totals:
            raise RuntimeError("the forward asked for more sums over the "
                               "data ranks than its first pass recorded")
        return self.totals.pop(0)

    def top(self, params: dict) -> dict:
        return params

    def unit(self, stack: str, unit_params: dict) -> dict:
        return unit_params

    def embed(self, table: torch.Tensor, tokens: torch.Tensor):
        return table[tokens]

    def head_input(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def cross_entropy(self, logits, targets):
        from repro_torch.models.model import cross_entropy
        return cross_entropy(logits, targets, total=self.data_total)


def pod_grads(api, tcfg, params: PyTree, batch: PyTree, n_pods: int,
              n_data: int) -> tuple[list, list]:
    """Each pod's gradients as a mesh of (``n_pods``, ``n_data``, 1)
    computes them, in one process with the logical ``params``: per pod
    and microbatch, each data rank's gradients of its share of the
    microbatch's loss on its rows (:func:`local_rows`; the sums over the
    data ranks from a first forward of every rank, :class:`_OneRank`),
    their rank-order sum (in the leaf's dtype, as the gather's backward
    returns it), accumulated over microbatches in f32 as the step does.
    -> (grads[pod], losses[pod][data]: each rank's share, averaged over
    the microbatches)."""
    from repro_torch.train.train_step import deterministic, value_and_grad
    mesh = AxisSizes({"pod": n_pods, "data": n_data, "model": 1})
    n_micro = tcfg.microbatches
    dev = tree_util.leaves(params)[0].device

    def loss_fn(p, mb, run):
        return api.loss_and_logits(p, mb, run=run)[0]

    grads, losses = [], []
    with deterministic(dev):
        for pod in range(n_pods):
            per = [local_rows(batch, mesh, {"pod": pod, "data": d,
                                            "model": 0}, n_micro)
                   for d in range(n_data)]
            micro = [tree_util.tree_map(
                lambda x: x.reshape((n_micro, x.shape[0] // n_micro)
                                    + tuple(x.shape[1:])), r) for r in per]
            acc, lsum = None, [None] * n_data
            for i in range(n_micro):
                mbs = [tree_util.tree_map(lambda x: x[i], m)  # noqa: B023
                       for m in micro]
                runs = [_OneRank() for _ in range(n_data)]
                with torch.no_grad():
                    for run, mb in zip(runs, mbs):
                        api.loss_and_logits(params, mb, run=run)
                totals = [ordered_sum(torch.stack(parts))
                          for parts in zip(*[r.parts for r in runs])]
                for run in runs:
                    run.totals = list(totals)
                outs = [value_and_grad(loss_fn, params, mb, run)
                        for run, mb in zip(runs, mbs)]
                if n_data > 1:
                    g = tree_util.tree_map(
                        lambda *gs: ordered_sum(torch.stack(gs)).to(
                            gs[0].dtype), *[o[1] for o in outs])
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
