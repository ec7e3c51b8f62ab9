"""The serving mesh's collectives, written by hand.

Port of the serve half of ``repro/distributed/collectives.py``.  JAX
places a logical array and lets its partitioner insert the collectives;
here every rank holds its shard as an ordinary local tensor and
:class:`ServeComm` issues each collective explicitly on the mesh's
sub-groups (NCCL on the card, gloo on the CPU or for ranks sharing one
card).  Each collective keeps the single-device arithmetic exact:

* :meth:`ServeComm.vocab_embed`: a lookup of the ids in the rank's vocab
  rows (zeros elsewhere), then ``all_reduce(SUM)`` over "model": every
  element sums one value and exact zeros (the pattern of the
  reference's ``make_vp_embed_lookup``).
* :meth:`ServeComm.reduce_experts`: ``all_reduce(SUM)`` of a delta over
  "expert", where each element has one nonzero term.
* :meth:`ServeComm.gather_vocab`: the logits' vocab slices gathered into
  ``[B, V]``, so the token select runs on the single-device logits on
  every rank.
* :class:`RowLayout`: batch rows cut round-robin over "model" (row ``j``
  on model rank ``j % n``) where the serve rules cut the batch
  (:func:`repro_torch.distributed.sharding.serve_row_shards`), padded to
  one row count per rank, and gathered back in row order.

The training and decode meshes' collectives follow
(``repro/distributed/collectives.py``'s manual regions):

* :func:`flash_combine`: flash partials (o, m, l) of every sequence
  shard all-gathered and combined in rank order, so the result is the
  same on every rank and does not depend on a backend's reduction order.
* :func:`make_sp_decode_attn`: sequence-parallel decode attention over a
  ring cut by :func:`repro_torch.distributed.sharding.cache_pspec`
  (:func:`shard_decode_cache` cuts a prefilled one): the rank that owns
  ring slot ``cur mod S`` writes the new K/V, every rank attends over its
  slice, and the partials are combined.
* :func:`make_sp_cross_attn`: the decode's cross-attention over the
  rank's slice of the encoder positions, combined the same way.
* :func:`make_vp_embed_lookup`: the vocab-parallel lookup as an autograd
  function (a masked lookup in the rank's rows, taken from the owner on
  every rank; the backward a scatter-add into the rank's rows).

A mesh's collectives go through a communicator (:class:`MeshComm`, or
``train.within_pod.ThreadComm`` for ranks that are threads of one
process): ``gather(t, axes)``, ``total(t, axis)`` and ``all_to_all``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (batch_axes, decode_layout,
                                              local_shard,
                                              serve_mesh_axes,
                                              serve_row_shards,
                                              serve_stack_shardings)
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models.attention import NEG_INF


def all_gather_dim0(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """[n * rows, ...]: every rank's ``t`` [rows, ...] in rank order."""
    t = t.contiguous()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def row_owner(j: int, n: int) -> int:
    """The model rank that runs batch row ``j`` of ``n`` ranks (see
    :class:`RowLayout`)."""
    return j % n


def local_row_count(B: int, n: int) -> int:
    """Rows each of ``n`` model ranks runs of a ``B``-row batch (see
    :class:`RowLayout`)."""
    return B if n == 1 else max(-(-B // n), min(B, 2))


class RowLayout:
    """The rows of a ``B``-row batch that one model rank runs.

    Row ``j`` belongs to model rank ``j % n`` (so a row's owner does not
    depend on the batch size, which the paged allocator needs), at local
    index ``j // n``.  Every rank runs ``R`` local rows: its own, then pad
    rows that repeat its first real row (or row 0) and whose results are
    dropped.  ``R`` is ``ceil(B / n)``, but at least 2 when ``B >= 2``: a
    one-row product takes another path than a batched one on some
    backends (the CPU's f32 GEMV), and a row must not change its bits
    with the mesh."""

    def __init__(self, B: int, n: int, m: int, device):
        self.B, self.n, self.m = B, n, m
        self.R = local_row_count(B, n)
        self.rows = list(range(m, B, n))
        pad = [self.rows[0] if self.rows else 0] * (self.R - len(self.rows))
        self.sel = torch.as_tensor(self.rows + pad, dtype=torch.int64,
                                   device=device)
        self.valid = torch.arange(self.R, device=device) < len(self.rows)
        # gathered [n * R] rows -> batch order
        order = [row_owner(j, n) * self.R + j // n for j in range(B)]
        self.order = torch.as_tensor(order, dtype=torch.int64, device=device)

    def local_index(self, j: int) -> Optional[int]:
        """Row ``j``'s local index on this rank, None when another rank
        owns it."""
        return j // self.n if row_owner(j, self.n) == self.m else None

    def local(self, t: torch.Tensor, fill=None) -> torch.Tensor:
        """This rank's ``R`` rows of ``t`` [B, ...]; pad rows repeat a
        real row, or hold ``fill`` when given."""
        out = t.index_select(0, self.sel)
        if fill is None or len(self.rows) == self.R:
            return out
        mask = self.valid.reshape((-1,) + (1,) * (t.dim() - 1))
        return torch.where(mask, out, fill)


class ServeComm:
    """One rank's view of a serving mesh: its coordinates, the "expert"
    and "model" sub-groups, and the serving collectives.  An axis of size
    1 issues no collective."""

    def __init__(self, mesh, vocab: int):
        try:
            axes = mesh_axes(mesh)
        except (AttributeError, TypeError):
            axes = {}
        if "expert" not in axes or "model" not in axes:
            raise ValueError("EngineConfig.mesh needs ('expert', 'model') "
                             f"axes (make_serve_mesh); got {tuple(axes)}")
        self.mesh = mesh
        self.n_expert, self.n_model = serve_mesh_axes(mesh)
        self.expert_rank = mesh.get_local_rank("expert")
        self.model_rank = mesh.get_local_rank("model")
        self.expert_group = mesh.get_group("expert")
        self.model_group = mesh.get_group("model")
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        self.vocab = vocab
        # the serve rules cut embed rows and head columns when V divides
        self.vocab_parallel = self.n_model > 1 and vocab % self.n_model == 0
        self._layouts: dict = {}

    @property
    def shape(self) -> dict:
        return {"expert": self.n_expert, "model": self.n_model}

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph may hold this mesh's collectives: NCCL's
        can be captured, gloo's cannot (a gloo mesh runs the decode chunk
        eagerly), and a one-rank mesh issues none."""
        return self.backend == "nccl" or self.n_expert * self.n_model == 1

    # ---- rows (batch-sharded KV along "model") ----
    def rows_for(self, B: int, device) -> Optional[RowLayout]:
        """The row layout of a ``B``-row batch; None where the serve rules
        keep its rows whole (no "model" axis, or a batch that does not
        divide over it): every rank then runs every row."""
        if serve_row_shards(self.mesh, B) == 1:
            return None
        key = (B, torch.device(device).type)   # a rank uses one device
        lay = self._layouts.get(key)
        if lay is None:
            lay = self._layouts[key] = RowLayout(B, self.n_model,
                                                 self.model_rank, device)
        return lay

    def gather_rows(self, x: torch.Tensor, lay: RowLayout) -> torch.Tensor:
        """[R, ...] local rows -> [B, ...] every row, in batch order."""
        out = all_gather_dim0(x, self.model_group, self.n_model)
        return out.index_select(0, lay.order)

    # ---- vocab-parallel embed and head along "model" ----
    def vocab_range(self) -> tuple[int, int]:
        if not self.vocab_parallel:
            return 0, self.vocab
        per = self.vocab // self.n_model
        return self.model_rank * per, (self.model_rank + 1) * per

    def vocab_embed(self, table: torch.Tensor,
                    tokens: torch.Tensor) -> torch.Tensor:
        """Embedding rows of ``tokens`` from a vocab-sharded ``table``
        [V / n, d]: the rank's own ids looked up, zeros elsewhere, summed
        over "model" in f32 (one value and exact zeros per element)."""
        lo, hi = self.vocab_range()
        ids = tokens - lo
        mine = (ids >= 0) & (ids < hi - lo)
        x = table[ids.clamp(0, hi - lo - 1)].to(torch.float32)
        x = torch.where(mine[..., None], x, 0.0)
        dist.all_reduce(x, group=self.model_group)
        return x.to(table.dtype)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """[B, V / n] vocab slices -> [B, V] on every rank."""
        if not self.vocab_parallel:
            return logits
        B = logits.shape[0]
        out = all_gather_dim0(logits, self.model_group, self.n_model)
        return out.reshape((self.n_model,) + tuple(logits.shape)) \
            .movedim(0, -2).reshape(B, -1)

    # ---- expert-parallel slots along "expert" ----
    def reduce_experts(self, t: torch.Tensor) -> torch.Tensor:
        """Sum a delta over "expert" in place (each element has one
        nonzero term, from the shard holding the row's expert)."""
        if self.n_expert > 1:
            dist.all_reduce(t, group=self.expert_group)
        return t

    def slot_range(self, n_slots: int) -> tuple[int, int, int]:
        """(padded slot count, first and past-last slot of this rank): the
        slots' dim 0 cut along the axis the serve rules name for it."""
        (axis,), _ = serve_stack_shardings(self.mesh)
        n, me = mesh_axes(self.mesh)[axis], self.mesh.get_local_rank(axis)
        total = -(-n_slots // n) * n
        per = total // n
        return total, me * per, (me + 1) * per


# ---------------------------------------------------------------------------
# Training and decode meshes: groups over axes, rank-order reductions
# ---------------------------------------------------------------------------


def gather_axes(t: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """[n, *t.shape]: ``t`` of every rank that differs from this one only
    along ``axes`` (n the product of their sizes), row-major in the
    mesh's axis order."""
    sizes = mesh_axes(mesh)
    axes = tuple(a for a in mesh_axes(mesh) if a in axes)
    out = t.contiguous()[None]
    for a in reversed(axes):          # the last axis varies fastest
        if sizes[a] > 1:
            out = all_gather_dim0(out, mesh.get_group(a), sizes[a])
    n = 1
    for a in axes:
        n *= sizes[a]
    return out.reshape((n,) + tuple(t.shape))


def ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """parts [n, ...] summed over dim 0 one after another in f32, in
    index (rank) order."""
    acc = parts[0].to(torch.float32, copy=True)
    for i in range(1, parts.shape[0]):
        acc.add_(parts[i].to(torch.float32))
    return acc


def reduce_scatter_ordered(t: torch.Tensor, dim: int, group,
                           n: int) -> torch.Tensor:
    """This rank's block along ``dim`` (``t`` cut into ``n`` contiguous
    blocks, block ``i`` rank ``i``'s) of the sum of every rank's ``t``,
    in f32 and in rank order: one ``all_to_all`` sends each rank its
    block of ``t``, then :func:`ordered_sum` of the ``n`` copies, so a
    rank receives ``(n - 1) / n`` of ``t`` and holds one copy of it."""
    send = t.movedim(dim, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    del send            # freed before the sum's buffer is taken
    block = recv.reshape((n, recv.shape[0] // n) + tuple(recv.shape[1:]))
    return ordered_sum(block).movedim(0, dim)


def all_reduce_ordered(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum of every rank's ``t`` in f32 and in rank order, the same
    bits on every rank: :func:`reduce_scatter_ordered` of ``t`` flattened
    (zero-padded to a multiple of ``n``), then an all-gather of the
    summed blocks, so a rank receives 2 (n - 1) / n of ``t`` (a gather
    of every rank's ``t`` would receive n - 1 times it)."""
    flat = t.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    mine = reduce_scatter_ordered(flat, 0, group, n)
    out = all_gather_dim0(mine, group, n)
    return out[:t.numel()].reshape(t.shape)


class MeshComm:
    """The collectives of one rank of a ("pod", "data", "model") mesh:
    its axis sizes, its coordinates, and exchanges along axes."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = mesh_axes(mesh)
        self.coords = {a: mesh.get_local_rank(a) for a in self.sizes}

    def gather(self, t: torch.Tensor, axes: tuple) -> torch.Tensor:
        """[n, *t.shape]: ``t`` of the ranks differing along ``axes``."""
        return gather_axes(t, self.mesh, axes)

    def total(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over the ranks along ``axis``, f32, in rank
        order (:func:`all_reduce_ordered`)."""
        return all_reduce_ordered(t, self.mesh.get_group(axis),
                                  self.sizes[axis])

    def all_to_all(self, send: torch.Tensor, to, frm,
                   axis: str) -> torch.Tensor:
        """Row i of ``send`` to the i-th of the ranks ``to`` along ``axis``
        (in rank order) -> what the ranks ``frm`` sent this rank, a row
        each in rank order."""
        n = self.sizes[axis]
        recv = send.new_empty((len(frm),) + tuple(send.shape[1:]))
        dist.all_to_all_single(recv, send.contiguous(),
                               [int(r in frm) for r in range(n)],
                               [int(r in to) for r in range(n)],
                               group=self.mesh.get_group(axis))
        return recv


def combine_partials(o: torch.Tensor, m: torch.Tensor,
                     l: torch.Tensor) -> torch.Tensor:
    """Every shard's flash partials, stacked in rank order (o [n, B, H,
    D], m and l [n, B, H]), combined: the reference's ``flash_combine``
    with its sums taken in rank order."""
    m_g = m.amax(dim=0)
    corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_g))
    l_g = ordered_sum(l * corr)
    o_g = ordered_sum(o * corr[..., None])
    return o_g / torch.clamp_min(l_g[..., None], 1e-30)


def flash_combine(parts, comm, axes: tuple) -> torch.Tensor:
    """Combine flash partials (o [B, H, D] unnormalised, m and l [B, H],
    f32) across the ranks along ``axes``: one all-gather of the three
    through ``comm`` (a :class:`MeshComm`), then :func:`combine_partials`
    in rank order -> [B, H, D] f32, the same bits on every rank."""
    o, m, l = parts
    B, H, D = o.shape
    flat = torch.cat([o.reshape(-1), m.reshape(-1), l.reshape(-1)])
    allp = comm.gather(flat, axes)
    n = allp.shape[0]
    return combine_partials(allp[:, :B * H * D].reshape(n, B, H, D),
                            allp[:, B * H * D:B * H * (D + 1)].reshape(
                                n, B, H),
                            allp[:, B * H * (D + 1):].reshape(n, B, H))


def batch_axes_of(mesh) -> tuple:
    """The batch axes of a mesh inside a pod (without "pod")."""
    return tuple(a for a in batch_axes(mesh) if a != "pod")


def _seq_shards(mesh, global_batch: int) -> tuple[tuple, int]:
    """(sequence axes, their product) of :func:`decode_layout`."""
    _, seq_axes = decode_layout(mesh, global_batch)
    sizes = mesh_axes(mesh)
    n = 1
    for a in seq_axes:
        n *= sizes[a]
    return seq_axes, n


def _seq_index(comm, axes: tuple) -> int:
    """This rank's block over ``axes``, row-major (``comm.coords``)."""
    i = 0
    for a in axes:
        i = i * comm.sizes[a] + comm.coords[a]
    return i


def make_sp_decode_attn(mesh, global_batch: int, cache_len: int, comm=None):
    """Sequence-parallel decode attention for
    :func:`repro_torch.models.transformer.decode_step`'s ``decode_attn``.

    Each rank holds the slice of every attention ring that
    :func:`shard_decode_cache` cut for it (sequence over "model", or over
    every axis when the batch does not divide), with every head.  The
    rank owning ring slot ``cur mod S`` writes the new K/V and position
    into its slice, the others rewrite what they hold, all on the device
    (no host read, so a CUDA graph replays the step); each rank attends
    over its slice, and the partials are combined.  A ring whose length
    (``cache_len``, or a sliding window's) does not divide over the
    sequence shards is kept whole on every rank and runs local attention,
    as in the reference.  ``comm`` (a :class:`MeshComm`, or ranks that
    are threads, ``train.within_pod.ThreadComm``) carries the combine;
    by default the mesh's own."""
    from repro_torch.models.attention import (cache_write, decode_attention,
                                              decode_attention_partial)
    comm = comm if comm is not None else MeshComm(mesh)
    seq_axes, n_seq = _seq_shards(mesh, global_batch)
    me = _seq_index(comm, seq_axes)

    def sp_attn(q, k_new, v_new, st, cur, attn_cfg, start=None):
        S_total = (min(cache_len, attn_cfg.window) if attn_cfg.window
                   else cache_len)
        ck, cv, pos = st["k"], st["v"], st["pos"]
        if S_total % n_seq or n_seq == 1:
            cache_write(ck, cv, pos, k_new, v_new, cur)
            return decode_attention(q, ck, cv, pos, cur, attn_cfg,
                                    start=start).to(q.dtype)
        S_loc = S_total // n_seq
        if ck.shape[1] != S_loc:
            raise ValueError(f"a ring slice of {ck.shape[1]} slots; the "
                             f"layout cuts {S_total} into {n_seq}")
        slot = torch.remainder(cur, S_total).to(torch.int64)
        lo = me * S_loc
        mine = (slot >= lo) & (slot < lo + S_loc)
        lslot = torch.clamp(slot - lo, 0, S_loc - 1).reshape(1)
        for buf, new in ((ck, k_new), (cv, v_new)):
            old = buf.index_select(1, lslot)
            buf.index_copy_(1, lslot, torch.where(mine, new.to(buf.dtype),
                                                  old))
        old = pos.index_select(0, lslot)
        pos.index_copy_(0, lslot, torch.where(mine, cur.reshape(1).to(
            pos.dtype), old))
        parts = decode_attention_partial(q, ck, cv, pos, cur, attn_cfg,
                                         start=start)
        return flash_combine(parts, comm, seq_axes)[:, None].to(q.dtype)

    return sp_attn


def make_sp_cross_attn(mesh, global_batch: int, n_src: int, comm):
    """Sequence-parallel decode cross-attention of an enc-dec decoder:
    ``sp_cross(q, ck, cv, attn_cfg) -> [B, 1, Hq, D]`` in q's dtype.
    Each rank holds its slice of every unit's cross-KV [B, n_src / n, Hkv,
    D], the encoder positions cut as :func:`shard_decode_cache` cuts a
    ring (an ``n_src`` that does not divide stays whole, and attends
    locally); the query attends every position of the slice, with no
    mask and no window (the prefill's non-causal attention), and the
    partials are combined as the self-attention's.  ``comm`` carries the
    combine (as in :func:`make_sp_decode_attn`)."""
    import dataclasses
    from repro_torch.models.attention import (decode_attention_partial,
                                              finalize_partial)
    seq_axes, n_seq = _seq_shards(mesh, global_batch)
    cut = n_seq > 1 and n_src % n_seq == 0
    L = n_src // n_seq if cut else n_src
    lo = _seq_index(comm, seq_axes) * L if cut else 0

    def sp_cross(q, ck, cv, attn_cfg):
        if ck.shape[1] != L:
            raise ValueError(f"a cross-KV slice of {ck.shape[1]} positions; "
                             f"the layout holds {L} of {n_src}")
        pos = torch.arange(lo, lo + L, dtype=torch.int32, device=q.device)
        cur = torch.full((), n_src, dtype=torch.int32, device=q.device)
        parts = decode_attention_partial(
            q, ck, cv, pos, cur, dataclasses.replace(attn_cfg, window=None))
        o = (flash_combine(parts, comm, seq_axes) if cut
             else finalize_partial(*parts))
        return o[:, None].to(q.dtype)

    return sp_cross


def shard_decode_cache(cache: dict, mesh, global_batch: int) -> dict:
    """This rank's part of a dense decode cache that the rank prefilled
    for its batch rows, every leaf placed by
    :func:`repro_torch.distributed.sharding.cache_pspec`
    (:func:`repro_torch.distributed.sharding.cache_placement`): each
    attention ring's K/V and ``pos`` and the encoder's cross-KV keep the
    rank's sequence slice with every head; mamba's ``h`` and ``conv``
    their d_inner slice over "model" when the batch does not divide (the
    long-context layout), else they are kept whole; rwkv's ``S``, ``tm``
    and ``cm`` are kept (the rows are the rank's already, so no batch dim
    is cut again).  A dim that does not divide stays whole (a ring or
    cross-KV so kept attends locally).  ``cur`` and ``start`` are
    kept."""
    from repro_torch import tree as tree_util
    from repro_torch.distributed.sharding import cache_placement
    specs = dict(tree_util.flatten_with_paths(
        cache_placement(cache, mesh, global_batch)))
    out = {}
    for path, t in tree_util.flatten_with_paths(cache):
        spec = list(specs[path])
        if t.dim() > 2:             # [U, B, ...]: the rows are the rank's
            spec[1] = None
        out[path] = local_shard(t, tuple(spec), mesh)
    return tree_util.unflatten_paths(out)


# ---------------------------------------------------------------------------
# The vocab-parallel lookup
# ---------------------------------------------------------------------------


class _VocabLookup(torch.autograd.Function):
    """rows of ``tokens`` from a vocab-cut table: forward the rank's own
    ids looked up (zeros elsewhere), then every rank takes each element
    from the rank owning its id; backward a scatter-add of the incoming
    gradient into the rank's rows, for the ids it owns only."""

    @staticmethod
    def forward(ctx, table, tokens, comm, axis):
        rows = table.shape[0]
        lo = comm.coords[axis] * rows
        ids = tokens.to(torch.int64) - lo
        mine = (ids >= 0) & (ids < rows)
        x = table[ids.clamp(0, rows - 1)]
        x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
        n = comm.sizes[axis]
        allx = comm.gather(x, (axis,))
        owner = torch.clamp(tokens.to(torch.int64) // rows, 0, n - 1)
        out = torch.gather(allx, 0, owner[None, ..., None].expand(
            (1,) + tuple(x.shape)))[0]
        ctx.save_for_backward(ids, mine)
        ctx.rows = rows
        return out

    @staticmethod
    def backward(ctx, g):
        ids, mine = ctx.saved_tensors
        sel = mine.reshape(-1).nonzero()[:, 0]
        grad = torch.zeros((ctx.rows, g.shape[-1]), dtype=g.dtype,
                           device=g.device)
        grad.index_put_((ids.reshape(-1)[sel],),
                        g.reshape(-1, g.shape[-1])[sel], accumulate=True)
        return grad, None, None, None


def make_vp_embed_lookup(mesh, comm=None):
    """The vocab-parallel embedding lookup over "model": ``lookup(table,
    tokens)`` with ``table`` this rank's contiguous block of vocab rows
    (:func:`repro_torch.distributed.sharding.param_pspec` cuts ``embed``
    so when the vocab divides).  Differentiable (:class:`_VocabLookup`).
    A mesh whose "model" axis is 1 looks up plainly.  ``comm`` (as in
    :func:`make_sp_decode_attn`) carries the exchange; by default the
    mesh's own."""
    n_model = (comm.sizes if comm is not None
               else mesh_axes(mesh)).get("model", 1)

    def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        if n_model == 1:
            return table[tokens.to(torch.int64)]
        return _VocabLookup.apply(
            table, tokens, comm if comm is not None else MeshComm(mesh),
            "model")

    return lookup
