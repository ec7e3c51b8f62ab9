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

The sequence-parallel decode of the reference (``make_sp_decode_attn``,
``flash_combine``, ``decode_attention_partial``) and its production
vocab-parallel lookup come with the within-pod training mesh.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (serve_mesh_axes,
                                              serve_row_shards,
                                              serve_stack_shardings)
from repro_torch.launch.mesh import mesh_axes


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
