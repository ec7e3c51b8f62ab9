"""Paged KV cache of the port: block tables and a free-list allocator.

Port of ``repro/serve/paged_kv.py``.  KV lives in fixed-size blocks drawn
from one pool per attention layer, shared by every row of a wave:

* ``k``/``v`` pools ``[U, NB, BS, Hkv, D]``: ``NB`` blocks of ``BS``
  token slots.  Block 0 is the *trash* block: rows whose budget is spent
  keep stepping with the batch, and their writes go there, where no live
  table points.
* ``tables`` ``[B, MAXB]`` int32, each row's block list (-1
  unallocated): row ``b``'s token at position ``p`` lives in block
  ``tables[b, p // BS]`` at slot ``p % BS``, one table for every layer.
* ``lens`` ``[B]`` int32, each row's write position; ``start`` ``[B]`` its
  first real (non-pad) position; ``active`` ``[B]`` bool, rows still
  generating.

Admission allocates ``ceil((Lp + max_new) / BS)`` blocks and scatters the
row's prefill KV into them, so any prompt length is admissible whenever
enough blocks are free, at any point of the wave.  Prompts are left-padded
to the next block boundary ``Lp`` only; ``start`` masks the pads.  The
allocator lives on the host; the device never sees the free list.

Where the reference updates a donated cache functionally, the port writes
the pools and row vectors **in place** (:func:`insert_prefill_rows`), so a
CUDA graph of the decode chunk reads them at the same addresses from one
wave to the next.

On a serving mesh with a "model" axis of ``n`` ranks, a wave whose rows
the serve rules cut (:func:`repro_torch.distributed.sharding.
serve_row_shards`) has its pool sharded by block: each rank holds a pool
of :func:`shard_pool_blocks` blocks with its own trash block, and the
rows it runs (row ``j`` on rank ``j % n``) take their blocks from it. A
wave whose rows stay whole keeps the whole pool on every rank.
:class:`ShardedBlockAllocator` keeps every shard's free list on every
rank (the host loop is the same on all of them), so each admission
decision is the owner shard's and every rank makes it alike. Logically,
block ``b`` of shard ``k`` is block ``k * NBs + b`` of one pool of ``n *
NBs`` blocks (``NBs`` blocks a shard), which is what a snapshot holds.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import dtype_of

__all__ = ["TRASH_BLOCK", "round_up", "blocks_for", "BlockAllocator",
           "ShardedBlockAllocator", "shard_pool_blocks", "init_paged_cache",
           "insert_prefill_rows"]

# block 0 is never handed out: dead rows' writes are redirected to it and
# gathers of unallocated table entries are clamped onto it (then masked)
TRASH_BLOCK = 0


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def blocks_for(prompt_len: int, max_new: int, block_size: int) -> tuple:
    """(bucketed prompt length Lp, blocks needed for Lp + max_new).

    The prompt is left-padded to the next block boundary; decode then
    writes positions ``Lp .. Lp + max_new - 1``."""
    lp = round_up(max(prompt_len, 1), block_size)
    need = -(-(lp + max_new) // block_size)
    return lp, need


class BlockAllocator:
    """Host free-list allocator over ``n_blocks`` fixed-size blocks.

    Block :data:`TRASH_BLOCK` is reserved.  ``alloc`` is all-or-nothing:
    it returns None (allocating nothing) when fewer than ``n`` blocks are
    free, so admission control is one ``available`` comparison."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError("paged pool needs >= 2 blocks "
                             "(block 0 is reserved)")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free = list(range(n_blocks - 1, 0, -1))  # pop() -> low ids first
        self.peak_in_use = 0

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return (self.n_blocks - 1) - len(self._free)

    n_shards = 1

    def owner(self, j: int) -> int:
        """The shard whose pool serves batch row ``j``: the one pool."""
        return 0

    def available_on(self, shard: int = 0) -> int:
        return len(self._free)

    def alloc(self, n: int, shard: int = 0) -> Optional[list]:
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return out

    def free(self, blocks, shard: int = 0) -> None:
        for b in blocks:
            if not (0 < b < self.n_blocks):
                raise ValueError(f"freeing invalid block id {b}")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
            self._free.append(b)

    def state(self) -> list:
        """The free list in exact order.  ``alloc`` pops from the tail, so
        the order is the future allocation order: restoring it verbatim
        makes block assignment after a resume deterministic."""
        return list(self._free)

    @classmethod
    def from_state(cls, n_blocks: int, block_size: int,
                   free: list) -> "BlockAllocator":
        """Rebuild an allocator from a saved free list."""
        a = cls(n_blocks, block_size)
        ids = [int(b) for b in free]
        if len(set(ids)) != len(ids) or any(
                not (0 < b < n_blocks) for b in ids):
            raise ValueError(f"invalid snapshotted free list: {ids}")
        a._free = ids
        a.peak_in_use = a.in_use
        return a


def shard_pool_blocks(n_blocks: int, n_shards: int, max_blocks: int) -> int:
    """Blocks of one shard's pool, its trash block included: the
    ``n_blocks - 1`` usable blocks of the logical pool split over
    ``n_shards``, rounded up, but never fewer than one row of
    ``max_blocks`` can use of the logical pool, so a request the mesh-free
    pool can place fits its row's shard."""
    if n_shards == 1:
        return n_blocks
    usable = n_blocks - 1
    return max(-(-usable // n_shards), min(usable, max_blocks)) + 1


class ShardedBlockAllocator:
    """One :class:`BlockAllocator` per "model" shard, of ``n_blocks`` each
    (local ids, each shard's block 0 its trash block).  ``alloc``,
    ``free`` and ``available_on`` take the shard; ``in_use`` and
    ``peak_in_use`` count every shard.  :meth:`state` gives the free
    lists in logical ids (block ``b`` of shard ``k`` is ``k * n_blocks +
    b``)."""

    def __init__(self, n_blocks: int, block_size: int, n_shards: int):
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.n_shards = n_shards
        self.shards = [BlockAllocator(n_blocks, block_size)
                       for _ in range(n_shards)]
        self.peak_in_use = 0
        self.shard_peaks = [0] * n_shards

    @property
    def available(self) -> int:
        return sum(a.available for a in self.shards)

    @property
    def in_use(self) -> int:
        return sum(a.in_use for a in self.shards)

    def owner(self, j: int) -> int:
        """The shard whose pool serves batch row ``j`` (the rank that runs
        it, :class:`repro_torch.distributed.collectives.RowLayout`)."""
        from repro_torch.distributed.collectives import row_owner
        return row_owner(j, self.n_shards)

    def available_on(self, shard: int = 0) -> int:
        return self.shards[shard].available

    def alloc(self, n: int, shard: int = 0) -> Optional[list]:
        out = self.shards[shard].alloc(n)
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        self.shard_peaks[shard] = max(self.shard_peaks[shard],
                                      self.shards[shard].in_use)
        return out

    def free(self, blocks, shard: int = 0) -> None:
        self.shards[shard].free(blocks)

    def global_ids(self, blocks, shard: int) -> list:
        return [shard * self.n_blocks + int(b) for b in blocks]

    def state(self) -> list:
        """Every shard's free list in exact order, in logical ids."""
        return [b for k, a in enumerate(self.shards)
                for b in self.global_ids(a.state(), k)]


def init_paged_cache(cfg, batch: int, n_blocks: int, block_size: int,
                     max_blocks: int, dtype=None, device="cuda",
                     mesh=None) -> dict:
    """Empty paged decode state (pure-attention patterns only).

    :func:`repro_torch.models.transformer.decode_step` dispatches on the
    presence of ``"tables"``: it then writes and attends through the
    block tables at per-row positions ``lens`` instead of the dense
    ring's shared ``cur``.  With ``mesh`` (a serving mesh) the state is
    one rank's: where the serve rules cut a ``batch``-row wave's rows
    (:func:`repro_torch.distributed.sharding.serve_row_shards`), the rows
    it runs and its shard of an ``n_blocks`` pool
    (:func:`shard_pool_blocks`); else every row and the whole pool."""
    if mesh is not None:
        from repro_torch.distributed.collectives import local_row_count
        from repro_torch.distributed.sharding import serve_row_shards
        n = serve_row_shards(mesh, batch)
        batch = local_row_count(batch, n)
        n_blocks = shard_pool_blocks(n_blocks, n, max_blocks)
    dtype = dtype or dtype_of(cfg)
    layers = {}
    for i, b in enumerate(cfg.pattern):
        if b.kind != "attn":
            raise ValueError("paged KV covers pure-attention patterns only; "
                             f"block {i} is {b.kind!r}")
        shape = (cfg.n_units, n_blocks, block_size, b.attn.n_kv,
                 b.attn.head_dim)
        layers[f"block{i}"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
        }
    return {
        "layers": layers,
        "tables": torch.full((batch, max_blocks), -1, dtype=torch.int32,
                             device=device),
        "lens": torch.zeros((batch,), dtype=torch.int32, device=device),
        "start": torch.zeros((batch,), dtype=torch.int32, device=device),
        "active": torch.zeros((batch,), dtype=torch.bool, device=device),
    }


def insert_prefill_rows(cache: dict, row_layers: dict, js: torch.Tensor,
                        prompt_blocks: torch.Tensor, row_tables: torch.Tensor,
                        lens_new: torch.Tensor,
                        start_new: torch.Tensor) -> dict:
    """Scatter N freshly prefilled rows into the pooled cache, in place.

    ``row_layers``: ``{block_i: {"k"/"v": [U, N, Lp, Hkv, D]}}``, the row
    caches of a dense prefill at ``cache_len = Lp`` (``Lp`` a multiple of
    the block size, so slot order is position order); ``js`` [N] the batch
    rows being (re)filled; ``prompt_blocks`` [N, Lp // BS] the pool blocks
    receiving the prompt KV; ``row_tables`` [N, MAXB] the rows' whole block
    lists (prompt and decode blocks, -1 padded).  Every tensor of
    ``cache`` keeps its address; ``cache`` is returned."""
    js = js.to(torch.int64)
    flat = prompt_blocks.reshape(-1).to(torch.int64)
    for name, layer in cache["layers"].items():
        for kv in ("k", "v"):
            pool = layer[kv]
            U, _, BS, H, D = pool.shape
            row = row_layers[name][kv]
            pool.index_copy_(1, flat, row.reshape(U, -1, BS, H, D)
                             .to(pool.dtype))
    cache["tables"].index_copy_(0, js, row_tables.to(torch.int32))
    cache["lens"].index_copy_(0, js, lens_new.to(torch.int32))
    cache["start"].index_copy_(0, js, start_new.to(torch.int32))
    cache["active"].index_fill_(0, js, True)
    return cache
