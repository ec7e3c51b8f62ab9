"""Crash-consistent serving snapshots, written through checkpoint.manager.

Port of ``repro/serve/snapshot.py``, with the same metadata and the same
arrays, so a snapshot written by either package loads in the other.  A
snapshot captures what a resumed engine cannot re-derive cheaply at a
chunk boundary:

* the in-flight wave: the whole KV cache tree (the dense ring's
  ``layers/blockN/{k,v,pos}``, ``cur`` and ``start``, or the paged
  pools with ``tables``, ``lens``, ``start`` and ``active``) and the
  pending ``tok`` [B, 1] (selected, not yet emitted), copied to the host;
* the rows' composition: slot order (uids), the wave's ordered expert
  tuple, each row's emitted-token count, the dense host position
  ``cur``, and on the paged path the allocator's free list (in its exact
  order: the allocation order is part of the determinism contract) and
  each row's blocks;
* the device cache's resident experts (resume prefetches them), the
  cumulative :class:`~repro_torch.serve.expert_cache.SwapStats`, and the
  sampling config whose ``seed`` roots every row's stream (a row's key
  is a pure function of ``(seed, uid)``, so no generator state is kept).

Persistence goes through :func:`repro_torch.checkpoint.manager.save`:
arrays in one npz, metadata in the manifest, and the tmp directory plus
``os.rename`` makes the snapshot atomic.  The engine appends a ``snap``
journal record, and fsyncs, only after the rename returns, so a journal
that names a step always names a complete snapshot.

:meth:`Snapshot.device_state` writes a snapshot back into the engine's
kept buffers in place: a CUDA graph reads those buffers by address, so a
warm engine resumes without a capture.

On a serving mesh a snapshot still holds logical, unsharded arrays: the
ranks gather their rows of the KV (and, paged, their shards of the block
pool, block ``b`` of shard ``k`` becoming block ``k * NBs + b``) and
rank 0 alone writes.  :func:`restore` cuts each rank's rows out of them
into its kept buffers in place, onto any mesh shape or none; a paged
snapshot whose pool layout differs from the engine's has its rows'
blocks allocated anew on their owner shards and copied there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.checkpoint import manager
from repro_torch.distributed.collectives import all_gather_dim0, row_owner
from repro_torch.serve import paged_kv


def _logical(engine, cache: dict, B: int) -> dict:
    """The logical (mesh-free) form of a wave's KV cache tree: every row,
    and on the paged path one pool in logical block ids.  A collective on
    a "model" axis (every rank calls it); the tree itself without one."""
    lay = engine._layout(B)
    if lay is None:
        return cache
    comm = engine.comm

    def rows(t, dim=0):
        return comm.gather_rows(t.movedim(dim, 0).contiguous(),
                                lay).movedim(0, dim)

    out = {"layers": {}}
    paged = "tables" in cache
    for name, layer in cache["layers"].items():
        out["layers"][name] = {}
        for k, t in layer.items():
            if k == "pos":
                out["layers"][name][k] = t
            elif paged:           # the block pool, shards in rank order
                out["layers"][name][k] = all_gather_dim0(
                    t.movedim(1, 0).contiguous(), comm.model_group,
                    comm.n_model).movedim(0, 1)
            else:
                out["layers"][name][k] = rows(t, 1)
    for k, t in cache.items():
        if k == "layers":
            continue
        out[k] = t if t.dim() == 0 else rows(t)
    if paged:
        nbs = next(iter(cache["layers"].values()))["k"].shape[1]  # a shard's
        offset = torch.as_tensor([row_owner(j, lay.n) * nbs
                                  for j in range(B)],
                                 dtype=torch.int32,
                                 device=out["tables"].device)[:, None]
        t = out["tables"]
        out["tables"] = torch.where(t >= 0, t + offset, t)
    return out


def write_snapshot(engine, *, rows, experts, cache, tok, cur: int = 0,
                   alloc=None, row_blocks=None) -> str:
    """Commit one engine snapshot at the current chunk boundary.

    Called by the engine's chunk loop right after a chunk's tokens were
    flushed (and journaled), with the post-chunk device state: ``tok`` is
    the pending token the next chunk emits first, which is the restart
    point.  The device-to-host copy comes first, then
    :func:`~repro_torch.checkpoint.manager.save`.  Returns the committed
    directory.  On a mesh every rank calls it (the logical arrays are
    gathered) and rank 0 alone writes; the others return "".
    """
    step = engine._chunk_idx
    meta = {
        "kind": "serve_snapshot",
        "chunk": step,
        "kv_layout": engine.cfg.kv_layout,
        "experts": list(experts),
        "row_uids": [r.uid for r in rows],
        "row_emitted": {str(r.uid): len(r.out_tokens) for r in rows},
        "cur": int(cur),
        "sampling": engine.cfg.sampling.to_meta(),
        "scheduler": engine.cfg.scheduler,
        "resident": list(engine.cache.resident()),
        "stats": engine.cache.stats.as_dict(),
    }
    if engine.mesh is not None:
        meta["mesh"] = dict(engine.comm.shape)
    if alloc is not None:
        meta["alloc_free"] = alloc.state()
        meta["row_blocks"] = {
            str(j): ([int(x) for x in b] if alloc.n_shards == 1 else
                     alloc.global_ids(b, alloc.owner(j)))
            for j, b in row_blocks.items()}
        meta["kv_shards"] = alloc.n_shards
    cache = _logical(engine, cache, len(rows))
    if not engine._writer():
        return ""
    state = tree_util.tree_map(lambda t: t.to("cpu"),
                               {"cache": cache, "tok": tok})
    path = manager.save(state, engine.cfg.snapshot_dir, step,
                        extra_meta=meta)
    if engine._journal is not None:
        engine._journal.append("snap", {"step": step,
                                        "rows": meta["row_emitted"]},
                               t=engine._now())
        engine._journal.sync()
    return path


@dataclasses.dataclass
class Snapshot:
    """A loaded snapshot: metadata and host tensors."""

    step: int
    meta: dict
    cache: dict                        # nested KV cache tree, on the host
    tok: torch.Tensor                  # [B, 1] pending tokens

    @property
    def row_uids(self) -> list:
        return list(self.meta["row_uids"])

    @property
    def emitted(self) -> dict:
        return {int(u): int(n)
                for u, n in self.meta["row_emitted"].items()}

    def device_state(self, engine) -> dict:
        """Write the wave's KV (ring or pools, with ``cur``, ``start``, or
        ``tables``, ``lens``, ``start``, ``active``) and ``tok`` into
        ``engine``'s kept buffers of this batch size, in place, and return
        those buffers.  No tensor is allocated: the decode graphs read
        them by address.  A snapshot of other shapes or dtypes (another
        ``cache_len``, pool or model) raises ``ValueError``."""
        rows = len(self.row_uids)
        st = (engine._paged_state(rows)
              if self.meta["kv_layout"] == "paged" else engine._state(rows))
        dst = dict(tree_util.flatten_with_paths(
            {"cache": st["cache"], "tok": st["tok"]}))
        src = dict(tree_util.flatten_with_paths(
            {"cache": self.cache, "tok": self.tok}))
        if set(dst) != set(src):
            raise ValueError(f"snapshot step {self.step}: its leaves "
                             f"{sorted(src)} are not the engine's "
                             f"{sorted(dst)}")
        for path, d in dst.items():
            s = src[path]
            if tuple(s.shape) != tuple(d.shape) or s.dtype != d.dtype:
                raise ValueError(
                    f"snapshot step {self.step}: {path} is {s.dtype} "
                    f"{tuple(s.shape)}, the engine's {d.dtype} "
                    f"{tuple(d.shape)}")
            d.copy_(s)
        return st


def load_snapshot(snapshot_dir: str, step: Optional[int] = None
                  ) -> Snapshot:
    """Load a committed snapshot (latest step if unspecified)."""
    manifest, arrays = manager.load_raw(snapshot_dir, step)
    meta = manifest.get("extra")
    if not meta or meta.get("kind") != "serve_snapshot":
        raise ValueError(f"{snapshot_dir} step {manifest['step']}: "
                         "not a serve snapshot")
    tree = tree_util.unflatten_paths(arrays)
    return Snapshot(step=int(manifest["step"]), meta=meta,
                    cache=tree["cache"], tok=tree["tok"])


def restore(snap: Snapshot, engine) -> tuple:
    """Write ``snap``'s wave into ``engine``'s kept buffers in place ->
    (buffers, allocator, row blocks); the last two are None for dense KV.

    Dense KV and a paged snapshot of the engine's own pool layout are
    written as they are (each rank keeps its rows).  Otherwise (a paged
    snapshot of another "model" axis or pool size) each row's blocks are
    allocated anew, in row order, on the shard that runs the row, and its
    blocks' KV is copied there; the row's tokens do not depend on which
    blocks hold it."""
    B = len(snap.row_uids)
    dev = engine.dev
    lay = engine._layout(B)
    meta = snap.meta
    if meta["kv_layout"] != "paged":
        if lay is None:
            return snap.device_state(engine), None, None
        st = engine._state(B)
        cache, src = st["cache"], snap.cache
        for name, layer in cache["layers"].items():
            for k, t in layer.items():
                v = src["layers"][name][k].to(dev)
                t.copy_(v if k == "pos" else
                        lay.local(v.movedim(1, 0)).movedim(0, 1))
        cache["cur"].copy_(src["cur"])
        cache["start"].copy_(lay.local(src["start"].to(dev), fill=0))
        st["tok"].copy_(snap.tok)
        return st, None, None
    pool = next(iter(snap.cache["layers"].values()))["k"].shape[1]
    if (lay is None and meta.get("kv_shards", 1) == 1
            and pool == engine._kv_blocks):
        st = snap.device_state(engine)
        alloc = paged_kv.BlockAllocator.from_state(
            engine._kv_blocks, engine._bs, meta["alloc_free"])
        row_blocks = {int(j): [int(b) for b in bl]
                      for j, bl in meta["row_blocks"].items()}
        return st, alloc, row_blocks
    st = engine._paged_state(B)
    cache, src = st["cache"], snap.cache
    cache["tables"].fill_(-1)
    alloc = engine._new_alloc(B)
    row_blocks = {}
    for j in sorted(int(j) for j in meta["row_blocks"]):
        old = [int(b) for b in meta["row_blocks"][str(j)]]
        new = alloc.alloc(len(old), shard=alloc.owner(j))
        if new is None:
            raise ValueError(f"snapshot step {snap.step}: row {j}'s "
                             f"{len(old)} KV blocks do not fit the engine's "
                             "pool")
        row_blocks[j] = new
        jl = j if lay is None else lay.local_index(j)
        if jl is None:
            continue
        o = torch.as_tensor(old, dtype=torch.int64)
        n = torch.as_tensor(new, dtype=torch.int64, device=dev)
        for name, layer in cache["layers"].items():
            for k, t in layer.items():
                t.index_copy_(1, n, src["layers"][name][k]
                              .index_select(1, o).to(dev, t.dtype))
        cache["tables"][jl, :len(new)] = n.to(torch.int32)
    for k, fill in (("lens", 0), ("start", 0), ("active", False)):
        v = src[k].to(dev)
        cache[k].copy_(v if lay is None else lay.local(v, fill=fill))
    st["tok"].copy_(snap.tok)
    return st, alloc, row_blocks
