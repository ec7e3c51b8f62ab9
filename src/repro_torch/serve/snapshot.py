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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.checkpoint import manager


def write_snapshot(engine, *, rows, experts, cache, tok, cur: int = 0,
                   alloc=None, row_blocks=None) -> str:
    """Commit one engine snapshot at the current chunk boundary.

    Called by the engine's chunk loop right after a chunk's tokens were
    flushed (and journaled), with the post-chunk device state: ``tok`` is
    the pending token the next chunk emits first, which is the restart
    point.  The device-to-host copy comes first, then
    :func:`~repro_torch.checkpoint.manager.save`.  Returns the committed
    directory.
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
    if alloc is not None:
        meta["alloc_free"] = alloc.state()
        meta["row_blocks"] = {str(j): list(b)
                              for j, b in row_blocks.items()}
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
