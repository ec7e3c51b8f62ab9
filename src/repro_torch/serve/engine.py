"""Multi-expert serving engine of the port: continuous mixed-expert waves
over one shared base, and merge-on-swap.

Port of ``repro/serve/engine.py``.  Requests name an expert.  Under
``scheduling="mixed"`` (the default) a scheduler
(:mod:`repro_torch.serve.scheduler`: ``"fifo"``, ``"priority"`` or
``"affinity"``) takes them into waves of up to
``max_batch`` rows across up to ``max_stack`` distinct experts; a wave
runs prefill and chunked decode against the **base** parameters plus a
zero-merge overlay (the bitplanes of every expert in the wave, contracted
per row by the grouped ternary kernel), so no merged parameters ever
exist.  Prompts are left-padded to the wave's longest, with each row's
first real position masking its pads out of attention.  With
``continuous=True`` (the default) a finished row's slot is refilled in
place while requests are queued: the newcomer's prompt is left-padded to
the wave's position, prefilled as a single row, and its KV, first
position, expert id and first token are copied into the running wave's
row, so it gets the tokens it gets when served alone.

With ``kv_layout="paged"`` the wave's KV lives in block pools
(:mod:`repro_torch.serve.paged_kv`): each row's prompt is left-padded only
to the next block boundary, rows of one bucket are prefilled together and
scattered into their blocks, and an admission allocates the newcomer's
blocks, at any prompt length and any point of the wave, whenever enough
blocks are free.  A wave larger than the pool re-queues its overflow.
Each row decodes at its own position, so the dense path's ``"position"``
and ``"wrap"`` blocks do not exist there; ``"kv_blocks"`` takes their
place.

Decode runs in chunks of ``decode_chunk`` steps with one host read per
chunk (:mod:`repro_torch.serve.decode_loop`), each chunk one CUDA graph
replay on the card; ``decode_chunk=0`` is the eager per-token loop with
one host read per token, the baseline.  Greedy chunked decode gives the
eager loop's tokens, admissions included, at f32; in bf16 on the card an
admission that a chunk boundary places at another wave position than the
eager loop does sees other rope positions, so its stream may part at a
near-tie.  Sampled decoding (``temperature > 0``) draws token ``i`` of a
request on the reference's own threefry stream, keyed by (seed, uid,
``i``) (:mod:`repro_torch.serve.sampling`), so its streams do not depend
on the chunk size or the admission time either.  A graph replays the
chunk's own kernels at its own shapes, so it equals the chunk run eagerly
bitwise.  Everything a graph reads stays at one address for the engine's
life: per batch size a token, expert-id, sampling-key, stream-position
and KV buffer (dense ring or paged pools, block tables and row vectors)
that every prefill and admission writes into; the expert
slots (:class:`~repro_torch.models.delta.SlotOverlay`, ``max_stack`` of
them) that waves and admissions fill by copy; on the merge path one
merged parameter tree that every swap writes into.  So a warm engine
serves a new wave, an admission, another expert set or a swap without a
capture.

Merge-on-swap (``scheduling="grouped"``, the reference's measured
baseline) groups requests by expert in order of first appearance, merges
each expert into the kept tree once (``ExpertRegistry.merged_params`` on
the ``unpack_add_many`` kernel) and serves the group in batches of up to
``max_batch`` with no overlay and no refill.  It is also the mixed
scheduler's fallback for a wave whose experts carry a leaf the overlay
cannot express, and for a model family the overlay does not cover.
:meth:`ServeEngine.merged_ensemble_params` merges several weighted experts
in one sweep per leaf.

Each wave stages the promotions of its experts and of the queued
requests' experts on the registry's prefetch workers (host only), so a
remote fetch overlaps the decode of the wave before.  An expert that a
remote registry cannot promote (:class:`~repro_torch.serve.expert_cache.
ExpertUnavailable`: a dead replica, a quarantine, a blob never
published) fails only its own requests under ``degrade="request"`` (the
default), at wave formation, at admission and on the merge path; the
others serve as if it had not been asked for.  ``degrade="raise"``
propagates the error, and an unknown expert of a local store raises
``KeyError``, as in the reference.

With ``snapshot_dir=`` every :meth:`ServeEngine.run` writes a
write-ahead journal there (:mod:`repro_torch.serve.journal`: the request
manifest, scheduler decisions, admissions and each chunk's tokens,
flushed to the OS at every chunk boundary), and ``snapshot_every_chunks=N``
commits an atomic snapshot of the wave every N chunks
(:mod:`repro_torch.serve.snapshot`).  :meth:`ServeEngine.resume` rebuilds a
killed run from them: rows of the snapshotted wave continue from its KV,
restored into the kept buffers in place (so a warm engine replays its
graphs without a capture), every other unfinished request is served
again from its prompt, and every journaled token must come out again.

With ``mesh=`` (a serving mesh, :func:`repro_torch.launch.mesh.
make_serve_mesh`, axes ("expert", "model")) the engine is one rank of an
SPMD group: every rank runs this host loop on the same requests and holds
its shard as local tensors (:mod:`repro_torch.distributed.sharding`).  The
"expert" axis cuts the expert slots (each rank contracts its own slots and
the deltas are summed over the axis); the "model" axis cuts the embedding
rows and head columns (vocab-parallel, the logits gathered before the
token select) and, where a wave's batch divides over the axis, the KV by
batch rows (row ``j`` on model rank ``j % n``; paged: each rank a shard
of the block pool and its own allocator); a wave that does not divide
runs every row on every rank.  Prefills run every row on every rank and
keep each rank's rows; decode steps run only those.  Every rank selects
the same tokens, so the token streams are the mesh-free engine's.
Under NCCL the decode chunk is one CUDA graph; gloo collectives cannot
be captured, so a gloo mesh runs the chunk eagerly
(``swap_summary()["graph_captures"]`` stays 0).  Rank 0 alone writes the
journal and the snapshots, which hold logical (unsharded) arrays, so a
run resumes onto any mesh shape or none.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from collections import defaultdict, deque
from typing import Any, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.distributed.collectives import ServeComm
from repro_torch.distributed.fault import RecoveryPlan
from repro_torch.distributed.sharding import (local_shard,
                                              serve_param_pspec,
                                              serve_row_shards,
                                              shard_params)
from repro_torch.models.delta import SlotOverlay, plan_overlay
from repro_torch.serve import decode_loop, paged_kv
from repro_torch.serve import journal as journal_mod
from repro_torch.serve import snapshot as snapshot_mod
from repro_torch.serve.decode_loop import SamplingConfig, select_tokens
from repro_torch.serve.expert_cache import (BASE, ExpertRegistry,
                                            ExpertUnavailable, as_registry)
from repro_torch.serve.sampling import row_keys
from repro_torch.serve.scheduler import SCHEDULERS, make_scheduler

PENDING = "pending"
DONE = "done"
FAILED = "failed"

PAD_PROMPT_TOKEN = 1     # left-pad filler; masked out of attention


@dataclasses.dataclass
class Request:
    uid: int
    expert: str
    prompt: Any                # [T] int token ids (tensor, array or list)
    max_new_tokens: int = 8
    out_tokens: list = dataclasses.field(default_factory=list)
    status: str = PENDING
    error: Optional[str] = None
    priority: int = 1          # lower value = more urgent class
    deadline_s: Optional[float] = None   # absolute SLO deadline (EDF tiebreak)
    # engine clock: seconds since run() began (time.monotonic based);
    # t_wall is the one epoch stamp, taken at run(), for external logs
    arrival_s: float = 0.0     # open-loop arrival offset; 0 = already queued
    t_wall: Optional[float] = None       # epoch seconds at arrival
    t_admit_s: Optional[float] = None    # first placed into a wave
    t_first_s: Optional[float] = None    # first token selected
    t_done_s: Optional[float] = None     # generation budget exhausted


@dataclasses.dataclass
class EngineConfig:
    """The reference's fields; values this slice does not serve raise."""
    max_batch: int = 8
    cache_len: int = 128
    device_cache_bytes: Optional[int] = None
    scheduling: str = "mixed"
    max_stack: int = 8
    continuous: bool = True       # refill finished slots mid-wave
    decode_chunk: int = 16        # decode steps per graph; 0 = eager loop
    sampling: SamplingConfig = dataclasses.field(
        default_factory=SamplingConfig)
    degrade: str = "request"
    scheduler: str = "fifo"       # "fifo" | "priority" | "affinity"
    kv_layout: str = "dense"      # "dense" ring | "paged" block pools
    kv_block_size: int = 16       # token positions per KV block (paged)
    # pool blocks, the reserved trash block included; None sizes the pool
    # so that a full batch at cache_len never waits for blocks
    kv_blocks: Optional[int] = None
    # serving mesh (repro_torch.launch.mesh.make_serve_mesh, axes
    # ("expert", "model")): expert slots expert-parallel, embed and head
    # vocab-parallel and KV batch-sharded along "model"; None is one device
    mesh: Optional[Any] = None
    # crash consistency: a directory arms the write-ahead journal of every
    # run() and receives the snapshots; snapshot_every_chunks=N commits one
    # every N chunks (0: the journal only, and resume serves again from
    # the prompts)
    snapshot_dir: Optional[str] = None
    snapshot_every_chunks: int = 0


def _row_mask_ok(mcfg) -> bool:
    """Whether every position of a model lives in attention KV, so that
    left pads can be masked per row (``start``) and KV paged: not with
    recurrent blocks, which take pads into their state, nor with a
    frontend or an encoder, which put other positions ahead of the
    text."""
    return (all(b.kind == "attn" for b in mcfg.pattern)
            and mcfg.frontend is None and not mcfg.cross_attn
            and not mcfg.enc_n_units)


def _check_paged(mcfg, ecfg: EngineConfig) -> None:
    """The reference's conditions for ``kv_layout="paged"``."""
    if not ecfg.decode_chunk:
        raise ValueError("kv_layout='paged' needs the chunked decode loop; "
                         "set decode_chunk > 0")
    if not _row_mask_ok(mcfg):
        raise ValueError("kv_layout='paged' needs a pure-attention "
                         "decoder-only pattern (recurrent blocks and "
                         "frontends keep state outside KV)")
    if ecfg.kv_block_size < 1:
        raise ValueError("kv_block_size must be >= 1")
    for b in mcfg.pattern:
        if b.attn.window is not None and b.attn.window < ecfg.cache_len:
            # a window below cache_len shrinks the dense ring; the paged
            # prefill needs the whole position range resident
            raise ValueError(
                "kv_layout='paged' needs attention windows >= cache_len "
                f"(got window={b.attn.window}, cache_len={ecfg.cache_len})")


class ServeEngine:
    """Engine over an :class:`ExpertRegistry`, on one device or as one
    rank of a serving mesh (``EngineConfig.mesh``).  ``base_params`` is
    the logical tree; on a mesh the engine keeps this rank's shard."""

    def __init__(self, api, base_params: dict,
                 registry: ExpertRegistry, ecfg: EngineConfig):
        if ecfg.scheduling not in ("mixed", "grouped"):
            raise ValueError('scheduling must be "mixed" or "grouped", '
                             f"got {ecfg.scheduling!r}")
        if ecfg.decode_chunk < 0:
            raise ValueError("decode_chunk must be >= 0")
        if ecfg.degrade not in ("request", "raise"):
            raise ValueError('degrade must be "request" or "raise"')
        if ecfg.scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {ecfg.scheduler!r}; "
                             f"expected one of {sorted(SCHEDULERS)}")
        if ecfg.kv_layout not in ("dense", "paged"):
            raise ValueError('kv_layout must be "dense" or "paged", '
                             f"got {ecfg.kv_layout!r}")
        if ecfg.kv_layout == "paged":
            _check_paged(api.cfg, ecfg)
        self._bs = ecfg.kv_block_size
        self._max_blocks = -(-ecfg.cache_len // max(self._bs, 1))
        self._kv_blocks = (ecfg.kv_blocks if ecfg.kv_blocks is not None
                           else ecfg.max_batch * self._max_blocks + 1)
        if ecfg.kv_layout == "paged" and self._kv_blocks < 2:
            raise ValueError("kv_blocks must be >= 2 (block 0 is reserved)")
        if ecfg.snapshot_dir is not None and not ecfg.decode_chunk:
            raise ValueError("snapshot_dir needs the compiled decode loop "
                             "(journal/snapshot commit at chunk "
                             "boundaries); set decode_chunk > 0")
        if ecfg.snapshot_every_chunks < 0:
            raise ValueError("snapshot_every_chunks must be >= 0")
        if ecfg.snapshot_every_chunks and ecfg.snapshot_dir is None:
            raise ValueError("snapshot_every_chunks needs snapshot_dir")
        self.api = api
        self.mesh = ecfg.mesh
        self.comm = None
        self._logical_base = base_params
        if self.mesh is not None:
            # checks the axes; vocab-parallel embed / lm_head, everything
            # else replicated (a contraction-dim cut would reorder sums)
            self.comm = ServeComm(self.mesh, api.cfg.vocab)
            base_params = shard_params(base_params, self.mesh)
        self.base = base_params
        self.registry = as_registry(registry, base_params["embed"].device)
        self.cfg = ecfg
        self.dev = self.registry.dev
        if base_params["embed"].device.type != self.dev.type:
            raise ValueError(f"base params lie on {base_params['embed'].device}"
                             f" but the registry serves on {self.dev}")
        self.cache = self.registry.device(ecfg.device_cache_bytes,
                                          mesh=self.mesh)
        # None: a family outside the overlay, served by merge-on-swap
        self._plan = plan_overlay(self._logical_base, api.cfg)
        self._slots: Optional[SlotOverlay] = None   # made at the first wave
        self._states: dict[int, dict] = {}          # batch rows -> buffers
        self._paged_states: dict[int, dict] = {}    # the same, paged KV
        self._merged_name: Optional[str] = None
        self._merged_params: Optional[dict] = None  # made at the first swap
        self._chunker = (decode_loop.make_decode_chunk(
            api, ecfg.decode_chunk, ecfg.sampling, comm=self.comm)
            if ecfg.decode_chunk else None)
        self._chunk_fn = self._chunker
        self._t0 = time.monotonic()
        self.wave_log: list[dict] = []       # mixed waves
        self.batch_log: list[dict] = []      # merge-path batches
        # bounded rings: a long-lived engine must not grow host memory
        # with its own accounting; evictions are counted per ring
        # (swap_summary()["log_dropped"]), and failed_total survives them.
        # wave_log stays a list (callers slice it): its count stays 0
        self.swap_log: deque = deque(maxlen=512)   # merges, with seconds
        self.failed_log: deque = deque(maxlen=1024)
        self.failed_total = 0
        self._log_dropped = {"swap": 0, "wave": 0, "failed": 0}
        self._sched = None                   # the last run's scheduler
        self._adm_wait: dict[int, list] = defaultdict(list)  # by priority
        self._kv_in_use = 0                  # pool blocks in use (paged)
        self._kv_peak = 0
        # crash consistency (serve/journal.py, serve/snapshot.py)
        self._journal = None                 # JournalWriter while run() lives
        self._journaling = False             # every rank: run() journals
        self._chunk_idx = 0                  # global chunk count = snap step
        self.chunk_hooks: list = []          # called (chunk_idx) after a flush
        self._recovery_t0: Optional[float] = None
        self.recovery_stats: dict = {}
        self.resumed_requests: list = []

    # ---------------- merged parameters ----------------

    def _params_for(self, expert: str) -> dict:
        """Merge-on-swap: the full merged params of one expert (the base
        itself for ``BASE``), written into the engine's one merged tree.
        The last merged expert is memoised; every merge lands in
        ``swap_log`` with its seconds."""
        if expert == BASE:
            return self.base
        if self._merged_name == expert:
            return self._merged_params
        t0 = time.monotonic()
        if self._merged_params is None:
            self._merged_params = tree_util.tree_map(torch.empty_like,
                                                     self.base)
        self._merged_name = None             # the tree is rewritten below
        self.registry.merged_params(self._logical_base, [expert],
                                    out=self._merged_params, cut=self._cut)
        self._sync()
        self._merged_name = expert
        self._ring_append("swap", {"expert": expert,
                                   "seconds": time.monotonic() - t0})
        return self._merged_params

    def merged_ensemble_params(self, experts: list[str],
                               weights: Optional[list[float]] = None
                               ) -> dict:
        """Merged-ensemble mode: W_base + sum_e w_e * Delta_e in one sweep
        per leaf (``unpack_add_many``), bitwise equal to applying the
        weight-scaled experts one at a time.  On a mesh: this rank's shard
        of the merged tree."""
        return self.registry.merged_params(self._logical_base, experts,
                                           weights, cut=self._cut)

    def _cut(self, path: str, leaf: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a logical leaf (the leaf on one device)."""
        if self.mesh is None:
            return leaf
        return local_shard(leaf, serve_param_pspec(path, tuple(leaf.shape),
                                                   self.mesh), self.mesh)

    # ---------------- expert slots ----------------

    def _overlay_for(self, experts: tuple) -> Optional[dict]:
        """The zero-merge overlay with every expert of ``experts`` in a
        slot (:meth:`slot_of` gives the slot a row's expert id names), or
        None when a member carries a leaf the overlay cannot express (the
        wave then merges).  An unknown expert raises ``KeyError``."""
        if self._slots is None:
            self._slots = SlotOverlay(self._plan, self.cfg.max_stack,
                                      self.dev, comm=self.comm)
            self.cache.slots = self._slots     # the per-shard gauges
        held = sum(self._slots.slot_of(n) is not None
                   for n in dict.fromkeys(experts))
        fills = self._slots.fills
        overlay = self._slots.place(experts, self.registry.fetch_packed)
        if overlay is not None:
            self.cache.stats.stack_hits += held
            self.cache.stats.stack_builds += self._slots.fills - fills
        return overlay

    def slot_of(self, expert: str) -> int:
        """The slot (expert id) of an expert placed by
        :meth:`_overlay_for`."""
        return self._slots.slot_of(expert)

    # ---------------- kept buffers ----------------

    def _row_buffers(self, rows: int, cache: dict) -> dict:
        return {"tok": torch.zeros((rows, 1), dtype=torch.int32,
                                   device=self.dev),
                "eid": torch.zeros((rows,), dtype=torch.int32,
                                   device=self.dev),
                "keys": torch.zeros((rows, 2), dtype=torch.int64,
                                    device=self.dev),
                "gen": torch.zeros((rows,), dtype=torch.int64,
                                   device=self.dev),
                "cache": cache}

    def _state(self, rows: int) -> dict:
        """The pending-token, expert-id, sampling-key, stream-position and
        KV buffers of a batch of ``rows``, made once and rewritten by every
        prefill and admission (a CUDA graph reads them by address)."""
        st = self._states.get(rows)
        if st is None:
            lay = self._layout(rows)
            local = rows if lay is None else lay.R      # this rank's rows
            cache = self.api.init_decode_cache(local, self.cfg.cache_len,
                                               device=self.dev)
            cache["start"] = torch.zeros((local,), dtype=torch.int32,
                                         device=self.dev)
            st = self._states[rows] = self._row_buffers(rows, cache)
        return st

    def _paged_state(self, rows: int) -> dict:
        """:meth:`_state` for paged KV: the block pools, ``tables``,
        ``lens``, ``start`` and ``active`` of ``rows`` rows, made once per
        row count and reset in place at each wave."""
        st = self._paged_states.get(rows)
        if st is None:
            cache = paged_kv.init_paged_cache(
                self.api.cfg, rows, self._kv_blocks, self._bs,
                self._max_blocks, device=self.dev, mesh=self.mesh)
            st = self._paged_states[rows] = self._row_buffers(rows, cache)
        return st

    def _layout(self, rows: int):
        """The row layout of a ``rows``-row wave on this rank (None: every
        rank holds every row)."""
        return (self.comm.rows_for(rows, self.dev)
                if self.comm is not None else None)

    def _row_shards(self, rows: int) -> int:
        """The "model" shards a ``rows``-row wave's rows are cut into (1:
        every rank runs every row)."""
        return serve_row_shards(self.mesh, rows) if self.mesh is not None \
            else 1

    def _new_alloc(self, rows: int):
        """A fresh host allocator over the pool of a ``rows``-row wave: one
        per "model" shard where the serve rules cut the wave's rows (row
        ``j``'s blocks from ``alloc.owner(j)``), else the one pool."""
        n = self._row_shards(rows)
        if n > 1:
            return paged_kv.ShardedBlockAllocator(
                paged_kv.shard_pool_blocks(self._kv_blocks, n,
                                           self._max_blocks), self._bs, n)
        return paged_kv.BlockAllocator(self._kv_blocks, self._bs)

    def _place_wave(self, wave: list) -> tuple:
        """Allocate each request's blocks in wave order, on its row's
        shard -> (allocator, row -> blocks, the requests that fit).  When
        the requests that fit are fewer and the serve rules cut a wave of
        that size otherwise, they are placed again under its layout (the
        set only shrinks, so this ends)."""
        while True:
            alloc = self._new_alloc(len(wave))
            row_blocks: dict[int, list] = {}
            kept = []
            for r in wave:
                _, need = paged_kv.blocks_for(len(r.prompt),
                                              r.max_new_tokens, self._bs)
                blocks = alloc.alloc(need, shard=alloc.owner(len(kept)))
                if blocks is not None:
                    row_blocks[len(kept)] = blocks
                    kept.append(r)
            if (len(kept) == len(wave) or not kept
                    or self._row_shards(len(kept)) == alloc.n_shards):
                return alloc, row_blocks, kept
            wave = kept

    def _free_rows(self, alloc, row_blocks: dict, js) -> None:
        for j in list(js):
            if j in row_blocks:
                alloc.free(row_blocks.pop(j), shard=alloc.owner(j))
        self._kv_in_use = alloc.in_use

    # ---------------- engine clock ----------------

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _mark_admitted(self, reqs: list[Request]) -> None:
        now = self._now()
        for r in reqs:
            if r.t_admit_s is None:
                r.t_admit_s = now
                self._adm_wait[r.priority].append(now - r.arrival_s)

    def _mark_first(self, reqs: list[Request]) -> None:
        now = self._now()
        for r in reqs:
            if r.t_first_s is None and r.max_new_tokens > 0:
                r.t_first_s = now

    def _mark_done(self, r: Request) -> None:
        if r.t_done_s is None and len(r.out_tokens) >= r.max_new_tokens:
            r.t_done_s = self._now()

    # ---------------- serving loop ----------------

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def run(self, requests: list[Request],
            scheduling: Optional[str] = None) -> list[Request]:
        """Serve every request to its budget; tokens land in
        ``Request.out_tokens``.  ``scheduling`` ("mixed" or "grouped")
        overrides ``cfg.scheduling`` for this run.  With ``snapshot_dir``
        the run is journaled (and snapshotted) there."""
        mode = scheduling or self.cfg.scheduling
        if mode not in ("mixed", "grouped"):
            raise ValueError('scheduling must be "mixed" or "grouped", '
                             f"got {mode!r}")
        self._t0 = time.monotonic()      # engine clock zero for arrivals
        wall = time.time()               # the one epoch stamp per run
        for r in requests:
            if r.t_wall is None:
                r.t_wall = wall + r.arrival_s
        self._open_journal(requests, mode)
        try:
            pending = [r for r in requests if r.status == PENDING]
            if mode == "grouped" or self._plan is None:
                self._run_grouped(pending)
            else:
                self._run_mixed(pending)
            for r in requests:
                if r.status == PENDING:
                    r.status = DONE
            self._journal_append("run_end", {"requests": len(requests)},
                                 flush=True)
        finally:
            self._close_journal()
        self._export_gauges()
        return requests

    # ---------------- write-ahead journal ----------------

    def _journal_append(self, kind: str, data: dict,
                        flush: bool = False) -> None:
        if self._journal is not None:
            self._journal.append(kind, data, t=self._now())
            if flush:
                self._journal.flush()

    def _journal_admit(self, r: Request, j: int) -> None:
        self._journal_append("admit", {
            "uid": r.uid, "expert": r.expert, "slot": j,
            "arrival_s": r.arrival_s, "prompt_len": len(r.prompt)})

    def _run_meta(self, requests: list[Request], mode: str) -> dict:
        """The ``run_start`` record: everything needed to rebuild every
        request from the journal alone, prompts included (a resumed
        process has no other source for them)."""
        return {
            "sampling": self.cfg.sampling.to_meta(),
            "scheduler": self.cfg.scheduler,
            "scheduling": mode,
            "kv_layout": self.cfg.kv_layout,
            "decode_chunk": self.cfg.decode_chunk,
            "max_batch": self.cfg.max_batch,
            "cache_len": self.cfg.cache_len,
            "wall": time.time(),
            "requests": [{
                "uid": r.uid, "expert": r.expert,
                "prompt": [int(t) for t in
                           torch.as_tensor(r.prompt).reshape(-1).tolist()],
                "max_new": r.max_new_tokens, "priority": r.priority,
                "deadline_s": r.deadline_s, "arrival_s": r.arrival_s,
                "t_wall": r.t_wall,
            } for r in requests],
        }

    def _writer(self) -> bool:
        """Whether this rank writes the journal and the snapshots (rank 0
        of a mesh; the only rank without one)."""
        return self.comm is None or self.comm.rank == 0

    def _open_journal(self, requests: list[Request], mode: str) -> None:
        if self.cfg.snapshot_dir is None:
            return
        self._journaling = True
        if not self._writer():
            return
        path = os.path.join(self.cfg.snapshot_dir, journal_mod.JOURNAL_NAME)
        self._journal = journal_mod.JournalWriter(path, fresh=True)
        self._journal.append("run_start", self._run_meta(requests, mode))
        self._journal.sync()

    def _close_journal(self) -> None:
        self._journaling = False
        if self._journal is not None:
            self._journal.close()
            self._journal = None

    # ---------------- kill-restart recovery ----------------

    def resume(self) -> list[Request]:
        """Recover a killed run from ``snapshot_dir``'s journal (and its
        latest snapshot, if any) and serve it to completion.

        1. Replay the journal: which requests existed, what each had
           emitted, which finished or failed (no ``run_end``: a crash).
        2. Restore the last snapshot's wave (KV and pending tokens at a
           chunk boundary, the paged allocator's free list) into the
           kept buffers and continue it.
        3. Serve every other unfinished request again from its prompt (its
           KV postdates the snapshot, or it was never admitted): its
           stream is keyed by (seed, uid), so it regenerates.

        Every journaled token must come out again
        (:meth:`_verify_journal_prefix` raises otherwise).  Experts are
        fetched through the registry's tiers; an unavailable one fails
        its requests as in a live run.  The resumed run writes no journal
        and no snapshot.  Returns the rebuilt requests (also in
        ``resumed_requests``); ``recovery_stats`` holds ``resume_seconds``,
        ``first_resumed_token_s`` and the
        :class:`~repro_torch.distributed.fault.RecoveryPlan`.
        """
        cfg = self.cfg
        if cfg.snapshot_dir is None:
            raise ValueError("resume() needs EngineConfig.snapshot_dir")
        if self._plan is None:
            # as in the reference: a merge-on-swap run is journaled, not
            # resumed
            raise ValueError("resume() supports the mixed overlay path "
                             "only (this model family is not coverable; "
                             "merge-on-swap runs do not resume, ROADMAP "
                             "queue 1, item 9)")
        if self.comm is not None:
            # rank 0 may still be writing the crashed run's last records
            torch.distributed.barrier()
        t_resume0 = time.monotonic()
        self._recovery_t0 = t_resume0
        self.recovery_stats = {}
        state = journal_mod.replay(os.path.join(cfg.snapshot_dir,
                                                journal_mod.JOURNAL_NAME))
        meta = state.meta
        if SamplingConfig.from_meta(meta["sampling"]) != cfg.sampling:
            raise ValueError(
                "resume(): sampling mismatch — journaled "
                f"{meta['sampling']}, engine {cfg.sampling.to_meta()}; "
                "token streams would diverge")
        if meta.get("scheduling") == "grouped":
            raise ValueError("resume() supports mixed scheduling only")
        if meta["scheduler"] != cfg.scheduler:
            raise ValueError(f"resume(): scheduler mismatch — journaled "
                             f"{meta['scheduler']!r}, engine "
                             f"{cfg.scheduler!r}")
        if meta["kv_layout"] != cfg.kv_layout:
            raise ValueError(f"resume(): kv_layout mismatch — journaled "
                             f"{meta['kv_layout']!r}, engine "
                             f"{cfg.kv_layout!r}")
        snap = None
        if state.snapshots:
            snap = snapshot_mod.load_snapshot(
                cfg.snapshot_dir, int(state.snapshots[-1]["step"]))

        # every request from the run_start manifest, then the journaled
        # facts (tokens, terminal states)
        requests = [Request(
            uid=int(d["uid"]), expert=d["expert"],
            prompt=torch.as_tensor(d["prompt"], dtype=torch.int32),
            max_new_tokens=int(d["max_new"]),
            priority=int(d.get("priority", 1)),
            deadline_s=d.get("deadline_s"),
            arrival_s=float(d.get("arrival_s", 0.0)),
            t_wall=d.get("t_wall")) for d in meta["requests"]]
        by_uid = {r.uid: r for r in requests}
        snap_uids = set(snap.row_uids) if snap is not None else set()
        reserve: list[Request] = []
        for r in requests:
            toks = state.tokens.get(r.uid, [])
            if r.uid in state.failed:
                r.status, r.error = FAILED, state.failed[r.uid]
                r.out_tokens = list(toks)
            elif len(toks) >= r.max_new_tokens:
                r.status = DONE
                r.out_tokens = list(toks[:r.max_new_tokens])
            elif r.uid in snap_uids:
                # continues from the restored KV; the tokens past the
                # snapshot regenerate (checked against the journal below)
                r.out_tokens = list(toks[:snap.emitted[r.uid]])
            else:
                # admitted after the snapshot, or never: served again from
                # its prompt
                r.out_tokens = []
                reserve.append(r)

        self._t0 = time.monotonic()        # the resumed run's clock zero
        sched = make_scheduler(cfg.scheduler)
        self._sched = sched
        if cfg.kv_layout == "paged":
            self._validate_paged(reserve)
        for r in reserve:
            if r.status == PENDING:
                # arrivals count from the original clock zero; anything
                # due at the crash is due now
                r.arrival_s = max(0.0, r.arrival_s - state.last_t)
                sched.push(r)
        if snap is not None:
            resident = [n for n in snap.meta.get("resident", ())
                        if n != BASE]
            if resident:
                try:          # warm the device cache; opportunistic
                    self.registry.prefetch(resident)
                except ExpertUnavailable:
                    pass
        continued = demoted = 0
        if snap is not None and any(by_uid[u].status == PENDING
                                    for u in snap_uids):
            continued, demoted = self._resume_wave(snap, by_uid, sched)
        self._drain(sched)
        for r in requests:
            if r.status == PENDING:
                r.status = DONE
        self._verify_journal_prefix(requests, state)
        self.recovery_stats.update({
            "resume_seconds": time.monotonic() - t_resume0,
            "plan": RecoveryPlan(
                snapshot_step=snap.step if snap is not None else None,
                journal_records=state.n_records,
                replayed_rows=continued,
                reprefilled_rows=len(reserve) + demoted)})
        self._recovery_t0 = None
        self.resumed_requests = requests
        self._export_gauges()
        return requests

    def _resume_wave(self, snap, by_uid: dict, sched) -> tuple:
        """Restore the snapshotted wave (KV, pending tokens, rows, paged
        allocator) into the kept buffers and run it to its end through
        the chunk loop, refilling its slots from ``sched``.  The snapshot
        was taken before the refills of its chunk boundary, so the wave
        refills before its first chunk, as the interrupted run did: the
        resumed run then repeats its schedule (the same admissions at the
        same wave positions and the same graphs; the reference launches a
        chunk first).  Returns
        (continued, demoted) row counts: when an expert of the wave
        cannot be fetched, its rows fail and every other unfinished row
        is demoted to a serve from its prompt."""
        t0, g0 = time.monotonic(), self._graph_counts()
        experts = list(snap.meta["experts"])
        live = [u for u in snap.row_uids if by_uid[u].status == PENDING]
        try:
            overlay = self._overlay_for(tuple(experts))
        except ExpertUnavailable as e:
            demoted = 0
            for u in live:
                r = by_uid[u]
                if r.expert == e.name:
                    self._fail([r], e)
                else:
                    r.out_tokens = []
                    sched.push(r)
                    demoted += 1
            return 0, demoted
        if overlay is None:
            raise RuntimeError("resume(): snapshotted wave is not "
                               "coverable by the zero-merge overlay")
        rows = [by_uid[u] for u in snap.row_uids]
        self._mark_admitted(rows)
        # the expert ids are this engine's slots, not the writer's order
        slot = {e: self.slot_of(e) for e in experts}
        st, alloc, row_blocks = snapshot_mod.restore(snap, self)
        st["eid"].copy_(torch.as_tensor([slot[r.expert] for r in rows],
                                        dtype=torch.int32))
        st["keys"].copy_(self._keys(rows))
        cur = int(snap.meta["cur"])
        if self.cfg.kv_layout == "paged":
            self._kv_in_use = alloc.in_use
            self._kv_peak = max(self._kv_peak, alloc.peak_in_use)
            try:
                admitted, chunks = self._chunk_loop(
                    rows, experts, slot, overlay, st, sched, cur,
                    alloc=alloc, row_blocks=row_blocks, restored=True)
            finally:
                self._free_rows(alloc, row_blocks, list(row_blocks))
                assert alloc.in_use == 0, (
                    f"paged KV leak on resume: {alloc.in_use} blocks "
                    "still allocated at wave teardown")
        else:
            admitted, chunks = self._chunk_loop(rows, experts, slot,
                                                overlay, st, sched, cur,
                                                restored=True)
        self.wave_log.append(self._log(t0, g0, rows, admitted, chunks, cur,
                                       0.0, experts=len(experts),
                                       resumed=True))
        return len(live), 0

    @staticmethod
    def _verify_journal_prefix(requests: list[Request], state) -> None:
        """Every journaled token must be a prefix of the resumed stream: a
        mismatch means the restored state or the refetched experts
        diverged, and the resume must fail loudly rather than return other
        tokens."""
        for r in requests:
            if r.status == FAILED:
                continue
            pre = [int(t) for t in
                   state.tokens.get(r.uid, [])][:r.max_new_tokens]
            got = [int(t) for t in r.out_tokens[:len(pre)]]
            if got != pre:
                raise RuntimeError(
                    f"resume(): request {r.uid} diverged from the "
                    f"journal (journaled {pre[:8]}, regenerated "
                    f"{got[:8]})")

    # ---------------- graceful degradation ----------------

    def _fail(self, reqs: list[Request], err: Exception) -> None:
        """Terminal per-request failure.  ``degrade="request"`` marks only
        ``reqs`` FAILED, with the error attached, and the rest of the wave
        proceeds; ``degrade="raise"`` propagates ``err``."""
        if self.cfg.degrade != "request":
            raise err
        for r in reqs:
            r.status, r.error = FAILED, str(err)
            self.failed_total += 1
            self._ring_append("failed", {"uid": r.uid, "expert": r.expert,
                                         "error": str(err)})
            self._journal_append("fail", {"uid": r.uid, "expert": r.expert,
                                          "error": str(err)}, flush=True)

    def _ring_append(self, name: str, item: dict) -> None:
        """Append to one of the bounded logs, counting evictions."""
        ring = getattr(self, f"{name}_log")
        if getattr(ring, "maxlen", None) is not None \
                and len(ring) == ring.maxlen:
            self._log_dropped[name] += 1
        ring.append(item)

    def _prefetch_upcoming(self, upcoming, extra=()) -> None:
        """Admission-time prefetch: stage promotions for every distinct
        expert of the queued requests ``upcoming`` (bounded lookahead),
        plus ``extra`` (the wave about to be served, so its cold fetches
        run concurrently), while the current wave decodes."""
        names = list(dict.fromkeys(extra))
        seen = set(names)
        for r in itertools.islice(upcoming, 0, 4 * self.cfg.max_batch):
            if r.expert not in seen:
                seen.add(r.expert)
                names.append(r.expert)
        if names:
            self.registry.prefetch(names)

    def _validate_paged(self, requests: list[Request]) -> None:
        """A request that can never be placed (more blocks than the whole
        pool, or more positions than a row's table) fails terminally
        instead of blocking the queue."""
        for r in requests:
            lp, need = paged_kv.blocks_for(len(r.prompt), r.max_new_tokens,
                                           self._bs)
            if (lp + r.max_new_tokens > self._max_blocks * self._bs
                    or need > min(self._max_blocks, self._kv_blocks - 1)):
                self._fail([r], ValueError(
                    f"request {r.uid} needs {need} KV blocks "
                    f"({lp}+{r.max_new_tokens} positions); pool holds "
                    f"{self._kv_blocks - 1} usable blocks of {self._bs} "
                    f"with {self._max_blocks} per row"))

    def _run_mixed(self, requests: list[Request]) -> None:
        if self.cfg.kv_layout == "paged":
            self._validate_paged(requests)
        sched = make_scheduler(self.cfg.scheduler)
        self._sched = sched
        sched.on_decision = lambda d: self._journal_append("sched", d)
        for r in requests:
            if r.status == PENDING:
                sched.push(r)
        self._drain(sched)

    def _drain(self, sched) -> None:
        """Serve the scheduler dry: build waves, serve them, honour future
        arrivals.  A wave the overlay cannot express is served by
        merge-on-swap."""
        while sched.pending():
            sched.release(self._now())
            if not sched.ready_count():
                nxt = sched.next_arrival()
                if nxt is None:
                    break
                # open-loop idle: sleep toward the next arrival (bounded,
                # so a clock hiccup never wedges the loop)
                time.sleep(min(max(nxt - self._now(), 0.0), 0.05))
                continue
            wave, experts = sched.take_wave(self.cfg.max_batch,
                                            self.cfg.max_stack)
            if not wave:
                continue
            self._prefetch_upcoming(sched.peek(4 * self.cfg.max_batch),
                                    extra=experts)
            overlay = None
            while wave:
                try:
                    overlay = self._overlay_for(tuple(experts))
                    break
                except ExpertUnavailable as e:
                    # drop the dead expert's rows from the wave and place
                    # the rest; an unknown expert of a local store
                    # (KeyError) propagates, as in the reference
                    hit = [r for r in wave if r.expert == e.name]
                    if not hit:
                        raise    # not from this wave: don't loop forever
                    self._fail(hit, e)
                    wave = [r for r in wave if r.expert != e.name]
                    experts = [x for x in experts if x != e.name]
            if not wave:
                continue
            if overlay is None:
                self._run_grouped(wave)
                continue
            if self.cfg.kv_layout == "paged":
                self._serve_wave_paged(wave, experts, overlay, sched)
            elif self.cfg.decode_chunk:
                self._serve_wave_chunked(wave, experts, overlay, sched)
            else:
                self._serve_wave_eager(wave, experts, overlay, sched)

    def _run_grouped(self, requests: list[Request]) -> None:
        """Merge-on-swap: group by expert in order of first appearance,
        merge each expert once, serve its group in batches of up to
        ``max_batch``."""
        groups: dict[str, list[Request]] = {}
        for r in requests:
            groups.setdefault(r.expert, []).append(r)
        order = list(groups)
        for gi, expert in enumerate(order):
            group = groups[expert]
            if gi + 1 < len(order):
                # overlap the next group's cold fetch with this group's
                # merge and decode steps
                self.registry.prefetch([order[gi + 1]])
            try:
                params = self._params_for(expert)
            except ExpertUnavailable as e:
                # one dead expert fails its group; every other group serves
                self._fail(group, e)
                continue
            for i in range(0, len(group), self.cfg.max_batch):
                self._serve_batch(params, group[i:i + self.cfg.max_batch],
                                  expert)

    def _pad_prompts(self, reqs: list[Request], width: int = 0):
        """Left-pad prompts to one width (the longest, or ``width``) ->
        (tokens [B, T] int64, start [B] int32, each row's first real
        position)."""
        prompts = [torch.as_tensor(r.prompt, dtype=torch.int64).reshape(-1)
                   for r in reqs]
        T = width or max(int(p.numel()) for p in prompts)
        toks = torch.full((len(reqs), T), PAD_PROMPT_TOKEN, dtype=torch.int64)
        for j, p in enumerate(prompts):
            toks[j, T - p.numel():] = p
        start = torch.as_tensor([T - int(p.numel()) for p in prompts],
                                dtype=torch.int32)
        return toks.to(self.dev), start.to(self.dev)

    def _prefill(self, params: dict, overlay: Optional[dict],
                 reqs: list[Request], slots: Optional[list[int]]):
        """Prefill a batch into the kept buffers of its size (expert ids
        ``slots`` with the overlay, none on the merge path) and select
        each row's first token.  Returns (buffers, padded prompt length:
        the host's mirror of the wave position)."""
        st = self._state(len(reqs))
        toks, start = self._pad_prompts(reqs)
        eid = None
        if slots is not None:
            st["eid"].copy_(torch.as_tensor(slots, dtype=torch.int32))
            eid = st["eid"]
        batch = {"tokens": toks, **self._frontend_stub(len(reqs))}
        logits, _ = self.api.prefill(params, batch, self.cfg.cache_len,
                                     delta=overlay, eid=eid,
                                     start=start if _row_mask_ok(self.api.cfg)
                                     else None, cache=st["cache"],
                                     comm=self.comm, shard_rows=True)
        st["keys"].copy_(self._keys(reqs))
        st["gen"].zero_()
        st["tok"].copy_(self._select(logits, st))
        return st, int(toks.shape[1])

    def _frontend_stub(self, rows: int) -> dict:
        """A frontend family's stub modality input for ``rows`` rows, as
        the reference's merge path feeds it: zero ``frames`` (audio) or
        ``mm_embeds`` (vision) of [rows, n_tokens, embed_dim] f32."""
        fe = self.api.cfg.frontend
        if fe is None:
            return {}
        key = "frames" if self.api.cfg.family == "audio" else "mm_embeds"
        return {key: torch.zeros((rows, fe.n_tokens, fe.embed_dim),
                                 dtype=torch.float32, device=self.dev)}

    def _keys(self, reqs: list[Request]) -> torch.Tensor:
        """Per-request sampling keys [B, 2] (host), from (seed, uid)."""
        return row_keys(self.cfg.sampling.seed, [r.uid for r in reqs])

    def _select(self, logits, st: dict,
                j: Optional[int] = None) -> torch.Tensor:
        """The next token [B, 1] from last-position logits, each row drawn
        under its kept key at its kept ``gen``; row ``j`` alone if given."""
        rows = slice(None) if j is None else slice(j, j + 1)
        return select_tokens(logits[:, -1], st["keys"][rows],
                             st["gen"][rows], self.cfg.sampling,
                             self.comm)[:, None]

    def _set_gen(self, st: dict, rows: list[Request], pending: int) -> None:
        """Each row's stream position for its next draw: the tokens it has
        emitted, plus ``pending`` (the selected, not yet emitted one)."""
        st["gen"].copy_(torch.as_tensor([len(r.out_tokens) + pending
                                         for r in rows], dtype=torch.int64))

    def _can_admit(self) -> bool:
        # slot refill splices per-row KV state; only the pure-attention
        # families keep all decode state there
        return (self.cfg.continuous
                and all(b.kind == "attn" for b in self.api.cfg.pattern))

    @staticmethod
    def _done_rows(rows: list[Request]) -> list[int]:
        """Slots eligible for refill: budget exhausted or failed."""
        return [j for j, r in enumerate(rows)
                if r.status == FAILED
                or len(r.out_tokens) >= r.max_new_tokens]

    def _admission_block_reason(self, nxt: Request, cur: int, slot: dict,
                                alloc=None, j: int = 0) -> Optional[str]:
        """Why ``nxt`` cannot be placed into finished slot ``j`` now (None:
        placeable).  Dense slots are hostage to the wave position: no
        left-pad down, no ring wrap.  Paged slots need only free blocks
        (``alloc``, the wave's allocator, on the shard of row ``j``)."""
        if nxt.expert not in slot and len(slot) >= self.cfg.max_stack:
            return "stack"
        if alloc is None:
            if len(nxt.prompt) > cur:
                return "position"     # cannot left-pad down
            if cur + nxt.max_new_tokens > self.cfg.cache_len:
                return "wrap"         # would wrap the KV ring
        else:
            _, need = paged_kv.blocks_for(len(nxt.prompt),
                                          nxt.max_new_tokens, self._bs)
            if need > alloc.available_on(alloc.owner(j)):
                return "kv_blocks"
        return None

    def _try_admissions(self, rows, done, cur, experts, slot, overlay, st,
                        sched, alloc=None, row_blocks=None):
        """Refill finished slots in place from the scheduler.  Under FIFO
        (``strict_fifo``) an unplaceable head stops every refill; the
        priority and affinity schedulers scan past it and count the
        deferral.  ``cur`` is the host's mirror of the wave position
        (dense only); on the paged path ``alloc`` and ``row_blocks`` (row
        -> its blocks) are the wave's, and every finished row's blocks go
        back to the pool first.  Returns (rows, experts, overlay, slots
        refilled)."""
        sched.release(self._now())
        refilled = []
        if alloc is not None:
            self._free_rows(alloc, row_blocks, done)
        blocked = False
        for j in done:
            if blocked:
                break
            admitted = rescan = True
            while rescan and not blocked:
                admitted = rescan = False
                for nxt in sched.candidates(slot):
                    reason = self._admission_block_reason(nxt, cur, slot,
                                                          alloc, j)
                    if reason is not None:
                        if sched.strict_fifo:
                            blocked = True
                            break
                        sched.note_deferred(reason)
                        continue
                    if nxt.expert not in slot:
                        try:
                            grown = self._overlay_for(
                                tuple(experts + [nxt.expert]))
                        except ExpertUnavailable as e:
                            # fail only this request and look again: a
                            # dead expert must not block the queue
                            sched.remove(nxt)
                            self._fail([nxt], e)
                            rescan = True
                            break
                        if grown is None:
                            if sched.strict_fifo:
                                blocked = True   # newcomer not coverable
                                break
                            sched.note_deferred("overlay")
                            continue
                        experts.append(nxt.expert)
                        slot[nxt.expert] = self.slot_of(nxt.expert)
                        overlay = grown
                    else:
                        self.cache.stats.stack_hits += 1
                    sched.remove(nxt)
                    rows[j] = nxt
                    st["eid"][j] = slot[nxt.expert]
                    if alloc is not None:
                        self._admit_row_paged(nxt, j, st, overlay, alloc,
                                              row_blocks)
                    else:
                        self._admit_row(nxt, j, cur, st, overlay)
                    self._mark_admitted([nxt])
                    self._mark_first([nxt])
                    self._journal_admit(nxt, j)
                    refilled.append(j)
                    admitted = True
                    break             # slot j filled; on to the next
                if admitted:
                    break
        return rows, experts, overlay, refilled

    def _admit_row(self, r: Request, j: int, cur: int, st: dict,
                   overlay: dict) -> None:
        """Prefill one newcomer left-padded to the wave position and copy
        its KV, its first real position, its sampling key and its first
        token into row j of the kept buffers.  The row's ``start`` (cur -
        prompt length) masks its pads, so it matches the same prompt
        served alone."""
        prompt = torch.as_tensor(r.prompt, dtype=torch.int64).reshape(-1)
        row_start = cur - int(prompt.numel())
        toks = torch.full((1, cur), PAD_PROMPT_TOKEN, dtype=torch.int64)
        toks[0, row_start:] = prompt
        logits, row_cache = self.api.prefill(
            self.base, {"tokens": toks.to(self.dev)}, self.cfg.cache_len,
            delta=overlay, eid=st["eid"][j:j + 1],
            start=torch.full((1,), row_start, dtype=torch.int32,
                             device=self.dev), comm=self.comm)
        cache = st["cache"]
        lay = self._layout(st["tok"].shape[0])
        jl = j if lay is None else lay.local_index(j)
        if jl is not None:                  # this rank runs row j
            for name, layer in cache["layers"].items():
                for k in ("k", "v"):
                    layer[k][:, jl].copy_(row_cache["layers"][name][k][:, 0])
            cache["start"][jl] = row_start
        st["keys"][j].copy_(self._keys([r])[0])
        st["gen"][j] = 0
        st["tok"][j].copy_(self._select(logits, st, j)[0])

    def _drive_chunk(self, params, overlay, eid, st, rows) -> tuple:
        """One K-step chunk and the flush of its [B, K] token buffer into
        the rows (one host read).  Returns (decode steps, launched)."""
        K = self.cfg.decode_chunk
        rem = [0 if r.status == FAILED
               else max(r.max_new_tokens - len(r.out_tokens), 0)
               for r in rows]
        if max(rem) == 0:
            return 0, False
        self._set_gen(st, rows, 1)
        _, _, buf = self._chunk_fn(params, overlay, eid, st["tok"],
                                   st["cache"], rem, st["gen"], st["keys"])
        buf = buf.cpu().tolist()              # one host read per chunk
        flushed = []
        for j, r in enumerate(rows):
            n = min(K, rem[j])
            if n:
                toks = buf[j][:n]
                r.out_tokens.extend(toks)
                self._mark_done(r)
                flushed.append({"uid": r.uid, "n": n, "toks": toks,
                                "total": len(r.out_tokens)})
        self._chunk_idx += 1
        # the chunk boundary is the journal's sync point: the tokens reach
        # the OS before the next launch, so a kill costs at most one chunk
        self._journal_append("chunk", {"i": self._chunk_idx,
                                       "rows": flushed}, flush=True)
        if (self._recovery_t0 is not None
                and "first_resumed_token_s" not in self.recovery_stats):
            self.recovery_stats["first_resumed_token_s"] = (
                time.monotonic() - self._recovery_t0)
        for hook in list(self.chunk_hooks):
            hook(self._chunk_idx)
        return decode_loop.host_decode_steps(max(rem), K), True

    def _maybe_snapshot(self, rows, experts, st, cur, alloc=None,
                        row_blocks=None) -> None:
        """Commit a snapshot at the configured chunk cadence (the
        post-flush state is the exact restart point)."""
        every = self.cfg.snapshot_every_chunks
        if (not self._journaling or not every
                or self._chunk_idx % every != 0):
            return
        snapshot_mod.write_snapshot(self, rows=rows, experts=experts,
                                    cache=st["cache"], tok=st["tok"],
                                    cur=cur, alloc=alloc,
                                    row_blocks=row_blocks)

    def _chunk_loop(self, rows, experts, slot, overlay, st, sched,
                    cur: int, alloc=None, row_blocks=None,
                    restored: bool = False) -> tuple:
        """The chunked wave driver (dense and paged): a chunk, its flush
        and journal record, a snapshot at the configured cadence, then
        refills of finished slots.  A newcomer's first token stays on the
        device as the pending token the next chunk emits first.  A
        ``restored`` wave (a snapshot: the state after a flush, before its
        refills) refills first.  Returns (admitted (request, wave
        position) pairs, chunks)."""
        admitted, chunks = [], 0
        while True:
            if restored:
                restored = False
            else:
                steps, launched = self._drive_chunk(self.base, overlay,
                                                    st["eid"], st, rows)
                cur += steps                  # host mirror of the position
                chunks += int(launched)
                if launched:
                    self._maybe_snapshot(rows, experts, st, cur, alloc=alloc,
                                         row_blocks=row_blocks)
            done = self._done_rows(rows)
            if sched is not None and sched.pending() and self._can_admit():
                rows, experts, overlay, refilled = self._try_admissions(
                    rows, done, cur, experts, slot, overlay, st, sched,
                    alloc=alloc, row_blocks=row_blocks)
                admitted += [(rows[j], cur) for j in refilled]
                done = self._done_rows(rows)
            if len(done) == len(rows):
                return admitted, chunks

    def _serve_wave_chunked(self, wave, experts, overlay, sched) -> None:
        t0, g0 = time.monotonic(), self._graph_counts()
        self._mark_admitted(wave)
        slot = {e: self.slot_of(e) for e in experts}
        st, cur = self._prefill(self.base, overlay, wave,
                                [slot[r.expert] for r in wave])
        self._sync()
        prefill_s = time.monotonic() - t0
        self._mark_first(wave)
        for j, r in enumerate(wave):
            self._journal_admit(r, j)
        admitted, chunks = self._chunk_loop(list(wave), experts, slot,
                                            overlay, st, sched, cur)
        self.wave_log.append(self._log(t0, g0, wave, admitted, chunks, cur,
                                       prefill_s, experts=len(experts)))

    # ---------------- paged-KV wave driver ----------------

    def _paged_prefill(self, reqs: list[Request], js: list[int], lp: int,
                       st: dict, overlay: dict, row_blocks: dict) -> None:
        """Prefill rows ``js`` (prompts all bucketed to width ``lp``) and
        scatter their KV into their pool blocks.  The rows run one dense
        prefill at ``cache_len = lp``: there the ring fill is the
        identity, so slot order is position order and each row's cache
        drops into ``lp // BS`` blocks.  Each row's key, first token
        (drawn at stream position 0), block table, position and first
        real position are written into the kept buffers in place."""
        dev = self.dev
        jsa = torch.as_tensor(js, dtype=torch.int64, device=dev)
        toks, start = self._pad_prompts(reqs, lp)
        logits, row_cache = self.api.prefill(
            self.base, {"tokens": toks}, lp, delta=overlay,
            eid=st["eid"][jsa], start=start, comm=self.comm)
        # on a "model" axis each rank scatters the rows it runs, into its
        # shard of the pool (row_blocks hold the owner shard's block ids)
        lay = self._layout(st["tok"].shape[0])
        mine = [(i, j if lay is None else lay.local_index(j))
                for i, j in enumerate(js)]
        mine = [(i, jl) for i, jl in mine if jl is not None]
        if mine:
            ii = torch.as_tensor([i for i, _ in mine], dtype=torch.int64,
                                 device=dev)
            layers = {name: {k: t.index_select(1, ii) for k, t in l.items()}
                      for name, l in row_cache["layers"].items()}
            nbp = lp // self._bs
            ptab = torch.as_tensor([row_blocks[js[i]][:nbp] for i, _ in mine],
                                   dtype=torch.int64)
            tables = torch.full((len(mine), self._max_blocks), -1,
                                dtype=torch.int32)
            for r, (i, _) in enumerate(mine):
                tables[r, :len(row_blocks[js[i]])] = torch.as_tensor(
                    row_blocks[js[i]])
            paged_kv.insert_prefill_rows(
                st["cache"], layers,
                torch.as_tensor([jl for _, jl in mine], dtype=torch.int64,
                                device=dev), ptab.to(dev), tables.to(dev),
                torch.full((len(mine),), lp, dtype=torch.int32, device=dev),
                start.index_select(0, ii))
        st["keys"].index_copy_(0, jsa, self._keys(reqs).to(dev))
        first = select_tokens(logits[:, -1], st["keys"][jsa],
                              torch.zeros((len(js),), dtype=torch.int64,
                                          device=dev), self.cfg.sampling,
                              self.comm)
        st["tok"].index_copy_(0, jsa, first[:, None])

    def _admit_row_paged(self, r: Request, j: int, st: dict, overlay: dict,
                         alloc, row_blocks: dict) -> None:
        """Paged slot refill: allocate the row's blocks and write its
        prefill KV into them.  No wave position to pad against and no
        ring to wrap: the feasibility check already found the blocks."""
        lp, need = paged_kv.blocks_for(len(r.prompt), r.max_new_tokens,
                                       self._bs)
        row_blocks[j] = alloc.alloc(need, shard=alloc.owner(j))
        self._kv_in_use = alloc.in_use
        self._kv_peak = max(self._kv_peak, alloc.peak_in_use)
        self._paged_prefill([r], [j], lp, st, overlay, row_blocks)

    def _serve_wave_paged(self, wave, experts, overlay, sched) -> None:
        """Block-table wave: one batched prefill per prompt bucket into
        pool blocks, then the chunked driver over the paged cache (one
        CUDA graph replay a chunk on the card).  Admission control is the
        wave's free list, fresh on the host: a finished row's blocks go
        back to the pool, and any queued request whose blocks fit is
        placeable.  A wave larger than the pool re-queues its overflow."""
        t0, g0 = time.monotonic(), self._graph_counts()
        alloc, row_blocks, kept = self._place_wave(wave)
        held = {id(r) for r in kept}
        for r in wave:
            if id(r) not in held:
                # the pool is smaller than the wave: the overflow re-enters
                # through a later wave or a slot refill
                sched.push(r)
        if not kept:
            return
        # the allocator's shards are those of the wave's KV (row j's blocks
        # lie in the pool of the rank that runs row j)
        assert alloc.n_shards == self._row_shards(len(kept))
        requeued = len(wave) - len(kept)
        wave = kept
        buckets = [paged_kv.blocks_for(len(r.prompt), r.max_new_tokens,
                                       self._bs)[0] for r in wave]
        self._mark_admitted(wave)
        slot = {e: self.slot_of(e) for e in experts}
        st = self._paged_state(len(wave))
        cache = st["cache"]
        cache["tables"].fill_(-1)
        cache["active"].zero_()
        st["eid"].copy_(torch.as_tensor([slot[r.expert] for r in wave],
                                        dtype=torch.int32))
        groups: dict[int, list] = defaultdict(list)
        for j, lp in enumerate(buckets):
            groups[lp].append(j)
        for lp in sorted(groups):
            self._paged_prefill([wave[j] for j in groups[lp]], groups[lp],
                                lp, st, overlay, row_blocks)
        self._sync()
        prefill_s = time.monotonic() - t0
        self._mark_first(wave)
        for j, r in enumerate(wave):
            self._journal_admit(r, j)
        self._kv_in_use = alloc.in_use
        self._kv_peak = max(self._kv_peak, alloc.peak_in_use)
        try:
            admitted, chunks = self._chunk_loop(
                list(wave), experts, slot, overlay, st, sched, 0,
                alloc=alloc, row_blocks=row_blocks)
        finally:
            # every live row's blocks go back on any exit, and the
            # allocator must balance: a leak would starve later waves
            self._free_rows(alloc, row_blocks, list(row_blocks))
            assert alloc.in_use == 0, (
                f"paged KV leak: {alloc.in_use} blocks still allocated at "
                "wave teardown")
        self.wave_log.append(self._log(
            t0, g0, wave, admitted, chunks, max(buckets), prefill_s,
            experts=len(experts), kv_blocks_peak=alloc.peak_in_use,
            requeued=requeued))

    def _serve_wave_eager(self, wave, experts, overlay, sched) -> None:
        """The baseline: one decode step and one host read per token."""
        t0, g0 = time.monotonic(), self._graph_counts()
        self._mark_admitted(wave)
        slot = {e: self.slot_of(e) for e in experts}
        st, cur = self._prefill(self.base, overlay, wave,
                                [slot[r.expert] for r in wave])
        self._sync()
        prefill_s = time.monotonic() - t0
        T = cur
        self._mark_first(wave)
        rows, admitted = list(wave), []
        tok = st["tok"]
        while True:
            toks = tok[:, 0].tolist()          # one host read per step
            for j, r in enumerate(rows):
                if len(r.out_tokens) < r.max_new_tokens:
                    r.out_tokens.append(toks[j])
                    self._mark_done(r)
            done = self._done_rows(rows)
            if sched is not None and sched.pending() and self._can_admit():
                rows, experts, overlay, refilled = self._try_admissions(
                    rows, done, cur, experts, slot, overlay, st, sched)
                for j in refilled:
                    # the newcomer's prefill selection is its first token
                    if rows[j].max_new_tokens > 0:
                        rows[j].out_tokens.append(int(tok[j, 0]))
                        self._mark_done(rows[j])
                admitted += [(rows[j], cur) for j in refilled]
                done = self._done_rows(rows)
            if len(done) == len(rows):
                break
            logits, _ = self.api.decode_step(self.base, tok, st["cache"],
                                             delta=overlay, eid=st["eid"],
                                             comm=self.comm)
            self._set_gen(st, rows, 0)
            tok.copy_(self._select(logits, st))
            cur += 1
        self.wave_log.append(self._log(t0, g0, wave, admitted, 0, T,
                                       prefill_s, experts=len(experts)))

    def _serve_batch(self, params: dict, reqs: list[Request],
                     expert: str) -> None:
        """Merge-path batch (one expert, no overlay, no refill): prefill,
        then chunks, or the eager loop with ``decode_chunk=0``."""
        t0, g0 = time.monotonic(), self._graph_counts()
        self._mark_admitted(reqs)
        st, T = self._prefill(params, None, reqs, None)
        self._sync()
        prefill_s = time.monotonic() - t0
        self._mark_first(reqs)
        chunks = 0
        if self.cfg.decode_chunk:
            while self._drive_chunk(params, None, None, st, reqs)[1]:
                chunks += 1
        else:
            tok = st["tok"]
            while True:
                toks = tok[:, 0].tolist()      # one host read per step
                for j, r in enumerate(reqs):
                    if len(r.out_tokens) < r.max_new_tokens:
                        r.out_tokens.append(toks[j])
                        self._mark_done(r)
                if len(self._done_rows(reqs)) == len(reqs):
                    break
                logits, _ = self.api.decode_step(params, tok, st["cache"],
                                                 comm=self.comm)
                self._set_gen(st, reqs, 0)
                tok.copy_(self._select(logits, st))
        self.batch_log.append(self._log(t0, g0, reqs, [], chunks, T,
                                        prefill_s, expert=expert))

    # ---------------- accounting ----------------

    def _graph_counts(self) -> dict:
        return (self._chunker.stats() if self._chunker is not None else
                {"graphs": 0, "captures": 0, "capture_s": 0.0, "replays": 0})

    def _log(self, t0, g0, reqs, admitted, chunks, prompt_len, prefill_s,
             **extra) -> dict:
        g = self._graph_counts()
        served = list(reqs) + [r for r, _ in admitted]
        return dict(rows=len(reqs), admitted=len(admitted), chunks=chunks,
                    uids=[r.uid for r in reqs],
                    admitted_at=[(r.uid, cur) for r, cur in admitted],
                    prompt_len=prompt_len, prefill_s=prefill_s,
                    seconds=time.monotonic() - t0,
                    tokens=sum(r.max_new_tokens for r in served),
                    captures=g["captures"] - g0["captures"],
                    capture_s=g["capture_s"] - g0["capture_s"],
                    replays=g["replays"] - g0["replays"], **extra)

    def _scheduler_stats(self) -> dict:
        s = self._sched.stats() if self._sched is not None else {
            "policy": self.cfg.scheduler, "queue_depth_max": 0,
            "deferred": 0}
        s["admission_wait_s"] = {
            str(p): {"n": len(w), "mean": sum(w) / len(w), "max": max(w)}
            for p, w in sorted(self._adm_wait.items()) if w}
        return s

    def _kv_stats(self) -> dict:
        total = (self._kv_blocks - 1 if self.cfg.kv_layout == "paged"
                 else None)
        return {"layout": self.cfg.kv_layout, "block_size": self._bs,
                "blocks_total": total, "blocks_in_use": self._kv_in_use,
                "blocks_peak": self._kv_peak}

    def swap_summary(self) -> dict:
        s = self.cache.stats.as_dict()
        g = self._graph_counts()
        hits, builds = s.get("stack_hits", 0), s.get("stack_builds", 0)
        s.update(n_waves=len(self.wave_log), n_batches=len(self.batch_log),
                 n_swaps=len(self.swap_log),
                 swap_seconds=sum(x["seconds"] for x in self.swap_log),
                 resident_bytes=self.cache.resident_bytes(),
                 slot_bytes=(self._slots.nbytes() if self._slots is not None
                             else 0),
                 admitted=sum(w["admitted"] for w in self.wave_log),
                 failed=self.failed_total,
                 log_dropped=dict(self._log_dropped),
                 graphs=g["graphs"], graph_captures=g["captures"],
                 graph_capture_s=g["capture_s"], graph_replays=g["replays"],
                 stack_hit_rate=hits / max(hits + builds, 1),
                 scheduler=self._scheduler_stats(), kv=self._kv_stats())
        if self.mesh is not None:
            s["mesh"] = dict(self.comm.shape)
            s["shards"] = self.cache.shard_summary()
        return s

    def _export_gauges(self) -> None:
        """Publish serving gauges onto the device cache, so that
        ``registry.health()["serving"]`` shows them beside the swap and
        straggler state."""
        s = self.cache.stats
        self.cache.gauges = {
            "stack_hit_rate": s.stack_hits / max(s.stack_hits
                                                 + s.stack_builds, 1),
            "scheduler": self._scheduler_stats(),
            "kv": self._kv_stats()}
        if self.mesh is not None:
            self.cache.gauges["shards"] = self.cache.shard_summary()
