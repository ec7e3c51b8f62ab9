"""Multi-expert serving engine of the port: FIFO mixed waves over one
shared base, and merge-on-swap.

Port of ``repro/serve/engine.py``.  Requests name an expert.  Under
``scheduling="mixed"`` (the default) they are taken FIFO into waves of up
to ``max_batch`` rows across up to ``max_stack`` distinct experts; a wave
runs prefill and chunked decode against the **base** parameters plus a
zero-merge overlay (the stacked bitplanes of every expert in the wave,
contracted per row by the grouped ternary kernel), so no merged parameters
ever exist.  Prompts are left-padded to the wave's longest, with each
row's first real position masking its pads out of attention.

Merge-on-swap (``scheduling="grouped"``, the reference's measured
baseline) groups requests by expert in order of first appearance, merges
each expert into a copy of the base once (``ExpertRegistry.merged_params``
on the ``unpack_add_many`` kernel) and serves the group in batches of up
to ``max_batch`` with no overlay.  It is also the mixed scheduler's
fallback for a wave whose experts carry a leaf the overlay cannot express,
and for a model family the overlay does not cover.
:meth:`ServeEngine.merged_ensemble_params` merges several weighted experts
in one sweep per leaf.

Options of the reference engine that the port does not serve yet raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Optional

import torch

from repro_torch.models.delta import build_overlay, plan_overlay
from repro_torch.serve import decode_loop
from repro_torch.serve.decode_loop import SamplingConfig, select_tokens
from repro_torch.serve.expert_cache import BASE, ExpertRegistry

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


@dataclasses.dataclass
class EngineConfig:
    """The reference's fields; values this slice does not serve raise."""
    max_batch: int = 8
    cache_len: int = 128
    device_cache_bytes: Optional[int] = None
    scheduling: str = "mixed"
    max_stack: int = 8
    continuous: bool = False      # slot refill is not ported yet
    decode_chunk: int = 16
    sampling: SamplingConfig = dataclasses.field(
        default_factory=SamplingConfig)
    degrade: str = "request"
    scheduler: str = "fifo"
    kv_layout: str = "dense"
    kv_block_size: int = 16
    kv_blocks: Optional[int] = None
    mesh: Optional[Any] = None
    snapshot_dir: Optional[str] = None
    snapshot_every_chunks: int = 0


def _unsupported(cfg: EngineConfig) -> Optional[str]:
    if cfg.kv_layout != "dense":
        return (f"kv_layout={cfg.kv_layout!r}: paged KV comes with ROADMAP "
                "queue 1, item 7")
    if cfg.scheduler != "fifo":
        return (f"scheduler={cfg.scheduler!r}: priority and affinity "
                "scheduling come with ROADMAP queue 1, item 7")
    if cfg.mesh is not None:
        return "mesh=: serving across GPUs comes with ROADMAP queue 1, item 10"
    if cfg.snapshot_dir is not None or cfg.snapshot_every_chunks:
        return ("snapshot_dir=: journal, snapshots and resume come with "
                "ROADMAP queue 1, item 9")
    if not cfg.sampling.greedy:
        return ("temperature > 0: sampled decoding comes with ROADMAP "
                "queue 1, item 5")
    if cfg.continuous:
        return ("continuous=True: slot refill (continuous admission) comes "
                "with ROADMAP queue 1, item 5")
    if cfg.decode_chunk == 0:
        return ("decode_chunk=0: the eager per-token loop comes with ROADMAP "
                "queue 1, item 5")
    return None


class ServeEngine:
    """Single-device engine over an :class:`ExpertRegistry`."""

    def __init__(self, api, base_params: dict,
                 registry: ExpertRegistry, ecfg: EngineConfig):
        why = _unsupported(ecfg)
        if why is not None:
            raise NotImplementedError(why)
        if ecfg.scheduling not in ("mixed", "grouped"):
            raise ValueError('scheduling must be "mixed" or "grouped", '
                             f"got {ecfg.scheduling!r}")
        if ecfg.decode_chunk < 0:
            raise ValueError("decode_chunk must be >= 0")
        if ecfg.degrade not in ("request", "raise"):
            raise ValueError('degrade must be "request" or "raise"')
        self.api = api
        self.base = base_params
        self.registry = registry
        self.cfg = ecfg
        self.dev = registry.dev
        if base_params["embed"].device.type != self.dev.type:
            raise ValueError(f"base params lie on {base_params['embed'].device}"
                             f" but the registry serves on {self.dev}")
        self.cache = registry.device(ecfg.device_cache_bytes)
        # None: a family outside the overlay, served by merge-on-swap
        self._plan = plan_overlay(base_params, api.cfg)
        self._overlays: dict[tuple, Any] = {}
        self._merged_name: Optional[str] = None
        self._merged_params: Optional[dict] = None
        self._chunk_fn = decode_loop.make_decode_chunk(
            api, ecfg.decode_chunk, ecfg.sampling)
        self.wave_log: list[dict] = []       # mixed waves
        self.batch_log: list[dict] = []      # merge-path batches
        self.swap_log: deque = deque(maxlen=512)   # merges, with seconds

    # ---------------- merged parameters ----------------

    def _params_for(self, expert: str) -> dict:
        """Merge-on-swap: the full merged params of one expert (the base
        itself for ``BASE``).  The last merged expert is memoised; every
        merge lands in ``swap_log`` with its seconds."""
        if expert == BASE:
            return self.base
        if self._merged_name == expert:
            return self._merged_params
        t0 = time.monotonic()
        params = self.registry.merged_params(self.base, [expert])
        self._sync()
        self._merged_name, self._merged_params = expert, params
        self.swap_log.append({"expert": expert,
                              "seconds": time.monotonic() - t0})
        return params

    def merged_ensemble_params(self, experts: list[str],
                               weights: Optional[list[float]] = None
                               ) -> dict:
        """Merged-ensemble mode: W_base + sum_e w_e * Delta_e in one sweep
        per leaf (``unpack_add_many``), bitwise equal to applying the
        weight-scaled experts one at a time."""
        return self.registry.merged_params(self.base, experts, weights)

    # ---------------- expert overlays ----------------

    def _overlay_for(self, experts: tuple) -> Optional[dict]:
        """Zero-merge overlay for an ordered expert set (cached while the
        device cache keeps its stack); None when a member carries a leaf
        the overlay cannot express (the wave then merges)."""
        if experts in self._overlays and self.cache.has_stack(experts):
            self.cache.stats.stack_hits += 1
            return self._overlays[experts]
        self._overlays.pop(experts, None)
        overlay = build_overlay(self._plan, self.cache.stacked(experts))
        if overlay is None:
            return None
        while len(self._overlays) >= self.cache.MAX_STACKS:
            self._overlays.pop(next(iter(self._overlays)))
        self._overlays[experts] = overlay
        return overlay

    # ---------------- serving loop ----------------

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def run(self, requests: list[Request]) -> list[Request]:
        """Serve every request to its budget; tokens land in
        ``Request.out_tokens``."""
        pending = [r for r in requests if r.status == PENDING]
        if self.cfg.scheduling == "grouped" or self._plan is None:
            self._run_grouped(pending)
        else:
            self._run_mixed(pending)
        for r in requests:
            if r.status == PENDING:
                r.status = DONE
        return requests

    def _fail(self, reqs: list[Request], why: str) -> None:
        for r in reqs:
            r.status, r.error = FAILED, why

    def _run_mixed(self, requests: list[Request]) -> None:
        """FIFO waves on the zero-merge overlay; a wave the overlay cannot
        express is served by merge-on-swap."""
        queue = deque(requests)
        while queue:
            wave, experts = [], []
            while queue and len(wave) < self.cfg.max_batch:
                r = queue[0]
                if r.expert not in experts:
                    if len(experts) >= self.cfg.max_stack:
                        break                    # over the stack: next wave
                    experts.append(r.expert)
                wave.append(queue.popleft())
            overlay = None
            while wave:
                try:
                    overlay = self._overlay_for(tuple(experts))
                    break
                except KeyError as e:
                    # an expert the registry does not hold fails only its
                    # own requests; the rest of the wave serves
                    hit = [r for r in wave if r.expert == e.args[0]]
                    if self.cfg.degrade == "raise" or not hit:
                        raise
                    self._fail(hit, f"unknown expert {e}")
                    wave = [r for r in wave if r.expert != e.args[0]]
                    experts.remove(e.args[0])
            if not wave:
                continue
            if overlay is None:
                self._run_grouped(wave)
                continue
            slot = {e: i for i, e in enumerate(experts)}
            eid = torch.as_tensor([slot[r.expert] for r in wave],
                                  dtype=torch.int32).to(self.dev)
            log = self._serve_rows(self.base, overlay, eid, wave)
            self.wave_log.append(dict(log, experts=len(experts)))

    def _run_grouped(self, requests: list[Request]) -> None:
        """Merge-on-swap: group by expert in order of first appearance,
        merge each expert once, serve its group in batches of up to
        ``max_batch``."""
        groups: dict[str, list[Request]] = {}
        for r in requests:
            groups.setdefault(r.expert, []).append(r)
        for expert, group in groups.items():
            try:
                params = self._params_for(expert)
            except KeyError as e:
                # an unknown expert fails its own group; the others serve
                if self.cfg.degrade == "raise":
                    raise
                self._fail(group, f"unknown expert {e}")
                continue
            for i in range(0, len(group), self.cfg.max_batch):
                batch = group[i:i + self.cfg.max_batch]
                log = self._serve_rows(params, None, None, batch)
                self.batch_log.append(dict(log, expert=expert))

    def _pad_prompts(self, reqs: list[Request]):
        """Left-pad prompts to one width -> (tokens [B, T] int64, start [B]
        int32, each row's first real position)."""
        prompts = [torch.as_tensor(r.prompt, dtype=torch.int64).reshape(-1)
                   for r in reqs]
        T = max(int(p.numel()) for p in prompts)
        toks = torch.full((len(reqs), T), PAD_PROMPT_TOKEN, dtype=torch.int64)
        for j, p in enumerate(prompts):
            toks[j, T - p.numel():] = p
        start = torch.as_tensor([T - int(p.numel()) for p in prompts],
                                dtype=torch.int32)
        return toks.to(self.dev), start.to(self.dev)

    def _serve_rows(self, params: dict, overlay: Optional[dict],
                    eid: Optional[torch.Tensor], reqs: list[Request]) -> dict:
        """Prefill a batch on ``params`` (plus the overlay of a mixed wave,
        none on the merge path), then chunks of K decode steps with one
        host read of the [B, K] token buffer per chunk.  Returns the
        batch's log entry."""
        t0 = time.monotonic()
        toks, start = self._pad_prompts(reqs)
        logits, cache = self.api.prefill(params, {"tokens": toks},
                                         self.cfg.cache_len, delta=overlay,
                                         eid=eid, start=start)
        tok = select_tokens(logits[:, -1], self.cfg.sampling)[:, None]
        self._sync()
        prefill_s = time.monotonic() - t0
        K = self.cfg.decode_chunk
        chunks = 0
        while True:
            rem = [max(r.max_new_tokens - len(r.out_tokens), 0) for r in reqs]
            if max(rem) == 0:
                break
            tok, cache, buf = self._chunk_fn(params, overlay, eid, tok,
                                             cache, rem)
            buf = buf.cpu().tolist()              # one host read per chunk
            chunks += 1
            for j, r in enumerate(reqs):
                n = min(K, rem[j])
                r.out_tokens.extend(buf[j][:n])
        return {"rows": len(reqs), "chunks": chunks,
                "prompt_len": int(toks.shape[1]), "prefill_s": prefill_s,
                "seconds": time.monotonic() - t0,
                "tokens": sum(r.max_new_tokens for r in reqs)}

    def swap_summary(self) -> dict:
        s = self.cache.stats.as_dict()
        s.update(n_waves=len(self.wave_log), n_batches=len(self.batch_log),
                 n_swaps=len(self.swap_log),
                 swap_seconds=sum(x["seconds"] for x in self.swap_log),
                 resident_bytes=self.cache.resident_bytes())
        return s
