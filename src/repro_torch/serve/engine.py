"""Mixed-expert serving engine of the port: FIFO waves over one shared base.

Port of the mixed path of ``repro/serve/engine.py``.  Requests name an
expert.  They are taken FIFO into waves of up to ``max_batch`` rows across
up to ``max_stack`` distinct experts; a wave runs prefill and chunked
decode against the **base** parameters plus a zero-merge overlay (the
stacked bitplanes of every expert in the wave, contracted per row by the
grouped ternary kernel), so no merged parameters ever exist.  Prompts are
left-padded to the wave's longest, with each row's first real position
masking its pads out of attention.

Options of the reference engine that this slice does not port raise
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
from repro_torch.serve.expert_cache import ExpertRegistry

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
    if cfg.scheduling != "mixed":
        return (f"scheduling={cfg.scheduling!r}: merge-on-swap waves come "
                "with ROADMAP queue 1, item 5 and kernel 4 (unpack_add_many)")
    if not cfg.sampling.greedy:
        return ("temperature > 0: sampled decoding comes with ROADMAP "
                "queue 1, item 5 (slice 2)")
    if cfg.continuous:
        return ("continuous=True: slot refill (continuous admission) comes "
                "with ROADMAP queue 1, item 5 (slice 2)")
    if cfg.decode_chunk == 0:
        return ("decode_chunk=0: the eager per-token loop comes with ROADMAP "
                "queue 1, item 5 (slice 2)")
    return None


class ServeEngine:
    """Single-device engine over an :class:`ExpertRegistry`."""

    def __init__(self, api, base_params: dict,
                 registry: ExpertRegistry, ecfg: EngineConfig):
        why = _unsupported(ecfg)
        if why is not None:
            raise NotImplementedError(why)
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
        self._plan = plan_overlay(base_params, api.cfg)
        if self._plan is None:
            raise NotImplementedError(
                f"{api.cfg.name}: families outside the zero-merge overlay are "
                "served by merge-on-swap, ROADMAP queue 1, item 12")
        self._overlays: dict[tuple, Any] = {}
        self._chunk_fn = decode_loop.make_decode_chunk(
            api, ecfg.decode_chunk, ecfg.sampling)
        self.wave_log: list[dict] = []

    # ---------------- expert overlays ----------------

    def _overlay_for(self, experts: tuple) -> dict:
        """Zero-merge overlay for an ordered expert set (cached while the
        device cache keeps its stack)."""
        if experts in self._overlays and self.cache.has_stack(experts):
            self.cache.stats.stack_hits += 1
            return self._overlays[experts]
        self._overlays.pop(experts, None)
        overlay = build_overlay(self._plan, self.cache.stacked(experts))
        if overlay is None:
            raise NotImplementedError(
                f"experts {experts} carry deltas outside the overlay plan; "
                "merge-on-swap comes with ROADMAP queue 1, item 5")
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
        queue = deque(r for r in requests if r.status == PENDING)
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
                    for r in hit:
                        r.status, r.error = FAILED, f"unknown expert {e}"
                    wave = [r for r in wave if r.expert != e.args[0]]
                    experts.remove(e.args[0])
            if wave:
                self._serve_wave(wave, experts, overlay)
        for r in requests:
            if r.status == PENDING:
                r.status = DONE
        return requests

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

    def _serve_wave(self, wave: list[Request], experts: list[str],
                    overlay: dict) -> None:
        """Prefill the wave, then chunks of K decode steps with one host
        read of the [B, K] token buffer per chunk."""
        t0 = time.monotonic()
        slot = {e: i for i, e in enumerate(experts)}
        eid = torch.as_tensor([slot[r.expert] for r in wave],
                              dtype=torch.int32).to(self.dev)
        toks, start = self._pad_prompts(wave)
        logits, cache = self.api.prefill(self.base, {"tokens": toks},
                                         self.cfg.cache_len, delta=overlay,
                                         eid=eid, start=start)
        tok = select_tokens(logits[:, -1], self.cfg.sampling)[:, None]
        self._sync()
        prefill_s = time.monotonic() - t0
        K = self.cfg.decode_chunk
        chunks = 0
        while True:
            rem = [max(r.max_new_tokens - len(r.out_tokens), 0) for r in wave]
            if max(rem) == 0:
                break
            tok, cache, buf = self._chunk_fn(self.base, overlay, eid, tok,
                                             cache, rem)
            buf = buf.cpu().tolist()              # one host read per chunk
            chunks += 1
            for j, r in enumerate(wave):
                n = min(K, rem[j])
                r.out_tokens.extend(buf[j][:n])
        self.wave_log.append({
            "rows": len(wave), "experts": len(experts), "chunks": chunks,
            "prompt_len": int(toks.shape[1]), "prefill_s": prefill_s,
            "seconds": time.monotonic() - t0,
            "tokens": sum(r.max_new_tokens for r in wave)})

    def swap_summary(self) -> dict:
        s = self.cache.stats.as_dict()
        s.update(n_waves=len(self.wave_log), n_swaps=0,
                 resident_bytes=self.cache.resident_bytes())
        return s
