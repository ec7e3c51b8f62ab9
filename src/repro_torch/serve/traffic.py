"""Seeded open-loop traffic for the serving engine of the port.

A copy of the logic of ``benchmarks/traffic.py`` (that module imports the
JAX package's engine, so the port copies it and never imports it).
Arrivals are bursty, expert popularity is heavy-tailed and prompt and
output lengths are bimodal, all a deterministic function of a seed:

* **arrivals**: an open-loop inhomogeneous Poisson process, exponential
  gaps at ``base_rate`` req/s, times ``burst_rate_x`` inside periodic
  burst windows (``burst_every_s``/``burst_duration_s``);
* **expert popularity**: Zipf, expert k (1-indexed) drawn with
  probability proportional to k^-alpha over ``n_experts`` experts;
* **lengths**: a short/long prompt mix (``long_frac``) with independent
  short/long output budgets (``long_out_frac``);
* **SLO metadata**: priority classes drawn from ``priorities`` weights,
  each with a deadline budget (``deadline_by_priority``, seconds after
  arrival).

:func:`generate` draws from the reference's ``np.random.default_rng(seed)``
stream in the reference's order, so a timeline (arrivals, experts, prompt
tokens, budgets, priorities, deadlines) is identical to the reference's;
it returns the port's :class:`~repro_torch.serve.engine.Request` objects
with int64 prompt tensors and ``arrival_s`` set.  :func:`summarize`
reduces a served list to the reference's latency and throughput record.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.serve.engine import FAILED, Request

__all__ = ["TrafficConfig", "zipf_weights", "in_burst", "generate",
           "summarize"]


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Everything the arrival process depends on.  Two equal configs
    generate identical request timelines."""

    seed: int = 0
    n_requests: int = 64
    # -- arrivals (open-loop Poisson + periodic bursts) --
    base_rate: float = 8.0          # req/s outside bursts
    burst_every_s: float = 4.0      # burst window period
    burst_duration_s: float = 1.0   # burst window length
    burst_rate_x: float = 4.0       # rate multiplier inside a window
    # -- expert popularity (Zipf over expert0..expert{n-1}) --
    n_experts: int = 8
    zipf_alpha: float = 1.1
    expert_prefix: str = "expert"
    # -- prompt/output length mix --
    prompt_len_short: int = 6
    prompt_len_long: int = 40
    long_frac: float = 0.25
    max_new_short: int = 8
    max_new_long: int = 16
    long_out_frac: float = 0.25
    vocab: int = 512
    # -- SLO metadata --
    priorities: tuple = ((0, 0.2), (1, 0.8))   # (class, weight)
    deadline_by_priority: tuple = ((0, 2.0), (1, 10.0))  # class -> budget s


def zipf_weights(n: int, alpha: float) -> np.ndarray:
    """P(expert k) proportional to (k+1)^-alpha, normalised; ``alpha=0``
    is uniform."""
    w = np.arange(1, n + 1, dtype=np.float64) ** (-alpha)
    return w / w.sum()


def in_burst(t: float, cfg: TrafficConfig) -> bool:
    """Whether absolute time ``t`` lands inside a periodic burst window."""
    if cfg.burst_every_s <= 0 or cfg.burst_duration_s <= 0:
        return False
    return (t % cfg.burst_every_s) < cfg.burst_duration_s


def _rate(t: float, cfg: TrafficConfig) -> float:
    return cfg.base_rate * (cfg.burst_rate_x if in_burst(t, cfg) else 1.0)


def generate(cfg: TrafficConfig) -> list:
    """The seeded timeline as engine requests.

    Each gap is drawn from the exponential at the rate in effect at the
    current time; expert, lengths, priority and prompt tokens come from
    the same generator stream, so the whole workload replays identically
    for equal configs."""
    rng = np.random.default_rng(cfg.seed)
    pw = zipf_weights(cfg.n_experts, cfg.zipf_alpha)
    prio_cls = np.asarray([p for p, _ in cfg.priorities], np.int64)
    prio_w = np.asarray([w for _, w in cfg.priorities], np.float64)
    prio_w = prio_w / prio_w.sum()
    budget = dict(cfg.deadline_by_priority)

    out = []
    t = 0.0
    for uid in range(cfg.n_requests):
        t += float(rng.exponential(1.0 / max(_rate(t, cfg), 1e-9)))
        expert = int(rng.choice(cfg.n_experts, p=pw))
        lp = (cfg.prompt_len_long if rng.random() < cfg.long_frac
              else cfg.prompt_len_short)
        mx = (cfg.max_new_long if rng.random() < cfg.long_out_frac
              else cfg.max_new_short)
        prio = int(rng.choice(prio_cls, p=prio_w))
        prompt = rng.integers(2, cfg.vocab, size=lp)
        out.append(Request(
            uid=uid,
            expert=f"{cfg.expert_prefix}{expert}",
            prompt=torch.as_tensor(prompt, dtype=torch.int64),
            max_new_tokens=int(mx),
            priority=prio,
            deadline_s=t + budget[prio] if prio in budget else None,
            arrival_s=t,
        ))
    return out


def _pct(xs: list, q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(xs), q)) if xs else None


def summarize(requests: list) -> dict:
    """Latency and throughput record of a served request list.

    TTFT is ``t_first_s - arrival_s`` (time to the first selected token);
    tokens/s counts generated tokens over the span from the first arrival
    to the last completion.  Requests that failed (or never got a first
    token) are counted but left out of the percentiles."""
    served = [r for r in requests
              if r.status != FAILED and r.t_first_s is not None]
    ttft = [r.t_first_s - r.arrival_s for r in served]
    n_tokens = sum(len(r.out_tokens) for r in served)
    done_t = [r.t_done_s for r in served if r.t_done_s is not None]
    t0 = min((r.arrival_s for r in served), default=0.0)
    span = (max(done_t) - t0) if done_t else 0.0
    by_prio: dict = {}
    for r in served:
        b = by_prio.setdefault(r.priority, {"n": 0, "ttft": [], "miss": 0})
        b["n"] += 1
        b["ttft"].append(r.t_first_s - r.arrival_s)
        if (r.deadline_s is not None and r.t_done_s is not None
                and r.t_done_s > r.deadline_s):
            b["miss"] += 1
    return {
        "n_served": len(served),
        "n_failed": sum(1 for r in requests if r.status == FAILED),
        "ttft_p50_s": _pct(ttft, 50),
        "ttft_p95_s": _pct(ttft, 95),
        "ttft_p99_s": _pct(ttft, 99),
        "tokens": n_tokens,
        "tokens_per_s": n_tokens / span if span > 0 else None,
        "span_s": span,
        "per_priority": {
            str(p): {"n": b["n"], "ttft_p95_s": _pct(b["ttft"], 95),
                     "deadline_miss": b["miss"]}
            for p, b in sorted(by_prio.items())},
    }
