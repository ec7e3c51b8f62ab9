"""Seeded traffic for the serving cells, from a cell's parameters.

A copy of the arrival logic of ``repro_torch/serve/traffic.py`` (bursty
open-loop Poisson arrivals, Zipf popularity over experts, a mixture of
prompt lengths), with two changes:

* every seed gets the same sizes, experts and arrival times in the same
  order: a template drawn from the cell's fixed ``template_seed``; the
  run's seed draws only the prompt tokens, so a seed changes neither the
  amount of work nor the order that sets a call's drain;
* the records are plain (no import of the program): the window driver
  turns them into the engine's requests.

The copied ``summarize`` lived on in ``cardbench/lib/stats.py``, fixed:
failed requests count as misses, and TTFT runs to the delivery of the
first token, not to its selection.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Spec:
    uid: int
    expert: int             # index into the cell's experts
    prompt: np.ndarray      # int64 token ids
    max_new: int
    due: float              # seconds after the window opens (0: queued)


def zipf_weights(n: int, alpha: float) -> np.ndarray:
    """P(expert k) proportional to (k+1)^-alpha, normalised."""
    w = np.arange(1, n + 1, dtype=np.float64) ** (-alpha)
    return w / w.sum()


def in_burst(t: float, arr: dict) -> bool:
    every, dur = arr.get("burst_every_s", 0.0), arr.get("burst_duration_s",
                                                         0.0)
    if every <= 0 or dur <= 0:
        return False
    return (t % every) < dur


def _rate(t: float, arr: dict) -> float:
    x = arr.get("burst_rate_x", 1.0) if in_burst(t, arr) else 1.0
    return arr["base_rate"] * x


def _lengths(rng, n: int, mix: list) -> np.ndarray:
    """n lengths from a mixture of uniform ranges [{weight, lo, hi}]."""
    w = np.asarray([m["weight"] for m in mix], np.float64)
    comp = rng.choice(len(mix), size=n, p=w / w.sum())
    lo = np.asarray([m["lo"] for m in mix])[comp]
    hi = np.asarray([m["hi"] for m in mix])[comp]
    return rng.integers(lo, hi + 1)


def arrivals(arr: dict, seconds: float, rng) -> np.ndarray:
    """Open-loop arrival times in [0, seconds): exponential gaps at the
    rate in effect at the current time (the original's process)."""
    out, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / max(_rate(t, arr), 1e-9)))
        if t >= seconds:
            return np.asarray(out)
        out.append(t)


def template(traffic: dict, n: int, seconds: float = 0.0) -> dict:
    """The seed-independent work: ``n`` (prompt length, output budget,
    expert) triples, and for an open loop the arrival times over
    ``seconds`` (n is then their count)."""
    rng = np.random.default_rng(traffic["template_seed"])
    arr = traffic["arrivals"]
    due = None
    if arr["kind"] == "open_loop":
        due = arrivals(arr, seconds, rng)
        n = len(due)
    ex = traffic["experts"]
    experts = rng.choice(ex["n"], size=n, p=zipf_weights(ex["n"],
                                                         ex["zipf_alpha"]))
    return {"prompt_len": _lengths(rng, n, traffic["prompt"]),
            "max_new": _lengths(rng, n, traffic["output"]),
            "expert": experts, "due": due}


def generate(traffic: dict, seed: int, vocab: int, n: int = 0,
             seconds: float = 0.0, uid0: int = 0) -> list:
    """The run's requests: the template's triples in the template's
    order, with prompt tokens from ``seed``.  Offline traffic
    (``arrivals.kind == "offline"``) gives ``n`` requests due at 0; an open
    loop gives every arrival of ``seconds``."""
    tpl = template(traffic, n, seconds)
    m = len(tpl["prompt_len"])
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), uid0])
    out = []
    for i in range(m):
        L = int(tpl["prompt_len"][i])
        out.append(Spec(uid=uid0 + i, expert=int(tpl["expert"][i]),
                        prompt=rng.integers(2, vocab, size=L),
                        max_new=int(tpl["max_new"][i]),
                        due=float(tpl["due"][i]) if tpl["due"] is not None
                        else 0.0))
    return out
