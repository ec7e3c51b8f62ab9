"""What the serving cells share: the system under test set up from the
seed, the deliveries seen from outside the engine, and the check.

The engine is the program's (``repro_torch.api.serve``); the benchmark
gives it weights and fine-tunes of its own making
(:mod:`cardbench.lib.weights`), the experts compressed by the program's
``api.compress(...).as_(PACKED)``.  A token is delivered when the chunk
flush that carries it reaches the host: :class:`Deliveries` is called by
the engine's ``chunk_hooks`` after every flush and stamps each request's
first and last delivery on the host clock, so TTFT and TPOT never read
the engine's own stamps.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Optional

import numpy as np

from cardbench.lib import weights


@dataclasses.dataclass
class Tracked:
    """A request as the benchmark sees it."""
    spec: object                   # cardbench.lib.traffic.Spec
    req: object                    # the engine's Request
    due: float = 0.0               # host clock
    first: Optional[float] = None  # host clock of the first delivery
    last: Optional[float] = None
    tokens: int = 0
    failed: bool = False

    @property
    def budget(self) -> int:
        return self.spec.max_new

    @property
    def served(self) -> bool:
        return not self.failed and self.tokens > 0


class Deliveries:
    """Called after every chunk flush: stamps deliveries, records what
    each flush carried (for the traced slice's work), and lets the traced
    slice start and stop at a flush, where the device is idle."""

    def __init__(self, engine):
        self.active: list = []
        self.flushes: list = []     # (time, [(tracked, new tokens)])
        self.record = False
        self.on_flush = []          # callables (now) run after the stamps
        engine.chunk_hooks.append(self)

    def __call__(self, chunk_idx: int) -> None:
        now = time.monotonic()
        carried = []
        for t in self.active:
            n = len(t.req.out_tokens)
            if n > t.tokens:
                if t.first is None:
                    t.first = now
                t.last = now
                carried.append((t, n - t.tokens))
                t.tokens = n
        if self.record:
            self.flushes.append((now, carried))
        for f in list(self.on_flush):
            f(now)


class Stamps:
    """Seconds of each step of a set-up, each ended by a sync, so the
    card's queued work is counted in the step that queued it."""

    def __init__(self, dev):
        self.dev = dev
        self.parts: dict = {}
        self.t = time.monotonic()

    def __call__(self, name: str) -> None:
        import torch
        if torch.device(self.dev).type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.monotonic()
        self.parts[name] = now - self.t
        self.t = now


def port_config(cfg: dict):
    """The program's ModelConfig for a configuration file: the program's
    registered architecture (``port_arch``: its block kinds, family and
    rules) at the file's sizes and depth."""
    from repro_torch.configs.registry import get_config
    mc = get_config(cfg["port_arch"])
    b = mc.pattern[0]
    win = cfg.get("sliding_window") if cfg.get("use_sliding_window", True) \
        else None
    attn = dataclasses.replace(
        b.attn, n_q=cfg["num_attention_heads"],
        n_kv=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        qkv_bias=bool(cfg.get("qkv_bias", False)),
        rope_theta=float(cfg["rope_theta"]), window=win)
    f = cfg["intermediate_size"]
    if b.ffn.moe is not None:
        ffn = dataclasses.replace(b.ffn, d_ff=f, moe=dataclasses.replace(
            b.ffn.moe, n_experts=cfg["num_local_experts"],
            top_k=cfg["num_experts_per_tok"], d_ff_expert=f,
            capacity_factor=cfg["moe_capacity_factor"]))
    else:
        ffn = dataclasses.replace(b.ffn, d_ff=f)
    return dataclasses.replace(
        mc, d_model=cfg["hidden_size"], vocab=cfg["vocab_size"],
        n_units=cfg["num_hidden_layers"],
        tie_embeddings=cfg["tie_word_embeddings"],
        rms_eps=float(cfg["rms_norm_eps"]), dtype=cfg["torch_dtype"],
        pattern=(dataclasses.replace(b, attn=attn, ffn=ffn),))


def make_base(cfg: dict, model, seed: int, dev) -> dict:
    """The base weights, checked against the program's parameter tree."""
    base = weights.base_tree(cfg, seed, dev)
    meta = weights.flatten(model.init(seed=0, device="meta"))
    got = weights.flatten(base)
    want = {p: (tuple(t.shape), t.dtype) for p, t in meta.items()}
    have = {p: (tuple(t.shape), t.dtype) for p, t in got.items()}
    if want != have:
        raise ValueError(f"parameter tree differs from the program's: "
                         f"{set(want.items()) ^ set(have.items())}")
    return base


def make_experts(cfg: dict, base: dict, seed: int, n: int, exp: dict, dev):
    """n fine-tunes of the base from the seed, each compressed by the
    program's ``api.compress(base, ft).as_(PACKED)``; the dense forms are
    dropped as soon as each is packed."""
    from repro_torch import api
    from repro_torch.expert import DENSE, PACKED
    flat = weights.flatten(base)
    out = []
    for e in range(n):
        free()      # the last compression's buffers, so the next one fits
        ft = weights.finetune_tree(cfg, flat, seed, e)
        ex = api.compress(base, ft, name=f"x{e}", density=exp["density"],
                          alpha=exp.get("alpha", 1.0), device=dev)
        del ft
        ex.as_(PACKED)
        ex.drop(DENSE)
        out.append(ex)
    return out


def packed_bytes(experts) -> int:
    """Bytes of the experts' packed planes and scales."""
    return sum(pt.packed_bytes for ex in experts
               for pt in weights.flatten(ex.as_("packed")).values())


def to_requests(specs: list, Request, names: list) -> list:
    import torch
    return [Request(uid=s.uid, expert=names[s.expert],
                    prompt=torch.as_tensor(s.prompt, dtype=torch.int64),
                    max_new_tokens=s.max_new, arrival_s=s.due)
            for s in specs]


def warm(engine, Request, names: list, rows: list, vocab: int,
         chunk: int, one_expert: bool, uid0: int = -(10 ** 9)) -> None:
    """Serve, for every batch size in ``rows``, one batch per decode-step
    count a chunk can take (budgets chunk + 1 .. 2 * chunk: a first chunk
    of ``chunk`` steps, then one of 0 .. chunk - 1), so every CUDA graph
    the cell's traffic can ask for is captured before the window.  On the
    merge path (``one_expert``) a batch holds one expert's rows."""
    import torch
    g = torch.Generator().manual_seed(0)
    uid = uid0
    for R in rows:
        for extra in range(chunk):
            reqs = []
            for j in range(R):
                reqs.append(Request(
                    uid=uid, expert=names[0 if one_expert else j % len(names)],
                    prompt=torch.randint(2, vocab, (16,), generator=g),
                    max_new_tokens=chunk + 1 + extra))
                uid += 1
            engine.run(reqs)


def free() -> None:
    """Collect what the caller dropped (engines sit in reference cycles)
    and give the card's cached memory back."""
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def sample(tracked: list, k: int, seed: int) -> list:
    """k served requests drawn from the seed, the longest (prompt plus
    tokens) among them."""
    served = [t for t in tracked if t.served]
    if not served:
        return []
    longest = max(served, key=lambda t: len(t.spec.prompt) + t.tokens)
    rest = [t for t in served if t is not longest]
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 77])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) \
        if rest else []
    return [longest] + [rest[i] for i in sorted(pick)]
