"""Window driver of the serving cells: the program's engine
(``repro_torch.api.serve`` -> ``ServeEngine.run``) over the cell's
traffic.

``arrivals.kind`` in the cell's file chooses the loop:

* ``offline``: a queue with every request due when its call starts, fed
  as successive ``run()`` calls of ``call_size`` requests until the
  window has passed; the window runs to the last completion of the last
  call;
* ``open_loop``: every arrival of the window's seconds, due at its time
  (``Request.arrival_s``), served by one ``run()``; the window runs to the
  last completion.

Set-up makes the base and the experts from the seed, builds the engine
and serves, for each batch size the traffic can form, one batch per
decode-step count a chunk can take, so that no CUDA graph is captured
in the window.
"""

from __future__ import annotations

import dataclasses
import time

from cardbench.lib import serving, traffic, weights


@dataclasses.dataclass
class State:
    cell: object
    cfg: dict
    seed: int
    dev: object
    model: object = None
    base: dict = None
    experts: list = None
    engine: object = None
    names: list = None
    deliveries: object = None
    merged: bool = False
    parts: dict = None


def setup(cell, seed: int, dev, warm: bool = True) -> State:
    from repro_torch import api
    from repro_torch.models import build
    from repro_torch.serve import Request
    w = cell.workload
    st = State(cell=cell, cfg=cell.config, seed=seed, dev=dev)
    stamp = serving.Stamps(dev)
    st.parts = stamp.parts
    st.model = build(serving.port_config(st.cfg))
    st.base = serving.make_base(st.cfg, st.model, seed, dev)
    stamp("base_s")
    ex = w["experts"]
    st.experts = serving.make_experts(st.cfg, st.base, seed, ex["n"], ex,
                                      dev)
    stamp("experts_s")
    st.names = [e.name for e in st.experts]
    reg = api.registry(experts=st.experts, device=dev,
                       device_cache_bytes=serving.packed_bytes(st.experts)
                       + (1 << 30))
    st.engine = api.serve(st.model, st.base, reg, **w["engine"])
    st.merged = w["engine"].get("scheduling") == "grouped"
    st.deliveries = serving.Deliveries(st.engine)
    stamp("engine_s")
    if warm:
        serving.warm(st.engine, Request, st.names, w["warm_rows"],
                     st.cfg["vocab_size"], w["engine"]["decode_chunk"],
                     one_expert=st.merged)
    stamp("warm_s")
    return st


def window(st: State, seconds: float, rec) -> None:
    """Serve the window; fills ``rec`` (see ``cardbench/run.py``)."""
    from repro_torch.serve import FAILED, Request
    w = st.cell.workload
    tr = w["traffic"]
    vocab = st.cfg["vocab_size"]
    eng, dl = st.engine, st.deliveries
    rec.leaves = [(t.numel(), t.element_size())
                  for t in weights.flatten(st.base).values()]
    rec.summary_before = eng.swap_summary()
    n_wave0, n_batch0 = len(eng.wave_log), len(eng.batch_log)
    swaps0 = _swaps_total(eng)
    swap_s0 = list(eng.swap_log)
    rec.tracked = []
    dl.record = rec.slice is not None
    if rec.slice is not None:
        dl.on_flush.append(_slice_control(rec, w, eng, dl))
    t_open = time.monotonic()
    rec.t_open = t_open
    if tr["arrivals"]["kind"] == "open_loop":
        specs = traffic.generate(tr, st.seed, vocab, seconds=seconds)
        calls = [specs]
    else:
        calls = None
    k = 0
    while True:
        if calls is None:
            specs = traffic.generate(tr, st.seed, vocab, n=w["call_size"],
                                     uid0=k * w["call_size"])
        else:
            specs = calls[k]
        reqs = serving.to_requests(specs, Request, st.names)
        t_call = time.monotonic()
        tracked = [serving.Tracked(spec=s, req=r, due=(t_call if calls is None
                                                       else t_open + s.due))
                   for s, r in zip(specs, reqs)]
        dl.active = tracked
        eng.run(reqs)
        for t in tracked:
            t.failed = t.req.status == FAILED
        rec.tracked += tracked
        k += 1
        if calls is not None or time.monotonic() - t_open >= seconds:
            break
    if rec.slice is not None and rec.slice.running:
        rec.slice.stop()
        rec.slice_flushes[1] = len(dl.flushes)
        rec.slice_swaps[1] = _swaps_total(eng)
    dl.active = []
    dl.on_flush.clear()
    ends = [t.last for t in rec.tracked if t.last is not None]
    rec.t_close = max(ends) if ends else time.monotonic()
    rec.summary_after = eng.swap_summary()
    rec.waves = eng.wave_log[n_wave0:]
    rec.batches = eng.batch_log[n_batch0:]
    rec.n_swaps = _swaps_total(eng) - swaps0
    rec.swap_seconds = [s["seconds"] for s in list(eng.swap_log)
                        if not any(s is x for x in swap_s0)]
    rec.flushes = dl.flushes
    rec.decode_chunk = w["engine"]["decode_chunk"]
    rec.attempted = len(rec.tracked)
    rec.failed = sum(t.failed for t in rec.tracked)


def _swaps_total(eng) -> int:
    s = eng.swap_summary()
    return s["n_swaps"] + s["log_dropped"].get("swap", 0)


def _slice_control(rec, w, eng, dl):
    """Start the traced slice at the window's first flush and stop it at
    the first flush ``trace_seconds`` later; the flushes and swaps in
    between are the slice's work."""
    span = w["trace_seconds"]

    def on_flush(now):
        sl = rec.slice
        if sl.prof is None:
            sl.start()
            rec.slice_flushes = [len(dl.flushes), None]
            rec.slice_swaps = [_swaps_total(eng), None]
        elif sl.running and now - sl.t0 >= span:
            sl.stop()
            rec.slice_flushes[1] = len(dl.flushes)
            rec.slice_swaps[1] = _swaps_total(eng)
    return on_flush


def check(st: State, rec, seed: int, control: bool = False) -> dict:
    """Frees the program's state, then holds a seeded sample of the
    served requests to the reference: {name: (reading, limit)}."""
    from cardbench.reference import serve_check
    w = st.cell.workload
    ck = w["check"]
    picks = serving.sample(rec.tracked, ck["requests"], seed)
    width = {u: b["prompt_len"] for b in rec.batches for u in b["uids"]}
    samples = [(t.spec.expert, t.spec.prompt, list(t.req.out_tokens),
                width.get(t.spec.uid, len(t.spec.prompt)) - len(t.spec.prompt)
                if st.merged else 0) for t in picks]
    merged_tree, merged_name = None, None
    if st.merged:
        merged_tree = weights.flatten(st.engine._merged_params)
        merged_name = st.engine._merged_name
    st.engine.chunk_hooks.clear()
    st.engine = st.experts = st.base = st.deliveries = None
    serving.free()
    ex = w["experts"]
    out = {}
    if merged_tree is not None and merged_name is not None:
        e = st.names.index(merged_name)
        r = serve_check.merged_tree_off(st.cfg, seed, e, merged_tree, st.dev,
                                        ex["density"], ex.get("alpha", 1.0))
        out["merged_off"] = r["merged_off"]
        del merged_tree
        serving.free()
    r = serve_check.check(st.cfg, seed, samples, st.dev, ex["density"],
                          ex.get("alpha", 1.0), st.merged,
                          capacity_factor=ck.get("capacity_factor"),
                          control=control)
    out.update(r)
    return out
