"""Continuous admission (slot refill) and the eager per-token loop in the
port, against the reference ``ServeEngine`` with ``continuous=True`` on
the qwen2.5-3b smoke config at the sizes of ``tests/test_decode_loop.py``
(f32, greedy): token streams and ``admitted`` counts equal for every
chunk size, admitted rows equal to their solo serves, the FIFO
head-of-line blocks, the FIFO scheduler, and the device-resident decode
position past a ring wrap."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.configs import get_smoke_config
from repro.models import Runtime, build
from repro.serve import Request as JRequest
from repro.serve.scheduler import FIFOScheduler as JFIFOScheduler
from repro_torch import api as tapi
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import build as t_build
from repro_torch.expert import PACKED
from repro_torch.serve import BASE, Request
from repro_torch.serve.scheduler import FIFOScheduler, make_scheduler
from repro_torch.transport import InMemoryTransport

RT = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")
ENGINE = dict(max_batch=3, cache_len=64)      # as tests/test_decode_loop.py
NAMES = ["e0", "e1", BASE, "e2", "e0", "e1", "e2"]


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("qwen2_5_3b", n_units=1)
    api = build(cfg)
    base = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    taus = [jax.tree_util.tree_map(
        lambda l: (0.03 * rng.normal(size=l.shape)).astype(np.float32), base)
        for _ in range(3)]
    jreg = rapi.registry(experts=[
        rapi.compress(jax.tree_util.tree_map(jnp.asarray, t), name=f"e{i}",
                      density=0.2) for i, t in enumerate(taus)])
    treg = tapi.registry(device="cpu", experts=[
        tapi.compress(params_from_jax(t, device="cpu"), name=f"e{i}",
                      density=0.2, device="cpu") for i, t in enumerate(taus)])
    tbase = params_from_jax(jax.tree_util.tree_map(np.asarray, base),
                            device="cpu")
    model = t_build(t_smoke("qwen2_5_3b", n_units=1))
    return cfg, api, base, jreg, model, tbase, treg


def _traffic(cfg, seed=0, names=NAMES, lens=None, budgets=None):
    """(expert, prompt, budget) triples: prompts of 6-10 tokens and
    budgets of 2-4, as ``tests/test_decode_loop.py::_mk_reqs``."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(names):
        L = lens[i] if lens else 6 + 2 * (i % 3)
        out.append((n, rng.integers(1, cfg.vocab, L),
                    budgets[i] if budgets else 2 + i % 3))
    return out


def _jserve(setup, traffic, **kw):
    _, api, base, jreg, _, _, _ = setup
    reqs = [JRequest(uid=i, expert=n, prompt=jnp.asarray(p, jnp.int32),
                     max_new_tokens=b) for i, (n, p, b) in enumerate(traffic)]
    eng = rapi.serve(api, RT, base, jreg, **kw)
    eng.run(reqs)
    return reqs, eng.swap_summary()


def _tserve(setup, traffic, engine=None, **kw):
    _, _, _, _, model, tbase, treg = setup
    reqs = [Request(uid=i, expert=n, prompt=p, max_new_tokens=b)
            for i, (n, p, b) in enumerate(traffic)]
    eng = engine or tapi.serve(model, tbase, treg, **kw)
    eng.run(reqs)
    return reqs, eng


_REF: dict = {}


def _reference(setup, chunk):
    """The reference engine's streams for the default traffic, once per
    chunk size (admissions happen at chunk boundaries)."""
    if chunk not in _REF:
        _REF[chunk] = _jserve(setup, _traffic(setup[0]), decode_chunk=chunk,
                              **ENGINE)
    return _REF[chunk]


def test_port_defaults_to_continuous_admission():
    from repro_torch.serve import EngineConfig
    assert EngineConfig().continuous is True
    assert EngineConfig().decode_chunk == 16


@pytest.mark.parametrize("chunk", [0, 1, 4, 16])
def test_tokens_and_admissions_equal_reference_engine(setup, chunk):
    """7 requests over 3 slots: rows finish and newcomers are spliced in,
    one of them with an expert the wave did not hold (the overlay grows
    by a slot).  Every stream and the admission count equal the
    reference's at the same chunk size."""
    jr, jsum = _reference(setup, chunk)
    tr, eng = _tserve(setup, _traffic(setup[0]), decode_chunk=chunk,
                      **ENGINE)
    for a, b in zip(jr, tr):
        assert b.out_tokens == a.out_tokens, (chunk, b.uid)
        assert b.status == "done"
    s = eng.swap_summary()
    assert s["admitted"] == jsum["admitted"] >= 1
    assert s["n_waves"] == jsum["n_waves"]
    assert s["graph_captures"] == 0            # the CPU runs the plain loop


def test_streams_do_not_depend_on_chunk_size(setup):
    """The port's own contract, one engine per chunk size: greedy chunked
    decode equals the eager per-token loop, admissions included."""
    streams = [[r.out_tokens for r in _tserve(
        setup, _traffic(setup[0], seed=3), decode_chunk=k, **ENGINE)[0]]
        for k in (0, 2, 3, 16)]
    assert all(s == streams[0] for s in streams[1:])


def test_every_admitted_row_equals_its_solo_serve(setup):
    """Bitwise at f32: each request spliced into a running wave gets the
    tokens it gets alone (max_batch=1, no admission)."""
    traffic = _traffic(setup[0], seed=5)
    tr, eng = _tserve(setup, traffic, decode_chunk=4, **ENGINE)
    assert eng.swap_summary()["admitted"] >= 1
    solo_eng = tapi.serve(setup[4], setup[5], setup[6], max_batch=1,
                          cache_len=64, continuous=False)
    for r in tr:
        solo = Request(uid=100 + r.uid, expert=r.expert, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens)
        solo_eng.run([solo])
        assert solo.out_tokens == r.out_tokens, r.uid


def test_admitted_row_matches_solo_serve(setup):
    """Mirror of tests/test_serving.py::test_admitted_row_matches_solo_serve:
    a shorter prompt spliced into a one-slot wave (left-padded, pads
    masked) gets its solo tokens."""
    cfg, _, _, _, model, tbase, treg = setup
    rng = np.random.default_rng(7)
    pa, pb = rng.integers(1, cfg.vocab, 9), rng.integers(1, cfg.vocab, 5)
    a = Request(uid=0, expert="e0", prompt=pa, max_new_tokens=3)
    b = Request(uid=1, expert="e1", prompt=pb, max_new_tokens=4)
    eng = tapi.serve(model, tbase, treg, max_batch=1, cache_len=64)
    eng.run([a, b])
    assert eng.swap_summary()["admitted"] == 1
    assert eng.swap_summary()["n_waves"] == 1
    solo = Request(uid=2, expert="e1", prompt=pb, max_new_tokens=4)
    tapi.serve(model, tbase, treg, max_batch=1, cache_len=64).run([solo])
    assert b.out_tokens == solo.out_tokens
    assert b.t_admit_s >= a.t_admit_s and b.t_first_s >= b.t_admit_s
    assert b.t_done_s >= b.t_first_s


@pytest.mark.parametrize("chunk", [0, 16])
def test_admitted_row_keeps_first_token(setup, chunk):
    """Mirror of tests/test_serving.py::test_admitted_row_keeps_first_token:
    the newcomer's first token is the argmax of its left-padded, masked
    prefill at the wave position, then one decode step follows."""
    cfg, _, _, _, model, tbase, treg = setup
    rng = np.random.default_rng(5)
    pa, pb = rng.integers(1, cfg.vocab, 8), rng.integers(1, cfg.vocab, 6)
    a = Request(uid=0, expert="e0", prompt=pa, max_new_tokens=1)
    b = Request(uid=1, expert="e1", prompt=pb, max_new_tokens=2)
    eng = tapi.serve(model, tbase, treg, max_batch=1, cache_len=32,
                     decode_chunk=chunk)
    eng.run([a, b])
    assert eng.swap_summary()["admitted"] == 1

    overlay = eng._overlay_for(("e0", "e1"))
    eid = torch.tensor([eng.slot_of("e1")], dtype=torch.int32)
    padded = torch.ones((1, 8), dtype=torch.int64)
    padded[0, 2:] = torch.as_tensor(pb)
    logits, cache = model.prefill(tbase, {"tokens": padded}, 32,
                                  delta=overlay, eid=eid,
                                  start=torch.tensor([2], dtype=torch.int32))
    t1 = int(torch.argmax(logits[0, -1]))
    logits2, _ = model.decode_step(tbase, torch.tensor([[t1]],
                                                       dtype=torch.int32),
                                   cache, delta=overlay, eid=eid)
    assert b.out_tokens == [t1, int(torch.argmax(logits2[0, -1]))]


# one case per reason that blocks the FIFO head (max_batch, extra engine
# options, prompt lengths, budgets, experts); a request placeable behind
# the blocked head waits too
BLOCKS = {
    "position": (1, {}, (5, 9, 4), (2, 2, 2), ["e0", "e1", "e0"]),
    "wrap": (1, {"cache_len": 24}, (8, 4, 4), (2, 20, 2),
             ["e0", "e1", "e2"]),
    "stack": (2, {"max_stack": 1}, (6, 6, 5, 5), (2, 4, 2, 2),
              ["e0", "e0", "e1", "e0"]),
}


@pytest.mark.parametrize("reason", sorted(BLOCKS))
def test_blocked_head_as_in_reference(setup, reason):
    batch, extra, lens, budgets, names = BLOCKS[reason]
    kw = dict({"cache_len": 64}, max_batch=batch, decode_chunk=4, **extra)
    traffic = _traffic(setup[0], seed=9, names=names, lens=lens,
                       budgets=budgets)
    jr, jsum = _jserve(setup, traffic, **kw)
    tr, eng = _tserve(setup, traffic, **kw)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    s = eng.swap_summary()
    assert (s["admitted"], s["n_waves"]) == (jsum["admitted"],
                                             jsum["n_waves"])
    assert s["n_waves"] >= 2
    # the head the first wave met, at the position it met it
    first = eng.wave_log[0]
    head = tr[first["rows"]]
    cur = first["prompt_len"] + budgets[0] - 1
    slot = {n: 0 for n in names[:first["rows"]]}
    assert eng._admission_block_reason(head, cur, slot) == reason


@pytest.mark.parametrize("store", ["local", "remote"])
def test_unknown_admission_fails_only_itself(setup, store):
    """A queued request naming an expert that cannot be promoted, met at a
    free slot: on a local store the unknown name raises ``KeyError``, in
    the port as in the reference; on a remote store whose transport lacks
    it, only that request fails and the requests behind it are admitted
    and served."""
    cfg, treg = setup[0], setup[-1]
    traffic = _traffic(cfg, seed=4, names=["e0", "nope", "e1"],
                       lens=(8, 6, 6), budgets=(2, 2, 3))
    kw = dict(max_batch=1, cache_len=64, decode_chunk=4)
    if store == "local":
        with pytest.raises(KeyError):
            _jserve(setup, traffic, **kw)
        with pytest.raises(KeyError):
            _tserve(setup, traffic, **kw)
        return
    tr = InMemoryTransport()
    for n in ("e0", "e1"):
        tapi.publish(treg.get(n), tr, rep=PACKED)
    _, _, _, _, model, tbase, _ = setup
    eng = tapi.serve(model, tbase, tapi.registry(transport=tr, device="cpu"),
                     **kw)
    tr_reqs, eng = _tserve(setup, traffic, engine=eng)
    assert [r.status for r in tr_reqs] == ["done", "failed", "done"]
    assert "nope" in tr_reqs[1].error and tr_reqs[1].out_tokens == []
    s = eng.swap_summary()
    assert (s["admitted"], s["failed"]) == (1, 1)
    assert len(tr_reqs[2].out_tokens) == 3


def test_fifo_scheduler_equals_reference():
    """Wave composition and arrival release over the same seeded traffic:
    future arrivals, a stack budget that cuts waves, removals."""
    rng = np.random.default_rng(0)
    experts = ["a", "b", "c", "d", BASE]
    spec = [(i, experts[int(rng.integers(0, 5))],
             float(rng.choice([0.0, 0.0, 0.3, 0.7, 1.1])))
            for i in range(24)]
    ours, ref = FIFOScheduler(), JFIFOScheduler()
    for s in (ours, ref):
        for uid, e, t in spec:
            s.push(Request(uid=uid, expert=e, prompt=[1], arrival_s=t))
    uids = lambda rs: [r.uid for r in rs]                 # noqa: E731
    for now in (0.0, 0.5, 0.8, 2.0):
        ours.release(now)
        ref.release(now)
        assert (ours.pending(), ours.ready_count(), ours.next_arrival()) == \
            (ref.pending(), ref.ready_count(), ref.next_arrival())
        assert uids(ours.peek(5)) == uids(ref.peek(5))
        assert uids(ours.candidates({})) == uids(ref.candidates({}))
        for batch, stack in ((3, 2), (4, 1)):
            w, e = ours.take_wave(batch, stack)
            jw, je = ref.take_wave(batch, stack)
            assert (uids(w), e) == (uids(jw), je)
        if ours.ready_count():
            head = ours.candidates({})[0]
            ours.remove(head)
            ref.remove(ref.candidates({})[0])
    assert ours.stats() == {k: v for k, v in ref.stats().items()}
    assert make_scheduler("fifo").strict_fifo
    assert not make_scheduler("priority").strict_fifo
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_scheduler("lottery")


def test_decode_step_device_position_past_ring_wrap(setup):
    """``cache["cur"]`` lives on the device and advances in place; the
    ring slot is taken there, so decoding past a wrap of an 8-slot ring
    matches the reference step for step."""
    cfg, api, base, _, model, tbase, _ = setup
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab, (2, 6)).astype(np.int32)
    start = np.asarray([0, 2], np.int32)
    jl, jc = api.prefill(base, {"tokens": jnp.asarray(toks)}, RT, 8,
                         start=jnp.asarray(start))
    tl, tc = model.prefill(tbase, {"tokens": torch.from_numpy(toks)}, 8,
                           start=torch.from_numpy(start))
    cur = tc["cur"]
    assert cur.dim() == 0 and cur.dtype == torch.int32 and int(cur) == 6
    for step in range(7):                 # positions 6..12: wraps at 8
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = api.decode_step(base, jnp.asarray(tok), jc, RT)
        tl, tc = model.decode_step(tbase, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=2e-5)
        assert tc["cur"] is cur and int(cur) == int(jc["cur"]) == 7 + step
    for name, layer in jc["layers"].items():
        np.testing.assert_array_equal(tc["layers"][name]["pos"].numpy(),
                                      np.asarray(layer["pos"]))
        np.testing.assert_allclose(tc["layers"][name]["k"].numpy(),
                                   np.asarray(layer["k"]), rtol=1e-5,
                                   atol=2e-5)


def test_warm_engine_keeps_its_buffers(setup):
    """The engine writes every wave, admission and swap into buffers it
    keeps (what a CUDA graph reads by address): a second wave of another
    expert set of the same size and a merge-path swap leave every kept
    tensor where it was."""
    cfg, _, _, _, model, tbase, treg = setup
    eng = tapi.serve(model, tbase, treg, max_batch=3, cache_len=64,
                     decode_chunk=4)
    _tserve(setup, _traffic(cfg, names=["e0", "e1", "e2", "e0"]),
            engine=eng)
    st = eng._states[3]
    ptrs = [t.data_ptr() for t in (st["tok"], st["eid"], st["keys"],
                                   st["gen"], st["cache"]["cur"],
                                   st["cache"]["start"])]
    kv = st["cache"]["layers"]["block0"]["k"].data_ptr()
    overlay = eng._slots.overlay
    _tserve(setup, _traffic(cfg, seed=1, names=[BASE, "e2", "e1", "e1"]),
            engine=eng)
    assert eng._states[3] is st and eng._slots.overlay is overlay
    assert [t.data_ptr() for t in (st["tok"], st["eid"], st["keys"],
                                   st["gen"], st["cache"]["cur"],
                                   st["cache"]["start"])] == ptrs
    assert st["cache"]["layers"]["block0"]["k"].data_ptr() == kv
    s = eng.swap_summary()
    assert s["stack_hits"] >= 3 and s["slot_bytes"] > 0
    g = tapi.serve(model, tbase, treg, scheduling="grouped", max_batch=2,
                   cache_len=64, decode_chunk=4)
    _tserve(setup, _traffic(cfg, names=["e0", "e1", "e0"]), engine=g)
    leaf = g._merged_params["embed"]
    ptr = leaf.data_ptr()
    _tserve(setup, _traffic(cfg, seed=2, names=["e2", "e1"]), engine=g)
    assert g._merged_params["embed"] is leaf and leaf.data_ptr() == ptr
    assert g.swap_summary()["n_swaps"] == 4
