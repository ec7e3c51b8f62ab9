"""Paged KV in the port against the JAX package on the qwen2.5-3b smoke
config (one unit, f32): the block allocator and its arithmetic driven
through the same sequences, the paged cache write bitwise and the paged
attention partials within 1e-5, the paged decode step, and the paged
engine's greedy and sampled tokens equal to the reference engine's under
every scheduler (``tests/test_paged_kv.py``'s workload), with pool
oversubscription, the blocked head, impossible requests and the
``swap_summary()`` counts."""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.configs import get_smoke_config
from repro.models import Runtime, build
from repro.models import attention as jattn
from repro.serve import Request as JRequest
from repro.serve import paged_kv as jpaged
from repro_torch import api as tapi
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import build as t_build
from repro_torch.serve import DONE, FAILED, Request
from repro_torch.serve import paged_kv

RT = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")


# -- allocator and block arithmetic -------------------------------------------


def _drive(alloc, rng, steps=200):
    """A random alloc / free / bad-free sequence; returns what each step
    saw (ids granted or None, errors by type, and the counters)."""
    held: list = []
    seen = []
    n_blocks = alloc.n_blocks
    for _ in range(steps):
        op = rng.random()
        try:
            if op < 0.45:
                got = alloc.alloc(rng.randrange(0, 5))
                if got:
                    held.extend(got)
                out = ("alloc", got)
            elif op < 0.85 and held:
                k = rng.randrange(1, len(held) + 1)
                idx = sorted(rng.sample(range(len(held)), k))
                blocks = [held[i] for i in idx]
                held = [b for i, b in enumerate(held) if i not in idx]
                alloc.free(blocks)
                out = ("free", blocks)
            elif op < 0.93:
                alloc.free([rng.choice([0, -1, n_blocks, n_blocks + 7])])
                out = ("bad_free", None)
            else:
                free = alloc.state()
                alloc.free([free[0]] if free else [0])
                out = ("double_free", None)
        except ValueError as e:
            out = ("error", str(e))
        seen.append((out, alloc.available, alloc.in_use, alloc.peak_in_use,
                     alloc.state()))
    return seen


@pytest.mark.parametrize("n_blocks,seed", [(2, 0), (7, 1), (25, 2), (64, 3)])
def test_allocator_equals_reference(n_blocks, seed):
    ours = _drive(paged_kv.BlockAllocator(n_blocks, 8), random.Random(seed))
    ref = _drive(jpaged.BlockAllocator(n_blocks, 8), random.Random(seed))
    assert ours == ref
    assert any(o[0][0] == "error" for o in ours)


def test_allocator_state_round_trip_equals_reference():
    for cls in (paged_kv.BlockAllocator, jpaged.BlockAllocator):
        with pytest.raises(ValueError):
            cls(1, 8)
    a, b = paged_kv.BlockAllocator(9, 4), jpaged.BlockAllocator(9, 4)
    for x in (a, b):
        x.free(x.alloc(5)[1:3])
    assert a.state() == b.state()
    ra = paged_kv.BlockAllocator.from_state(9, 4, a.state())
    rb = jpaged.BlockAllocator.from_state(9, 4, b.state())
    assert (ra.state(), ra.in_use, ra.peak_in_use, ra.alloc(4)) == \
        (rb.state(), rb.in_use, rb.peak_in_use, rb.alloc(4))
    for bad in ([1, 1], [0, 2], [9]):
        with pytest.raises(ValueError):
            paged_kv.BlockAllocator.from_state(9, 4, bad)
        with pytest.raises(ValueError):
            jpaged.BlockAllocator.from_state(9, 4, bad)


def test_blocks_for_and_round_up_equal_reference():
    assert paged_kv.TRASH_BLOCK == jpaged.TRASH_BLOCK == 0
    for bs in (1, 3, 8, 16):
        for L in range(0, 41, 3):
            for new in (0, 1, 7, 16, 33):
                assert paged_kv.blocks_for(L, new, bs) == \
                    jpaged.blocks_for(L, new, bs)
            assert paged_kv.round_up(L, bs) == jpaged.round_up(L, bs)


# -- paged attention ------------------------------------------------------------


def _pools(seed, B=3, NB=9, BS=4, H=2, D=8, maxb=4):
    """Pools, block tables with unallocated (-1) entries, and row vectors
    with one dead row."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    v = rng.normal(size=(NB, BS, H, D)).astype(np.float32)
    tables = np.full((B, maxb), -1, np.int32)
    tables[0, :3] = [3, 1, 7]
    tables[1, :2] = [2, 8]
    tables[2, :4] = [4, 5, 6, 1]
    lens = np.asarray([9, 5, 14], np.int32)
    start = np.asarray([2, 0, 5], np.int32)
    active = np.asarray([True, True, False])
    return k, v, tables, lens, start, active


def test_paged_cache_write_bitwise_equals_reference():
    k, v, tables, lens, start, active = _pools(0)
    rng = np.random.default_rng(1)
    kn = rng.normal(size=(3, 1, 2, 8)).astype(np.float32)
    vn = rng.normal(size=(3, 1, 2, 8)).astype(np.float32)
    # a row whose write falls on an unallocated entry goes to the trash too
    lens_w = lens.copy()
    lens_w[1] = 17
    jk, jv = jattn.paged_cache_write(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lens_w), jnp.asarray(active), jnp.asarray(kn),
        jnp.asarray(vn))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tattn.paged_cache_write(tk, tv, torch.from_numpy(tables),
                            torch.from_numpy(lens_w),
                            torch.from_numpy(active), torch.from_numpy(kn),
                            torch.from_numpy(vn))
    # the trash block (0) aside, every block bitwise the reference's
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])
    # the live row wrote its token; the others wrote nothing outside trash
    np.testing.assert_array_equal(tk.numpy()[7, 1], kn[0, 0])
    np.testing.assert_array_equal(tk.numpy()[1:][np.arange(8) != 6],
                                  k[1:][np.arange(8) != 6])


@pytest.mark.parametrize("window,cap", [(None, None), (6, None),
                                        (None, 20.0), (3, 50.0)])
def test_paged_attention_partial_matches_reference(window, cap):
    k, v, tables, lens, start, active = _pools(2)
    q = np.random.default_rng(3).normal(size=(3, 1, 4, 8)).astype(np.float32)
    jcfg = dataclasses.replace(get_smoke_config("qwen2_5_3b").pattern[0].attn,
                               window=window, attn_softcap=cap)
    tcfg = dataclasses.replace(t_smoke("qwen2_5_3b").pattern[0].attn,
                               window=window, attn_softcap=cap)
    jo, jm, jl = jattn.paged_attention_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lens), jnp.asarray(start), jcfg)
    to, tm, tl = tattn.paged_attention_partial(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(tables), torch.from_numpy(lens),
        torch.from_numpy(start), tcfg)
    for a, b in ((to, jo), (tm, jm), (tl, jl)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        tattn.finalize_partial(to, tm, tl).numpy(),
        np.asarray(jattn.finalize_partial(jo, jm, jl)), rtol=1e-5,
        atol=1e-5)


# -- the paged decode step --------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    cfg = get_smoke_config("qwen2_5_3b", n_units=1)
    api = build(cfg)
    base = api.init(jax.random.PRNGKey(0))
    tbase = params_from_jax(jax.tree_util.tree_map(np.asarray, base),
                            device="cpu")
    return cfg, api, base, t_build(t_smoke("qwen2_5_3b", n_units=1)), tbase


def test_paged_decode_steps_match_reference(lm):
    """Two rows of one bucket prefilled into pool blocks (reference
    ``insert_prefill_rows`` against the port's in-place one), then decode
    steps at per-row positions, one row turning inactive: logits within
    f32 tolerance, pools and positions as the reference's."""
    cfg, api, base, model, tbase = lm
    BS, NB, maxb, lp = 8, 7, 3, 8
    rng = np.random.default_rng(4)
    toks = np.ones((2, lp), np.int32)
    toks[0, 3:] = rng.integers(2, cfg.vocab, 5)
    toks[1, 1:] = rng.integers(2, cfg.vocab, 7)
    start = np.asarray([3, 1], np.int32)
    blocks = np.asarray([[2, 5], [4, 1]], np.int32)
    tables = np.full((2, maxb), -1, np.int32)
    tables[:, :2] = blocks
    js = np.asarray([1, 0], np.int32)           # rows filled out of order
    jl, jrc = api.prefill(base, {"tokens": jnp.asarray(toks)}, RT, lp,
                          start=jnp.asarray(start))
    jc = jpaged.init_paged_cache(cfg, 2, NB, BS, maxb)
    jc = jpaged.insert_prefill_rows(
        jc, {n: {"k": s["k"], "v": s["v"]} for n, s in jrc["layers"].items()},
        jnp.asarray(js), jnp.asarray(blocks[:, :1]), jnp.asarray(tables),
        jnp.full((2,), lp, jnp.int32), jnp.asarray(start))
    tl, trc = model.prefill(tbase, {"tokens": torch.from_numpy(toks)}, lp,
                            start=torch.from_numpy(start))
    tc = paged_kv.init_paged_cache(model.cfg, 2, NB, BS, maxb, device="cpu")
    addr = [t.data_ptr() for t in (tc["layers"]["block0"]["k"],
                                   tc["tables"], tc["lens"], tc["active"])]
    paged_kv.insert_prefill_rows(
        tc, trc["layers"], torch.from_numpy(js),
        torch.from_numpy(blocks[:, :1]), torch.from_numpy(tables),
        torch.full((2,), lp, dtype=torch.int32), torch.from_numpy(start))
    assert addr == [t.data_ptr() for t in (tc["layers"]["block0"]["k"],
                                           tc["tables"], tc["lens"],
                                           tc["active"])]
    for name in ("tables", "lens", "start", "active"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    # the first tokens, from prefill order into batch rows
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[js, None]
    for step in range(5):
        if step == 3:                           # row 1's budget runs dry
            jc = dict(jc, active=jnp.asarray([True, False]))
            tc["active"].copy_(torch.tensor([True, False]))
        jl, jc = api.decode_step(base, jnp.asarray(tok), jc, RT)
        tl, _ = model.decode_step(tbase, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy()[:, -1], np.asarray(jl)[:, -1],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(tc["lens"].numpy(),
                                      np.asarray(jc["lens"]))
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for kv in ("k", "v"):
        np.testing.assert_allclose(
            tc["layers"]["block0"][kv].numpy()[:, 1:],
            np.asarray(jc["layers"]["block0"][kv])[:, 1:], rtol=1e-5,
            atol=1e-5)


# -- the paged engine against the reference engine ---------------------------------


@pytest.fixture(scope="module")
def setup(lm):
    cfg, api, base, model, tbase = lm
    rng = np.random.default_rng(11)
    taus = [jax.tree_util.tree_map(
        lambda l: (0.03 * rng.normal(size=l.shape)).astype(np.float32), base)
        for _ in range(3)]
    jreg = rapi.registry(experts=[
        rapi.compress(jax.tree_util.tree_map(jnp.asarray, t),
                      name=f"expert{i}", density=0.2)
        for i, t in enumerate(taus)])
    treg = tapi.registry(device="cpu", experts=[
        tapi.compress(params_from_jax(t, device="cpu"), name=f"expert{i}",
                      density=0.2, device="cpu") for i, t in enumerate(taus)])
    return cfg, api, base, jreg, model, tbase, treg


def _mk_reqs(cfg, n=6, n_experts=2, seed=0):
    """``tests/test_paged_kv.py::_mk_reqs``'s workload as (expert, prompt,
    budget) triples."""
    rng = np.random.default_rng(seed)
    return [(f"expert{i % n_experts}", rng.integers(1, cfg.vocab, 5 + 3 * (i % 3)),
             2 + i % 3) for i in range(n)]


ENGINE = dict(max_batch=3, cache_len=64, max_stack=2)


def _both(setup, traffic, **kw):
    """The same traffic through the reference engine and the port's;
    returns (reference requests, its summary, port requests, its
    engine)."""
    _, api, base, jreg, model, tbase, treg = setup
    kw = dict(ENGINE, **kw)
    jr = [JRequest(uid=i, expert=e, prompt=jnp.asarray(p, jnp.int32),
                   max_new_tokens=b) for i, (e, p, b) in enumerate(traffic)]
    je = rapi.serve(api, RT, base, jreg, **kw)
    je.run(jr)
    tr = [Request(uid=i, expert=e, prompt=p, max_new_tokens=b)
          for i, (e, p, b) in enumerate(traffic)]
    te = tapi.serve(model, tbase, treg, **kw)
    te.run(tr)
    return jr, je.swap_summary(), tr, te


def _same_counts(js, ts):
    assert ts["kv"] == js["kv"]
    for k in ("deferred", "queue_depth_max", "policy"):
        assert ts["scheduler"][k] == js["scheduler"][k], k
    assert ts["admitted"] == js["admitted"]
    assert sorted(ts["scheduler"]["admission_wait_s"]) == \
        sorted(js["scheduler"]["admission_wait_s"])


@pytest.mark.parametrize("chunk", [2, 4])
@pytest.mark.parametrize("sched", ["fifo", "priority", "affinity"])
def test_paged_tokens_equal_reference_engine(setup, sched, chunk):
    """6 requests over 3 slots (mid-wave admissions) on block pools of 8
    positions: every stream and the summary counts equal the reference
    engine's."""
    jr, js, tr, te = _both(setup, _mk_reqs(setup[0]), kv_layout="paged",
                           kv_block_size=8, scheduler=sched,
                           decode_chunk=chunk)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.status == DONE for r in tr)
    ts = te.swap_summary()
    _same_counts(js, ts)
    assert ts["admitted"] >= 1 and ts["kv"]["blocks_in_use"] == 0
    assert ts["graph_captures"] == 0            # the CPU runs the plain loop


def test_paged_sampled_streams_equal_reference_engine(setup):
    jr, js, tr, te = _both(setup, _mk_reqs(setup[0]), kv_layout="paged",
                           kv_block_size=8, scheduler="affinity",
                           decode_chunk=2, temperature=0.8, top_k=5, seed=7)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    _same_counts(js, te.swap_summary())


def test_paged_pool_oversubscription_equals_reference(setup):
    """7 pool blocks (6 usable) for a wave that needs more: the overflow
    re-queues; tokens and counts equal the reference's."""
    jr, js, tr, te = _both(setup, _mk_reqs(setup[0]), kv_layout="paged",
                           kv_block_size=8, kv_blocks=7,
                           scheduler="priority", decode_chunk=2)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    kv = te.swap_summary()["kv"]
    assert kv["blocks_total"] == 6 and kv["blocks_peak"] <= 6
    _same_counts(js, te.swap_summary())


def _blocked_head(cfg):
    """``tests/test_paged_kv.py``'s blocked head: with 6 usable blocks the
    wave holds uid 0 (3 blocks) and uid 1 (2); when uid 1 ends, the head
    uid 2 needs 5 > 3 free, while uid 3 needs 2."""
    rng = np.random.default_rng(0)
    return [("expert0", rng.integers(1, cfg.vocab, 6), 10),
            ("expert0", np.asarray([5, 6, 7]), 2),
            ("expert0", rng.integers(1, cfg.vocab, 30), 8),
            ("expert0", np.asarray([8, 9, 10]), 2)]


@pytest.mark.parametrize("sched", ["priority", "fifo"])
def test_blocked_head_as_in_reference(setup, sched):
    kw = dict(kv_layout="paged", kv_block_size=8, kv_blocks=7, max_batch=2,
              decode_chunk=2, scheduler=sched)
    jr, js, tr, te = _both(setup, _blocked_head(setup[0]), **kw)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    order = lambda rs: sorted(range(4), key=lambda i: rs[i].t_first_s)  # noqa
    assert order(tr) == order(jr)
    deferred = te.swap_summary()["scheduler"]["deferred"]
    if sched == "priority":
        assert tr[3].t_first_s < tr[2].t_first_s and deferred >= 1
    else:
        assert tr[2].t_first_s < tr[3].t_first_s and deferred == 0
    _same_counts(js, te.swap_summary())


def test_impossible_request_fails_alone(setup):
    traffic = [("expert0", np.arange(2, 40), 60), ("expert0",
                                                   np.asarray([5, 6, 7]), 2)]
    jr, js, tr, te = _both(setup, traffic, kv_layout="paged",
                           kv_block_size=8, decode_chunk=2)
    assert [r.status for r in tr] == [FAILED, DONE] == \
        [r.status for r in jr]
    assert tr[0].error and tr[0].out_tokens == []
    assert tr[1].out_tokens == jr[1].out_tokens and len(tr[1].out_tokens) == 2
    assert te.swap_summary()["kv"] == js["kv"]


def test_summary_surface_as_reference(setup):
    """``swap_summary()`` carries the reference's serving gauges: KV
    occupancy, per-priority admission waits and the stack hit rate."""
    _, _, _, _, model, tbase, treg = setup
    eng = tapi.serve(model, tbase, treg, kv_layout="paged", kv_block_size=8,
                     scheduler="affinity", decode_chunk=2, **ENGINE)
    eng.run([Request(uid=i, expert=e, prompt=p, max_new_tokens=b)
             for i, (e, p, b) in enumerate(_mk_reqs(setup[0]))])
    s = eng.swap_summary()
    assert 0.0 <= s["stack_hit_rate"] <= 1.0
    assert s["scheduler"]["policy"] == "affinity"
    assert s["scheduler"]["queue_depth_max"] >= 1
    for wait in s["scheduler"]["admission_wait_s"].values():
        assert wait["n"] >= 1 and wait["max"] >= wait["mean"] >= 0.0
    assert s["kv"]["layout"] == "paged" and s["kv"]["block_size"] == 8
    assert s["kv"]["blocks_in_use"] == 0 and s["kv"]["blocks_peak"] >= 1
    dense = tapi.serve(model, tbase, treg, **ENGINE).swap_summary()["kv"]
    assert dense["layout"] == "dense" and dense["blocks_total"] is None


def test_paged_engine_keeps_its_buffers(setup):
    """A second run of a warm paged engine writes the same kept buffers
    (a CUDA graph reads them by address) and repeats its tokens."""
    _, _, _, _, model, tbase, treg = setup
    eng = tapi.serve(model, tbase, treg, kv_layout="paged", kv_block_size=8,
                     decode_chunk=4, **ENGINE)
    runs, addrs = [], []
    for _ in range(2):
        reqs = [Request(uid=i, expert=e, prompt=p, max_new_tokens=b)
                for i, (e, p, b) in enumerate(_mk_reqs(setup[0]))]
        eng.run(reqs)
        runs.append([r.out_tokens for r in reqs])
        st = eng._paged_states[3]
        addrs.append([st["tok"].data_ptr(), st["cache"]["tables"].data_ptr(),
                      st["cache"]["layers"]["block0"]["k"].data_ptr()])
    assert runs[0] == runs[1] and addrs[0] == addrs[1]
    assert not eng._states                      # no dense buffers were made


@pytest.mark.parametrize("option", [
    {"kv_layout": "paged"}, {"scheduler": "priority"},
    {"scheduler": "affinity"}])
def test_item_7_options_are_served(setup, option):
    _, _, _, _, model, tbase, treg = setup
    eng = tapi.serve(model, tbase, treg, max_batch=2, cache_len=32, **option)
    reqs = [Request(uid=0, expert="expert1", prompt=[5, 6, 7],
                    max_new_tokens=3)]
    eng.run(reqs)
    assert reqs[0].status == DONE and len(reqs[0].out_tokens) == 3


@pytest.mark.parametrize("option,match", [
    ({"kv_layout": "paged", "decode_chunk": 0}, "decode_chunk"),
    ({"kv_layout": "paged", "kv_block_size": 0}, "kv_block_size"),
    ({"kv_layout": "paged", "kv_blocks": 1}, "kv_blocks"),
    ({"kv_layout": "ring"}, "kv_layout"),
    ({"scheduler": "lottery"}, "unknown scheduler")])
def test_bad_paged_options_raise_as_reference(setup, option, match):
    _, api, base, jreg, model, tbase, treg = setup
    with pytest.raises(ValueError, match=match):
        tapi.serve(model, tbase, treg, **option)
    with pytest.raises(ValueError):
        rapi.serve(api, RT, base, jreg, **option)


def test_paged_needs_windows_at_least_cache_len():
    cfg = t_smoke("gemma2_9b", n_units=1)
    model = t_build(cfg)
    win = min(b.attn.window for b in cfg.pattern if b.attn.window)
    from repro_torch.serve import EngineConfig
    from repro_torch.serve.engine import _check_paged
    with pytest.raises(ValueError, match="windows"):
        _check_paged(model.cfg, EngineConfig(kv_layout="paged",
                                             cache_len=win + 1))
    _check_paged(model.cfg, EngineConfig(kv_layout="paged", cache_len=win))
