"""Durability in the port, held against the reference: the write-ahead
journal byte for byte, checkpoints read across the packages, the fault
classes, the reference's five kill-restart cases on the port's engine
(tokens equal to the reference engine's uninterrupted run, the
``RecoveryPlan`` equal to the reference's resume of the same case), a
journal and snapshot of either package resumed in the other, and the
SIGKILL child once on the CPU.  The smoke config of qwen2.5-3b with one
unit, weights carried across with ``convert.py``."""

import dataclasses
import os
import signal
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.checkpoint import manager as jmanager
from repro.configs import get_smoke_config
from repro.distributed import fault as jfault
from repro.models import Runtime, build
from repro.serve import Request as JRequest
from repro.serve import journal as jjournal
from repro.transport import InMemoryTransport as JInMemoryTransport
from repro_torch import api as tapi
from repro_torch import tree as tree_util
from repro_torch.checkpoint import manager as tmanager
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.distributed import fault as tfault
from repro_torch.expert import PACKED
from repro_torch.models import build as t_build
from repro_torch.serve import DONE, Request
from repro_torch.serve import journal as tjournal
from repro_torch.serve.restart_child import write_setup
from repro_torch.transport import InMemoryTransport

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RT = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")
KW = dict(max_batch=4, cache_len=32, decode_chunk=2)
PAGED = dict(kv_layout="paged", scheduler="affinity", temperature=0.8,
             top_k=20, seed=7)
# 8 tokens = 4 chunks at decode_chunk 2: a kill at chunk 3 lands mid
# generation, with rows admitted after the last snapshot
STREAM = ["e0", "e1", "e2", "e0", "e1", "e2"]


# ---------------------------------------------------------------------------
# the journal file
# ---------------------------------------------------------------------------

RECORDS = [
    ("run_start", {"requests": [{"uid": 0, "prompt": [3, 4]},
                                {"uid": 1, "prompt": [5]}],
                   "sampling": {"temperature": 0.8, "top_k": 0, "seed": 7}},
     0.0),
    ("sched", {"event": "take_wave", "policy": "fifo", "uids": [0, 1]},
     0.125),
    ("admit", {"uid": 0, "expert": "e0", "slot": 0, "arrival_s": 0.0,
               "prompt_len": 2}, 0.25),
    ("chunk", {"i": 1, "rows": [{"uid": 0, "n": 2, "toks": [5, 7],
                                 "total": 2}]}, 0.5),
    ("chunk", {"i": 2, "rows": [{"uid": 0, "n": 1, "toks": [3],
                                 "total": 3},
                                {"uid": 1, "n": 2, "toks": [9, 9],
                                 "total": 2}]}, 0.75),
    ("snap", {"step": 2, "rows": {"0": 3, "1": 2}}, 0.8),
    ("fail", {"uid": 1, "error": "boom — unavailable"}, 0.9),
    ("run_end", {"requests": 2}, None),
]


def _write(mod, path, records=RECORDS):
    w = mod.JournalWriter(path)
    for kind, d, t in records:
        w.append(kind, d, t=t)
    w.close()


def test_journal_bytes_equal_and_cross_read(tmp_path):
    jp, tp = str(tmp_path / "j.bin"), str(tmp_path / "t.bin")
    _write(jjournal, jp)
    _write(tjournal, tp)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    assert tjournal.MAGIC == jjournal.MAGIC
    assert tjournal.JOURNAL_NAME == jjournal.JOURNAL_NAME
    want = jjournal.read_records(jp)
    assert tjournal.read_records(jp) == want
    assert jjournal.read_records(tp) == want
    assert [r["k"] for r in want] == [k for k, _, _ in RECORDS]
    js, ts = jjournal.replay(jp), tjournal.replay(tp)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.tokens == {0: [5, 7, 3], 1: [9, 9]}
    assert ts.failed == {1: "boom — unavailable"}
    assert ts.clean_end and ts.chunks == 2 and ts.last_t == 0.9


def _tear(path, how):
    data = open(path, "rb").read()
    last = len(tjournal.MAGIC)          # start of the last frame
    pos = last
    while pos < len(data):
        last = pos
        n = int.from_bytes(data[pos:pos + 4], "little")
        pos += 8 + n
    if how == "short_header":
        data = data[:last + 5]
    elif how == "short_payload":
        data = data[:-3]
    else:                               # a flipped byte under the CRC
        data = data[:-2] + bytes([data[-2] ^ 0xFF]) + data[-1:]
    open(path, "wb").write(data)


@pytest.mark.parametrize("how", ["short_header", "short_payload", "crc"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_torn_tail_drops_at_the_same_place(tmp_path, how, writer):
    path = str(tmp_path / "journal.bin")
    _write(jjournal if writer == "reference" else tjournal, path)
    _tear(path, how)
    got, want = tjournal.read_records(path), jjournal.read_records(path)
    assert got == want
    assert [r["k"] for r in got] == [k for k, _, _ in RECORDS[:-1]]
    ts, js = tjournal.replay(path), jjournal.replay(path)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert not ts.clean_end


@pytest.mark.parametrize("mod", [jjournal, tjournal],
                         ids=["reference", "port"])
def test_journal_fresh_keeps_prev_and_requires_run_start(tmp_path, mod):
    path = str(tmp_path / "journal.bin")
    w = mod.JournalWriter(path)
    w.append("chunk", {"i": 1, "rows": []})
    w.close()
    with pytest.raises(ValueError, match="run_start"):
        tjournal.replay(path)
    with pytest.raises(ValueError, match="run_start"):
        jjournal.replay(path)
    _write(mod, path)
    assert [r["k"] for r in tjournal.read_records(path + ".prev")] == \
        ["chunk"]
    with open(path, "wb") as f:
        f.write(b"XXXX")
    with pytest.raises(ValueError, match="bad magic"):
        tjournal.read_records(path)


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _state(rng):
    return {"w": (rng.normal(size=(3, 5))).astype(np.float32),
            "layers": {"block0": {"k": rng.normal(size=(2, 4)).astype(
                                      jnp.bfloat16),
                                  "pos": np.arange(6, dtype=np.int32)}},
            "cur": np.int32(7), "on": np.array([True, False])}


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.numpy().dtype)
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        return x.view(np.uint16), "bfloat16"
    return x, str(x.dtype)


def _same_leaves(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for p in want:
        (g, gd), (w, wd) = _np(got[p]), _np(want[p])
        assert gd == wd, p
        assert g.shape == w.shape and np.array_equal(g, w), p


def _flat(tree):
    return dict(tree_util.flatten_with_paths(tree))


def test_checkpoints_cross_read(tmp_path):
    state = _state(np.random.default_rng(0))
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    tstate = params_from_jax(state, device="cpu")
    tstate["cur"] = torch.tensor(7, dtype=torch.int32)      # 0-d, as saved
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jmanager.save(jstate, jdir, 5, extra_meta={"kind": "x", "n": [1, 2]})
    tmanager.save(tstate, tdir, 5, extra_meta={"kind": "x", "n": [1, 2]})
    jm, ja = jmanager.load_raw(tdir)
    tm, ta = tmanager.load_raw(jdir)
    assert jm == tm and jm["extra"] == {"kind": "x", "n": [1, 2]}
    assert tmanager.load_raw(tdir)[0] == jm
    want = _flat(state)
    _same_leaves(ja, want)
    _same_leaves(ta, want)
    assert ta["layers/block0/k"].dtype == torch.bfloat16
    _same_leaves(_flat(jmanager.restore(jstate, tdir)), want)
    restored = tmanager.restore(tstate, jdir, device="cpu")
    _same_leaves(_flat(restored), want)
    assert open(os.path.join(tdir, "step_00000005", "manifest.json")).read() \
        == open(os.path.join(jdir, "step_00000005", "manifest.json")).read()


def test_checkpoint_gc_keeps_three_and_skips_tmp(tmp_path):
    d = str(tmp_path / "ck")
    st = {"x": torch.arange(3, dtype=torch.float32)}
    for step in (1, 2, 3, 4, 5):
        tmanager.save(dict(x=st["x"] + step), d, step)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004",
                                     "step_00000005"]
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert tmanager.latest_step(d) == jmanager.latest_step(d) == 5
    assert tmanager.latest_step(str(tmp_path / "none")) is None
    got = tmanager.restore(st, d, device="cpu")
    assert torch.equal(got["x"], st["x"] + 5)
    assert torch.equal(tmanager.restore(st, d, step=3, device="cpu")["x"],
                       st["x"] + 3)
    with pytest.raises(FileNotFoundError):
        tmanager.load_raw(str(tmp_path / "none"))


def test_export_import_expert_shims(tmp_path):
    rng = np.random.default_rng(3)
    init = {"a": torch.as_tensor(rng.normal(size=(8, 16)), dtype=torch.float32)}
    ft = {"a": init["a"] + torch.as_tensor(
        0.1 * rng.normal(size=(8, 16)), dtype=torch.float32)}
    for ext in (".npz", ".cpft"):
        path = str(tmp_path / f"ex{ext}")
        with pytest.warns(DeprecationWarning):
            stats = tmanager.export_expert(init, ft, path, density=0.25)
        assert stats["compressed_bytes"] > 0
        with pytest.warns(DeprecationWarning):
            tau, _ = tmanager.import_expert(path, device="cpu")
        want = tapi.compress(init, ft, density=0.25,
                             device="cpu").to_dense_tau()
        np.testing.assert_array_equal(tau["a"], want["a"].numpy())
        if ext == ".npz":
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                jtau, _ = jmanager.import_expert(path)
            np.testing.assert_array_equal(tau["a"], jtau["a"])


# ---------------------------------------------------------------------------
# fault classes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [jfault, tfault], ids=["reference", "port"])
def test_failure_injector_and_plans(mod):
    inj = mod.FailureInjector(fail_at_steps=(2, 4))
    seen = []
    for step in range(6):
        try:
            inj.check(step)
        except mod.SimulatedFailure as e:
            seen.append((step, str(e)))
    assert seen == [(2, "injected failure at step 2"),
                    (4, "injected failure at step 4")]
    inj.check(2)                        # once each
    assert issubclass(mod.SimulatedFailure, RuntimeError)
    assert mod.ElasticPlan((2, 4), (1, 8)).valid()
    assert not mod.ElasticPlan((2, 4), (0, 8)).valid()
    plan = mod.RecoveryPlan(snapshot_step=3, journal_records=17,
                            replayed_rows=2, reprefilled_rows=4)
    assert plan.as_dict() == jfault.RecoveryPlan(3, 17, 2, 4).as_dict()
    assert plan.as_dict() == {"snapshot_step": 3, "journal_records": 17,
                              "replayed_rows": 2, "reprefilled_rows": 4}


# ---------------------------------------------------------------------------
# kill-restart on the engines
# ---------------------------------------------------------------------------

class _Crash(Exception):
    pass


def _crash_at(eng, chunk_idx):
    def hook(i):
        if i == chunk_idx:
            raise _Crash(f"injected crash at chunk {i}")
    eng.chunk_hooks.append(hook)


@pytest.fixture(scope="module")
def world():
    """Both packages over the same weights and experts."""
    cfg = get_smoke_config("qwen2_5_3b", n_units=1)
    api = build(cfg)
    base = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    taus = [jax.tree_util.tree_map(
        lambda l: (0.01 * rng.normal(size=l.shape)).astype(np.float32),
        base) for _ in range(3)]
    jexperts = [rapi.compress(jax.tree_util.tree_map(jnp.asarray, t),
                              name=f"e{i}", density=0.2)
                for i, t in enumerate(taus)]
    texperts = [tapi.compress(params_from_jax(t, device="cpu"),
                              name=f"e{i}", density=0.2, device="cpu")
                for i, t in enumerate(taus)]
    for e in texperts:
        e.as_(PACKED)
    tbase = params_from_jax(jax.tree_util.tree_map(np.asarray, base),
                            device="cpu")
    model = t_build(t_smoke("qwen2_5_3b", n_units=1))
    prompts = [rng.integers(1, cfg.vocab, 6) for _ in range(8)]
    return dict(cfg=cfg, api=api, base=base, jexperts=jexperts,
                texperts=texperts, tbase=tbase, model=model,
                prompts=prompts)


def _jreg(w):
    inner = JInMemoryTransport()
    for e in w["jexperts"]:
        rapi.publish(e, inner)
    return rapi.registry(transport=inner)


def _treg(w):
    inner = InMemoryTransport()
    for e in w["texperts"]:
        tapi.publish(e, inner, rep=PACKED)
    return tapi.registry(transport=inner, device="cpu")


def _jreqs(w, max_new=8):
    return [JRequest(uid=i, expert=e, prompt=jnp.asarray(w["prompts"][i],
                                                         jnp.int32),
                     max_new_tokens=max_new) for i, e in enumerate(STREAM)]


def _treqs(w, max_new=8):
    return [Request(uid=i, expert=e, prompt=w["prompts"][i],
                    max_new_tokens=max_new) for i, e in enumerate(STREAM)]


def _jserve(w, **kw):
    reg = _jreg(w)
    return reg, rapi.serve(w["api"], RT, w["base"], reg, **dict(KW, **kw))


def _tserve(w, **kw):
    reg = _treg(w)
    return reg, tapi.serve(w["model"], w["tbase"], reg, **dict(KW, **kw))


def _tokens(reqs):
    return {r.uid: list(r.out_tokens) for r in reqs}


def _crash(serve, w, snap_dir, kill_at, mk, **kw):
    reg, eng = serve(w, snapshot_dir=snap_dir, **kw)
    _crash_at(eng, kill_at)
    with pytest.raises(_Crash):
        eng.run(mk(w))
    reg.close()


def _resume(serve, w, snap_dir, **kw):
    reg, eng = serve(w, snapshot_dir=snap_dir, **kw)
    out = eng.resume()
    reg.close()
    assert all(r.status == DONE for r in out)
    return _tokens(out), eng


CASES = {"dense": dict(kill_at=3, kw=dict(snapshot_every_chunks=1)),
         "paged": dict(kill_at=3, kw=dict(snapshot_every_chunks=1,
                                           **PAGED)),
         "journal": dict(kill_at=2, kw={})}


@pytest.fixture(scope="module")
def reference(world, tmp_path_factory):
    """Per case: the reference engine's uninterrupted tokens, its crashed
    run's directory and its resume's plan."""
    out = {}
    for name, case in CASES.items():
        kw = case["kw"]
        samp = {k: v for k, v in kw.items() if k != "snapshot_every_chunks"}
        reg, eng = _jserve(world, **samp)
        clean = _jreqs(world)
        eng.run(clean)
        reg.close()
        d = str(tmp_path_factory.mktemp(f"ref_{name}"))
        _crash(_jserve, world, d, case["kill_at"], _jreqs, **kw)
        toks, eng = _resume(_jserve, world, d, **kw)
        assert toks == _tokens(clean)
        out[name] = dict(want=_tokens(clean), dir=d,
                         plan=eng.recovery_stats["plan"].as_dict())
    return out


@pytest.mark.parametrize("case", ["dense", "paged"])
def test_crash_resume_matches_reference(world, reference, tmp_path, case):
    """Dense greedy, and paged + affinity + sampled (the allocator's free
    list and the sampled streams restored): a crash at chunk 3 resumes to
    the reference's uninterrupted tokens, with the reference's plan."""
    c, ref = CASES[case], reference[case]
    d = str(tmp_path / "snap")
    _crash(_tserve, world, d, c["kill_at"], _treqs, **c["kw"])
    toks, eng = _resume(_tserve, world, d, **c["kw"])
    assert toks == ref["want"]
    plan = eng.recovery_stats["plan"]
    assert plan.as_dict() == ref["plan"]
    assert plan.snapshot_step is not None and plan.replayed_rows > 0
    assert plan.reprefilled_rows > 0 and plan.journal_records > 0
    assert eng.recovery_stats["resume_seconds"] > 0
    assert "first_resumed_token_s" in eng.recovery_stats
    assert eng.swap_summary()["kv"]["blocks_in_use"] == 0
    assert [w.get("resumed") for w in eng.wave_log][:1] == [True]


def test_resume_journal_only_through_api(world, reference, tmp_path):
    ref = reference["journal"]
    d = str(tmp_path / "snap")
    _crash(_tserve, world, d, 2, _treqs)
    reg = _treg(world)
    eng = tapi.serve(world["model"], world["tbase"], reg, snapshot_dir=d,
                     resume=True, **KW)
    reg.close()
    assert _tokens(eng.resumed_requests) == ref["want"]
    assert all(r.status == DONE for r in eng.resumed_requests)
    plan = eng.recovery_stats["plan"]
    assert plan.snapshot_step is None and plan.replayed_rows == 0
    assert plan.as_dict() == ref["plan"]


def test_resume_refuses_mismatched_sampling(world, tmp_path):
    d = str(tmp_path / "snap")
    _crash(_tserve, world, d, 2, _treqs, seed=7, temperature=0.8)
    reg, eng = _tserve(world, snapshot_dir=d, seed=8, temperature=0.8)
    with pytest.raises(ValueError, match="sampling mismatch"):
        eng.resume()
    for bad, what in (({"scheduler": "priority"}, "scheduler mismatch"),
                      ({"kv_layout": "paged"}, "kv_layout mismatch")):
        _, eng = _tserve(world, snapshot_dir=d, seed=7, temperature=0.8,
                         **bad)
        with pytest.raises(ValueError, match=what):
            eng.resume()
    reg.close()


def test_completed_run_resumes_from_journal_alone(world, reference,
                                                  tmp_path):
    d = str(tmp_path / "snap")
    reg, eng = _tserve(world, snapshot_dir=d)
    reqs = _treqs(world)
    eng.run(reqs)
    reg.close()
    assert _tokens(reqs) == reference["dense"]["want"]
    assert len(eng.wave_log) > 0
    assert all(r.t_wall is not None for r in reqs)
    toks, eng2 = _resume(_tserve, world, d)
    assert toks == reference["dense"]["want"]
    assert len(eng2.wave_log) == 0
    plan = eng2.recovery_stats["plan"]
    assert plan.snapshot_step is None
    assert (plan.replayed_rows, plan.reprefilled_rows) == (0, 0)
    recs = tjournal.read_records(os.path.join(d, tjournal.JOURNAL_NAME))
    assert recs[-1]["k"] == "run_end"
    assert {r["k"] for r in recs} == {"run_start", "sched", "admit",
                                      "chunk", "run_end"}


@pytest.mark.parametrize("case", ["dense", "paged"])
def test_cross_package_resume(world, reference, tmp_path, case):
    """The reference's crashed run resumes in the port, and the port's in
    the reference, to the reference's uninterrupted tokens."""
    c, ref = CASES[case], reference[case]
    toks, eng = _resume(_tserve, world, ref["dir"], **c["kw"])
    assert toks == ref["want"]
    assert eng.recovery_stats["plan"].as_dict() == ref["plan"]
    d = str(tmp_path / "snap")
    _crash(_tserve, world, d, c["kill_at"], _treqs, **c["kw"])
    toks, eng = _resume(_jserve, world, d, **c["kw"])
    assert toks == ref["want"]
    assert eng.recovery_stats["plan"].as_dict() == ref["plan"]


def test_sigkill_child_resumes(world, reference, tmp_path):
    """The child serves with a snapshot every chunk and dies by SIGKILL
    after chunk 3; the parent resumes its run to the uninterrupted
    tokens."""
    setup, snap = str(tmp_path / "setup"), str(tmp_path / "snap")
    write_setup(setup, arch="qwen2_5_3b", n_units=1, smoke=True,
                base=world["tbase"], experts=world["texperts"],
                requests=_treqs(world), engine_kw=KW)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.restart_child", snap,
         setup, "3", "--device", "cpu"], env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    state = tjournal.replay(os.path.join(snap, tjournal.JOURNAL_NAME))
    assert state.chunks == 3 and not state.clean_end
    assert [s["step"] for s in state.snapshots] == [1, 2]
    toks, eng = _resume(_tserve, world, snap)
    assert toks == reference["dense"]["want"]
    assert eng.recovery_stats["plan"].as_dict() == \
        reference["dense"]["plan"]
