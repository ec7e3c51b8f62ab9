"""Cross-mesh parity of the port's serving engine, on gloo ranks.

The reference's ``test_mesh_serve.py`` traffic (10 requests over 6
experts at density 0.2, ``max_batch`` 4, ``cache_len`` 64,
``decode_chunk`` 4, a 96 KiB device budget that forces evictions) served
dense and paged, greedy and seeded-sampled (temperature 0.8, top_k 5,
seed 7).  The port's ``mesh=None`` run must give the reference engine's
tokens, in this process; every mesh, (1, 1), (2, 1), (1, 2) and (2, 2),
one child process a rank (``tests/mesh_cases.py``), must give the port's
``mesh=None`` tokens on every rank, with the reference test's gauges
(admissions, evictions, shard count, balance, per-shard budget) and no KV
block left in use.  A snapshot taken on (2, 1) resumes on ``mesh=None``
and on (1, 2) with the uninterrupted run's tokens."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mesh_cases as mc
from repro import api as rapi
from repro.configs import get_smoke_config
from repro.models import Runtime, build
from repro.serve import Request as JRequest
from repro_torch.convert import params_from_jax

RT = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")
CASES = [{"kv": kv, "sampled": s} for kv in ("dense", "paged")
         for s in (False, True)]
CASE_IDS = [f"{c['kv']}-{'sampled' if c['sampled'] else 'greedy'}"
            for c in CASES]
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The reference's base and task vectors, written for the ranks; the
    reference's experts and the port's, compressed from the same trees."""
    d = str(tmp_path_factory.mktemp("mesh_serve"))
    cfg = get_smoke_config("qwen2_5_3b", n_units=1)
    api = build(cfg)
    base = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    taus = [jax.tree_util.tree_map(
        lambda l: (0.03 * rng.normal(size=l.shape)).astype(np.float32), base)
        for _ in range(mc.N_EXPERTS)]
    torch.save(params_from_jax(jax.tree_util.tree_map(np.asarray, base),
                               device="cpu"), os.path.join(d, "base.pt"))
    torch.save([params_from_jax(t, device="cpu") for t in taus],
               os.path.join(d, "taus.pt"))
    jexperts = [rapi.compress(jax.tree_util.tree_map(jnp.asarray, t),
                              name=f"e{i}", density=0.2)
                for i, t in enumerate(taus)]
    return {"dir": d, "api": api, "base": base, "jexperts": jexperts,
            "port": mc.port_world(d)}


def _reference_tokens(world, case):
    jreg = rapi.registry(experts=world["jexperts"],
                         device_cache_bytes=mc.BUDGET)
    samp = mc.SAMPLED if case["sampled"] else {}
    eng = rapi.serve(world["api"], RT, world["base"], jreg,
                     kv_layout=case["kv"], **mc.ENGINE_KW, **samp)
    done = eng.run([JRequest(uid=u, expert=e,
                             prompt=jnp.asarray(p, jnp.int32),
                             max_new_tokens=n)
                    for u, e, p, n in mc.request_specs()])
    return {str(r.uid): [r.status, [int(t) for t in r.out_tokens]]
            for r in done}


@pytest.fixture(scope="module")
def mesh_free(world):
    """The port's ``mesh=None`` results, one per case."""
    out = []
    for case in CASES:
        eng, done = mc.serve_case(world["port"], case)
        out.append(mc.result(eng, done))
        eng.registry.close()
    return out


@pytest.mark.parametrize("i", range(len(CASES)), ids=CASE_IDS)
def test_mesh_free_port_matches_reference_engine(world, mesh_free, i):
    got = mesh_free[i]
    assert got["tokens"] == _reference_tokens(world, CASES[i])
    assert all(s == "done" for s, _ in got["tokens"].values())
    assert got["summary"]["n_expert_shards"] == 1
    assert "mesh" not in got["summary"]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_cross_mesh_parity(world, mesh_free, shape, tmp_path):
    res = mc.run_mesh(shape, world["dir"], CASES, str(tmp_path))
    assert len(res) == shape[0] * shape[1]
    for rank, per_case in enumerate(res):
        for case, got, want in zip(CASES, per_case, mesh_free):
            where = f"mesh={shape} rank={rank} case={case}"
            assert got["tokens"] == want["tokens"], where
            assert got["own_tier"], where
            summ = got["summary"]
            assert summ["mesh"] == {"expert": shape[0], "model": shape[1]}
            assert summ["n_expert_shards"] == shape[0], where
            assert summ["admitted"] > 0, "no mid-wave admissions exercised"
            assert summ["evictions"] + summ["stack_evictions"] > 0, \
                "budget never forced an eviction"
            assert summ["graph_captures"] == 0
            assert summ["kv"]["blocks_in_use"] == 0, where
            shards = summ["shards"]
            assert len(shards) == shape[0]
            counts = [s["resident_experts"] for s in shards]
            if max(counts):
                assert max(counts) <= 2 * max(min(counts), 1), \
                    f"shard imbalance > 2x: {counts}"
            for s in shards:
                assert s["capacity_bytes"] == mc.BUDGET


ODD = [{"kv": "dense", "max_batch": 3}, {"kv": "paged", "max_batch": 3},
       {"kv": "paged", "max_batch": 3, "kv_blocks": 5},
       {"kv": "paged", "max_batch": 2, "kv_blocks": 3}]
MESH_LESS_REGISTRY = {"kv": "dense", "registry_mesh": False}


@pytest.fixture(scope="module")
def odd_runs(world, tmp_path_factory):
    """On (2, 2): waves of 3 rows (their KV stays whole on every rank) and
    of 2 (cut over "model"), a 5-block pool whose 3-row waves overflow
    into 2-row ones, a 3-block pool that holds one row's 2 blocks (so a
    shard's pool must hold them too), and an engine mesh over a registry
    made without one."""
    tmp = str(tmp_path_factory.mktemp("odd"))
    return mc.run_mesh((2, 2), world["dir"], ODD + [MESH_LESS_REGISTRY], tmp)


@pytest.mark.parametrize("i", range(len(ODD)),
                         ids=["dense-b3", "paged-b3", "paged-b3-5blocks",
                              "paged-b2-3blocks"])
def test_a_batch_that_does_not_divide_gives_mesh_free_tokens(world, odd_runs,
                                                             i):
    """The serve rules keep a 3-row wave's KV whole on every rank; each
    shard's pool holds at least one row of the logical pool, so the mesh
    places every request the mesh-free engine places."""
    eng, done = mc.serve_case(world["port"], ODD[i])
    want = mc.result(eng, done)
    eng.registry.close()
    assert all(st == "done" for st, _ in want["tokens"].values())
    for rank, per_case in enumerate(odd_runs):
        got = per_case[i]
        assert got["tokens"] == want["tokens"], f"rank {rank}"
        assert got["summary"]["kv"]["blocks_in_use"] == 0
        assert got["summary"]["kv"]["blocks_total"] == \
            want["summary"]["kv"]["blocks_total"]


def test_engine_mesh_owns_the_tier_of_a_mesh_less_registry(mesh_free,
                                                           odd_runs):
    """``serve(mesh=M)`` over a registry made without a mesh: the engine's
    tier, on M, stays the registry's tier through the run."""
    want = mesh_free[CASES.index({"kv": "dense", "sampled": False})]
    for per_case in odd_runs:
        got = per_case[len(ODD)]
        assert got["own_tier"]
        assert got["tokens"] == want["tokens"]
        assert got["summary"]["n_expert_shards"] == 2
        assert len(got["summary"]["shards"]) == 2


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_snapshot_on_one_mesh_resumes_on_another(world, mesh_free, kv,
                                                 tmp_path):
    """Crash a (2, 1) run at chunk 2 (chunks of 2, a snapshot each), resume
    it on ``mesh=None`` in this process and on (1, 2): the tokens of the
    uninterrupted run, and no KV block in use afterwards."""
    snap = str(tmp_path / "snap")
    want = mesh_free[CASES.index({"kv": kv, "sampled": False})]["tokens"]
    crash = {"kv": kv, "op": "crash", "snapshot_dir": snap}
    mc.run_mesh((2, 1), world["dir"], [crash], str(tmp_path))
    names = sorted(os.listdir(snap))
    assert "journal.bin" in names and len(names) > 1   # journal, snapshots
    eng, done = mc.serve_case(world["port"], {"kv": kv, "op": "resume"},
                              snapshot_dir=snap)
    got = mc.result(eng, done)
    assert got["tokens"] == want
    assert eng.recovery_stats["plan"].replayed_rows > 0
    assert eng.swap_summary()["kv"]["blocks_in_use"] == 0
    eng.registry.close()
    res = mc.run_mesh((1, 2), world["dir"],
                      [{"kv": kv, "op": "resume", "snapshot_dir": snap}],
                      str(tmp_path))
    for (r,) in res:
        assert r["tokens"] == want
        assert r["summary"]["kv"]["blocks_in_use"] == 0
