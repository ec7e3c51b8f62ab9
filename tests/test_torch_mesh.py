"""The port's serving mesh below the engine: ``make_serve_mesh`` and its
errors, the serve placement rules against the reference's own functions
(on abstract meshes of shape (2, 4), (1, 2) and (2, 1)), a rank's shard of
a tensor, the row layout of batch-sharded KV, the per-shard block
allocator, and the device tier with expert slots on 2 gloo ranks (E = 3
pads to 4 with an inert slot, per-shard gauges and budget)."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

import mesh_cases as mc
from repro.distributed import sharding as rs
from repro.launch.mesh import make_serve_mesh as ref_make_serve_mesh
from repro_torch.distributed import sharding as ts
from repro_torch.distributed.collectives import (RowLayout, local_row_count,
                                                 row_owner)
from repro_torch.launch import mesh as tmesh
from repro_torch.serve import paged_kv

SHAPES = [(2, 4), (1, 2), (2, 1)]
LEAVES = [("embed", (512, 64)), ("embed", (510, 64)),
          ("lm_head", (64, 512)), ("lm_head", (64, 510)),
          ("unembed", (64, 512)), ("final_norm", (64,)),
          ("blocks/block0/attn/wq", (1, 64, 4, 16)),
          ("blocks/block0/ffn/wo", (1, 128, 64))]


def _abstract(shape):
    return AbstractMesh(tuple(shape), ("expert", "model"))


@pytest.fixture
def one_rank_world():
    """A gloo world of one rank in this process, torn down after."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{mc.free_port()}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("shape", [(1,), (1, 1, 1), (2, 2, 1)])
def test_make_serve_mesh_rejects_a_shape_that_is_not_2d(shape):
    with pytest.raises(ValueError) as ref:
        ref_make_serve_mesh(shape)
    with pytest.raises(ValueError) as got:
        tmesh.make_serve_mesh(shape, device="cpu")
    assert str(got.value) == str(ref.value)


def test_make_serve_mesh_needs_the_world_to_match(one_rank_world):
    with pytest.raises(ValueError, match=r"needs 2 devices but 1 are"):
        tmesh.make_serve_mesh((1, 2), device="cpu")
    mesh = tmesh.make_serve_mesh((1, 1), device="cpu")
    assert tuple(mesh.mesh_dim_names) == tmesh.SERVE_AXES
    assert tmesh.mesh_axes(mesh) == {"expert": 1, "model": 1}
    assert ts.serve_mesh_axes(mesh) == (1, 1)


def test_a_mesh_of_several_ranks_needs_a_started_world():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="init_process_group"):
        tmesh.make_serve_mesh((2, 1), device="cpu")


def test_production_mesh_shapes():
    assert tmesh.production_shape(4, multi_pod=True) == (4, 1, 1)
    assert tmesh.production_shape(4) == (1, 4, 1)
    assert not hasattr(tmesh, "PEAK_FLOPS_BF16")      # a TPU's numbers


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("path,leaf", LEAVES,
                         ids=[f"{p}{s}" for p, s in LEAVES])
def test_serve_param_pspec_matches_reference(shape, path, leaf):
    m = _abstract(shape)
    assert ts.serve_param_pspec(path, leaf, m) == tuple(
        rs.serve_param_pspec(path, leaf, m))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_serve_kv_stack_and_cache_rules_match_reference(shape):
    m = _abstract(shape)
    assert ts.serve_mesh_axes(m) == rs.serve_mesh_axes(m)
    for kv in [(1, 4, 16, 2, 16), (1, 3, 16, 2, 16), (1, 17, 16, 2, 16),
               (1, 8, 16, 2, 16), (4, 16)]:
        for layout in ("dense", "paged"):
            assert ts.serve_kv_sharding(m, kv, layout=layout) == tuple(
                rs.serve_kv_sharding(m, kv, layout=layout).spec)
    assert ts.serve_stack_shardings(m) == tuple(
        tuple(s.spec) for s in rs.serve_stack_shardings(m))
    # a wave's rows are cut where the reference cuts its dense KV's batch
    for B in range(1, 10):
        spec = rs.serve_kv_sharding(m, (1, B, 16, 2, 16)).spec
        assert ts.serve_row_shards(m, B) == (
            shape[1] if spec[1] == "model" else 1), B
    params = {"embed": torch.zeros(512, 64), "final_norm": torch.zeros(64)}
    assert ts.serve_param_shardings(params, m) == {
        "embed": tuple(rs.serve_param_pspec("embed", (512, 64), m)),
        "final_norm": (None,)}


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_local_shards_reassemble_the_logical_tensor(shape):
    m = _abstract(shape)
    rng = np.random.default_rng(0)
    params = {"embed": torch.as_tensor(rng.normal(size=(512, 64))),
              "lm_head": torch.as_tensor(rng.normal(size=(64, 512))),
              "final_norm": torch.as_tensor(rng.normal(size=(64,)))}
    n = shape[1]
    parts = [ts.shard_params(params, m, index={"model": i}) for i in range(n)]
    assert torch.equal(torch.cat([p["embed"] for p in parts], 0),
                       params["embed"])
    assert torch.equal(torch.cat([p["lm_head"] for p in parts], 1),
                       params["lm_head"])
    assert all(p["final_norm"] is params["final_norm"] for p in parts)
    assert parts[-1]["embed"].shape[0] == 512 // n


@pytest.mark.parametrize("n", [2, 3, 4])
def test_row_layout_runs_each_row_once_and_gathers_in_order(n):
    """Row j on rank j % n; pad rows fill every rank to one count (at
    least 2 once a batch has 2 rows); the gather permutation gives the
    batch back in order."""
    for B in range(1, 10):
        lays = [RowLayout(B, n, m, "cpu") for m in range(n)]
        R = local_row_count(B, n)
        assert R == max(-(-B // n), min(B, 2))
        x = torch.arange(B * 3, dtype=torch.float32).reshape(B, 3)
        local = [lay.local(x) for lay in lays]
        assert all(t.shape == (R, 3) for t in local)
        owned = sorted(j for lay in lays for j in lay.rows)
        assert owned == list(range(B))
        for lay in lays:
            for j in range(B):
                jl = lay.local_index(j)
                assert (jl is not None) == (row_owner(j, n) == lay.m)
                if jl is not None:
                    assert torch.equal(local[lay.m][jl], x[j])
            flags = lay.local(torch.ones(B, dtype=torch.bool), fill=False)
            assert int(flags.sum()) == len(lay.rows)
        gathered = torch.cat(local, 0).index_select(0, lays[0].order)
        assert torch.equal(gathered, x)


def test_shard_pool_blocks_and_sharded_allocator():
    assert paged_kv.shard_pool_blocks(17, 1, 4) == 17
    assert paged_kv.shard_pool_blocks(17, 2, 4) == 9
    assert paged_kv.shard_pool_blocks(10, 4, 2) == 4
    # never fewer usable blocks than one row may take of the logical pool
    assert paged_kv.shard_pool_blocks(10, 4, 4) == 5
    assert paged_kv.shard_pool_blocks(3, 2, 4) == 3
    assert paged_kv.shard_pool_blocks(13, 2, 4) == 7
    a = paged_kv.ShardedBlockAllocator(5, 16, 2)
    assert [a.owner(j) for j in range(4)] == [0, 1, 0, 1]
    assert a.available == 8 and a.available_on(1) == 4
    b0 = a.alloc(3, shard=0)
    b1 = a.alloc(2, shard=1)
    assert b0 == [1, 2, 3] and b1 == [1, 2]
    assert a.alloc(2, shard=0) is None           # all or nothing
    assert a.in_use == 5 and a.peak_in_use == 5
    assert a.global_ids(b1, 1) == [6, 7]
    assert sorted(a.state()) == [4, 8, 9]
    a.free(b0, shard=0)
    a.free(b1, shard=1)
    assert a.in_use == 0 and a.shard_peaks == [3, 2]
    one = paged_kv.BlockAllocator(9, 16)
    assert one.n_shards == 1 and one.available_on(0) == 8
    assert one.owner(3) == 0
    assert one.alloc(2, shard=0) == [1, 2]


def test_init_paged_cache_on_a_mesh_holds_one_rank_shard():
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen2_5_3b", n_units=1)
    c = paged_kv.init_paged_cache(cfg, 4, 17, 16, 4, device="cpu",
                                  mesh=_abstract((1, 2)))
    assert c["layers"]["block0"]["k"].shape[1] == 9
    assert c["tables"].shape == (2, 4) and c["active"].shape == (2,)
    c1 = paged_kv.init_paged_cache(cfg, 4, 17, 16, 4, device="cpu",
                                   mesh=_abstract((2, 1)))
    assert c1["layers"]["block0"]["k"].shape[1] == 17
    assert c1["tables"].shape == (4, 4)
    # 3 rows do not divide over 2: every row and the whole pool
    c3 = paged_kv.init_paged_cache(cfg, 3, 13, 16, 4, device="cpu",
                                   mesh=_abstract((1, 2)))
    assert c3["layers"]["block0"]["k"].shape[1] == 13
    assert c3["tables"].shape == (3, 4)


def test_row_layout_is_the_kv_placement(one_rank_world):
    """``ServeComm.rows_for`` cuts a wave's rows exactly where the serve
    rules cut its KV (a batch that divides over "model"); elsewhere every
    rank runs every row."""
    import types
    from repro_torch.distributed.collectives import ServeComm
    for m in (0, 1):
        mesh = types.SimpleNamespace(
            mesh_dim_names=("expert", "model"), shape=(1, 2),
            get_local_rank=lambda axis, m=m: m if axis == "model" else 0,
            get_group=lambda axis: None)
        comm = ServeComm(mesh, 512)
        for B in range(1, 10):
            lay = comm.rows_for(B, "cpu")
            assert (lay is None) == (ts.serve_row_shards(mesh, B) == 1)
            assert (lay is None) == (B % 2 == 1)
            if lay is not None:
                assert lay.rows == list(range(m, B, 2))
                assert lay.R == max(B // 2, 2)


@pytest.fixture(scope="module")
def setup_dir(tmp_path_factory):
    from repro_torch import tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build
    d = str(tmp_path_factory.mktemp("mesh_setup"))
    cfg = get_smoke_config("qwen2_5_3b", n_units=1)
    base = build(cfg).init(seed=0, device="cpu")
    rng = np.random.default_rng(0)
    taus = [tree.tree_map(lambda l: torch.as_tensor(
        (0.03 * rng.normal(size=tuple(l.shape))).astype(np.float32)), base)
        for _ in range(mc.N_EXPERTS)]
    torch.save(base, os.path.join(d, "base.pt"))
    torch.save(taus, os.path.join(d, "taus.pt"))
    return d


def test_device_cache_shards_on_two_ranks(setup_dir, tmp_path):
    """The reference's ``test_mesh_device_cache_shards`` on the port's
    slots: E = 3 on a (2, 1) mesh pads to 4 slots, 2 a rank; the pad
    slot's scale is 0; the shards hold [2, 1] experts; the budget is
    per shard and ``shard_resident_bytes() <= resident_bytes()``; a
    mesh-free tier has one shard."""
    res = mc.run_mesh((2, 1), setup_dir, [{"op": "cache"}], str(tmp_path))
    for rank, (r,) in enumerate(res):
        assert r["n_shards"] == r["stats_shards"] == 2
        assert r["n_slots"] == 4 and r["local_rows"] == 2
        assert (r["lo"], r["hi"]) == (2 * rank, 2 * rank + 2)
        assert [s["resident_experts"] for s in r["summary"]] == [2, 1]
        assert all(s["capacity_bytes"] == mc.BUDGET for s in r["summary"])
        assert r["shard_resident_bytes"] <= r["resident_bytes"]
        assert r["rebuilt_n_shards"] == 1
        assert r["names"] == res[0][0]["names"]
    pad = res[0][0]["names"].index(None)
    assert pad == 3
    assert res[1][0]["local_scales"][pad - 2] == 0.0
    assert all(s != 0.0 for s in res[0][0]["local_scales"])
