"""The port's training placement rules against the reference's
(``repro/distributed/sharding.py``) for every config in ``ARCHS`` at full
width, on meshes (data, model) = (16, 16), (2, 4), (1, 2) and (pod,
data, model) = (2, 16, 16), the reference given ``jax.sharding.
AbstractMesh`` meshes: no device and no weight is allocated (the
reference's trees come from ``jax.eval_shape``, the port's from the meta
device).  Per leaf: ``param_pspec``, ``train_state_shardings`` of AdamW
and Adafactor states (with error feedback), ``cache_pspec`` and
``decode_layout`` of every decode cache at batch 1 and at a batch that
divides, ``batch_axes``/``batch_shardings`` and the collectives'
``batch_axes_of``; ``serve_cache_shardings`` of dense and paged caches on
("expert", "model") meshes; the parameter trees' leaves and totals; and
a state cut by the placements and reassembled bitwise."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_config
from repro.distributed import sharding as rs
from repro.models import build as ref_build
from repro.peft.lora import _path_str
from repro.train import TrainConfig as RefTrainConfig
from repro.train import init_train_state as ref_init_state
from repro_torch import tree as tree_util
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.distributed import sharding as ts
from repro_torch.models import build
from repro_torch.train import train_step as tts
from repro_torch.train import within_pod as wp

MESHES = [(16, 16), (2, 16, 16), (2, 4), (1, 2)]


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def ref_mesh(shape):
    return AbstractMesh(tuple(shape), _names(shape))


def port_mesh(shape):
    return wp.AxisSizes(dict(zip(_names(shape), shape)))


def _specs(tree):
    """{path: tuple(spec)} of a NamedSharding tree."""
    return {_path_str(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    api = ref_build(ref_config(arch))
    return jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def port_params(arch):
    return build(get_config(arch)).init(device="meta")


def _flat_ref(tree):
    return {_path_str(p): tuple(x.shape) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {p: tuple(x.shape) for p, x in tree_util.flatten_with_paths(tree)}


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_trees_and_counts_match_reference(arch):
    ref, port = _flat_ref(ref_params(arch)), _flat_port(port_params(arch))
    assert port == ref
    assert get_config(arch).param_count() == ref_config(arch).param_count()
    assert sum(int(np.prod(s)) for s in port.values()) == sum(
        int(np.prod(s)) for s in ref.values())


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspec_matches_reference(arch, shape):
    rcfg, cfg = ref_config(arch), get_config(arch)
    rm, pm = ref_mesh(shape), port_mesh(shape)
    for path, leaf_shape in _flat_port(port_params(arch)).items():
        want = tuple(rs.param_pspec(path, leaf_shape, rcfg, rm))
        assert ts.param_pspec(path, leaf_shape, cfg, pm) == want, path
    got = ts.param_shardings(port_params(arch), cfg, pm)
    assert dict(tree_util.flatten_with_paths(got)) == _specs(
        rs.param_shardings(ref_params(arch), rcfg, rm))
    for n in (1, 2, 4, 6, 16, 40):
        assert ts.heads_shardable(cfg, pm, n) == rs.make_shard_fn(
            rm, rcfg).heads_shardable(n)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_shardings_match_reference(arch, shape, opt):
    rcfg, cfg = ref_config(arch), get_config(arch)
    multi = len(shape) == 3
    rstate = jax.eval_shape(lambda: ref_init_state(
        ref_params(arch), RefTrainConfig(optimizer=opt), multi))
    state = tts.init_train_state(port_params(arch),
                                 tts.TrainConfig(optimizer=opt),
                                 multi_pod=multi)
    want = _specs(rs.train_state_shardings(rstate, rcfg, ref_mesh(shape)))
    got = dict(tree_util.flatten_with_paths(
        ts.train_state_shardings(state, cfg, port_mesh(shape))))
    assert got == want


def _batches(shape):
    dp = shape[0] * shape[1] if len(shape) == 3 else shape[0]
    return (1, 2 * dp)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_rules_match_reference(arch, shape):
    rm, pm = ref_mesh(shape), port_mesh(shape)
    cfg = get_config(arch)
    for B in _batches(shape):
        assert ts.decode_layout(pm, B) == rs.decode_layout(rm, B)
        cache = build(cfg).init_decode_cache(B, 32768, device="meta")
        for path, leaf_shape in _flat_port(cache).items():
            for seq_shard in (True, False):
                want = tuple(rs.cache_pspec(path, leaf_shape, rm, B,
                                            seq_shard))
                assert ts.cache_pspec(path, leaf_shape, pm, B,
                                      seq_shard) == want, (B, path)
        got = ts.cache_shardings(cache, pm, B)
        assert all(len(s) == len(leaf.shape) for s, leaf in zip(
            tree_util.leaves(got), tree_util.leaves(cache)))


@pytest.mark.parametrize("shape", MESHES)
def test_batch_rules_match_reference(shape):
    rm, pm = ref_mesh(shape), port_mesh(shape)
    assert ts.batch_axes(pm) == tuple(rs.batch_axes(rm))
    batch = {"tokens": torch.zeros((8, 4), dtype=torch.int64,
                                   device="meta"),
             "mm_embeds": torch.zeros((8, 2, 3), device="meta")}
    rbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
              for k, v in batch.items()}
    got = dict(tree_util.flatten_with_paths(ts.batch_shardings(batch, pm)))
    assert got == _specs(rs.batch_shardings(rbatch, rm))
    assert ts.replicated(pm) == tuple(rs.replicated(rm).spec)


@pytest.mark.parametrize("shape", MESHES)
def test_batch_axes_of_matches_reference(shape):
    from repro.distributed.collectives import batch_axes_of as ref_of
    from repro_torch.distributed.collectives import batch_axes_of
    assert batch_axes_of(port_mesh(shape)) == tuple(ref_of(ref_mesh(shape)))


SERVE_MESHES = [(1, 1), (1, 2), (2, 2), (4, 2), (1, 3)]


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("shape", SERVE_MESHES)
def test_serve_cache_shardings_match_reference(shape, layout):
    """Every leaf of a smoke decode cache (KV rings, positions, the
    cursor) and of a paged one (pools, tables, lengths, flags) at 2 and 4
    rows, on ("expert", "model") meshes."""
    rm = AbstractMesh(tuple(shape), ("expert", "model"))
    pm = wp.AxisSizes(dict(zip(("expert", "model"), shape)))
    api = build(get_smoke_config("qwen2_5_3b", n_units=2))
    for rows in (2, 4):
        caches = [api.init_decode_cache(rows, 16, device="meta"),
                  {"k": torch.zeros((2, rows * 3, 16, 2, 8), device="meta"),
                   "v": torch.zeros((2, rows * 3, 16, 2, 8), device="meta"),
                   "tables": torch.zeros((rows, 4), dtype=torch.int32,
                                         device="meta"),
                   "lens": torch.zeros((rows,), dtype=torch.int32,
                                       device="meta"),
                   "active": torch.zeros((rows,), dtype=torch.bool,
                                         device="meta")}]
        for cache in caches:
            ref = tree_util.unflatten_paths({
                p: jax.ShapeDtypeStruct(tuple(x.shape), np.float32)
                for p, x in tree_util.flatten_with_paths(cache)})
            want = _specs(rs.serve_cache_shardings(ref, rm, layout=layout))
            got = dict(tree_util.flatten_with_paths(
                ts.serve_cache_shardings(cache, pm, layout=layout)))
            assert got == want, rows


@pytest.mark.parametrize("arch", ARCHS)
def test_a_cut_state_reassembles_bitwise(arch):
    """A smoke-size AdamW state with error feedback, cut for every rank
    of a (2, 2, 2) mesh and reassembled, is the logical state bit for
    bit; every block has the shape the rank's placement gives."""
    sizes = {"pod": 2, "data": 2, "model": 2}
    mesh = wp.AxisSizes(sizes)
    api = build(get_smoke_config(arch, n_units=2))
    params = api.init(seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    state = tts.init_train_state(params, tts.TrainConfig(), multi_pod=True)
    state = tree_util.tree_map(
        lambda x: (torch.randn(x.shape, generator=gen).to(x.dtype)
                   if x.is_floating_point() else x), state)
    specs = dict(tree_util.flatten_with_paths(
        ts.train_state_shardings(state, api.cfg, mesh)))
    coords = wp._coords(sizes)
    blocks = {c: dict(tree_util.flatten_with_paths(wp.shard_train_state(
        state, api.cfg, mesh, dict(zip(sizes, c))))) for c in coords}
    cut = 0
    for path, want in tree_util.flatten_with_paths(state):
        got = ts.assemble({c: b[path] for c, b in blocks.items()},
                          specs[path], sizes)
        assert got.dtype == want.dtype and torch.equal(got, want), path
        cut += blocks[coords[-1]][path].shape != want.shape
    assert cut > 0
