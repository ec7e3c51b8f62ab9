"""Prefill and decode inside a pod (``within_pod.make_pod_serve``): the
reference's prefill and decode cells on a ("pod", "data", "model") mesh,
each unit gathered over "data" from the rank's blocks of
``param_shardings`` and run cut over "model", the decode cache placed by
``cache_pspec``.

* Ranks as threads (``within_pod.ThreadComm``), f32 smoke configs at 2
  units: every family the port trains in a pod (dense attention, MoE on
  d_ff and on E, rwkv6, internvl2, jamba, seamless) on (1, 1, 2) and
  (1, 2, 2); jamba on (1, 1, 4), whose 2 KV heads and 18-slot ring do
  not divide over 4; jamba at batch 1 on (1, 2, 2), the long-context
  layout (the sequence over every axis, mamba's ``h`` and ``conv`` on
  d_inner).  A prompt prefilled, then 4 greedy decode steps: the
  last-token prefill logits and each step's logits within ``TOL`` of
  the largest |logit| of the mesh-free ``prefill`` / ``decode_step``,
  the greedy tokens equal; after the prefill and after each step every
  rank's cache leaf within ``TOL`` of its block of the mesh-free cache
  (``sharding.cache_placement``; ``pos`` and ``cur`` equal); every
  parameter block at its placed shape.
* qwen2.5, jamba and seamless: the pod prefill's logits within
  ``REF_TOL`` of the reference's own mesh-free ``prefill`` (JAX, CPU) on
  the same numpy parameters, carried into the port by ``convert.py``.
* jamba on (1, 2, 2) as gloo ranks in child processes (``MeshComm``,
  the real collectives), held as the threads are.
* Every registered config's pod prefill and decode step on (1, 2, 2)
  threads with no leaf gathered over "model"."""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.distributed.sharding import (cache_placement,
                                              param_shardings, shard_tree)
from repro_torch.models import build
from repro_torch.train import within_pod as wp

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
AXES = ("pod", "data", "model")
TOL = 2e-5        # of the largest |value|, f32 (test_torch_sp_decode.TOL)
REF_TOL = 1e-4    # of the largest |logit|, f32, against the JAX package
PROMPT, STEPS, CACHE_LEN, BATCH = 12, 4, 24, 4
FAMILIES = {"qwen2.5": "qwen2_5_3b", "mixtral": "mixtral_8x7b",
            "llama4": "llama4_maverick_400b", "rwkv6": "rwkv6_3b",
            "internvl2": "internvl2_1b", "jamba": "jamba_1_5_large_398b",
            "seamless": "seamless_m4t_medium"}
# (family, mesh, global batch, cache_len)
CASES = ([(f, sh, BATCH, CACHE_LEN) for f in FAMILIES
          for sh in ((1, 1, 2), (1, 2, 2))]
         + [("jamba", (1, 1, 4), BATCH, 18), ("jamba", (1, 2, 2), 1,
                                              CACHE_LEN)])
REF_FAMILIES = ("qwen2.5", "jamba", "seamless")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_of(arch, n_units=2):
    return build(dataclasses.replace(get_smoke_config(arch, n_units=n_units),
                                     dtype="float32"))


def batch_of(cfg, B, seed=0):
    """Prompts of PROMPT tokens, with a frontend's frames (enc-dec) or
    patch embeddings (vision)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab,
                                                  (B, PROMPT)))}
    if cfg.frontend is not None:
        out["frames" if cfg.enc_n_units else "mm_embeds"] = torch.as_tensor(
            rng.standard_normal((B, cfg.frontend.n_tokens,
                                 cfg.frontend.embed_dim)).astype(np.float32))
    return out


def _copy(cache):
    return tree_util.tree_map(lambda t: t.clone(), cache)


def greedy(prefill, step, params, batch):
    """The prefill then STEPS greedy steps -> {"logits": [prefill's last,
    each step's] [B, V], "tokens", "caches": after the prefill and after
    each step}."""
    lg, cache = prefill(params, batch)
    out = {"logits": [lg[:, -1]], "caches": [_copy(cache)], "tokens": []}
    for _ in range(STEPS):
        tok = out["logits"][-1].argmax(-1)[:, None]
        out["tokens"].append(tok[:, 0])
        lg, cache = step(params, tok, cache)
        out["logits"].append(lg[:, 0])
        out["caches"].append(_copy(cache))
    return out


@functools.lru_cache(maxsize=None)
def mesh_free(family, B, cache_len):
    api = model_of(FAMILIES[family])
    params = api.init(seed=0, device="cpu")
    with torch.no_grad():
        return greedy(lambda p, b: api.prefill(p, b, cache_len),
                      api.decode_step, params, batch_of(api.cfg, B))


def serve_rank(api, params, batch, mesh, coords, B, cache_len, comm=None):
    """One rank's pod prefill and greedy steps, on its blocks of
    ``params`` (a mesh-free tree), and its parameter blocks' shapes."""
    local = wp.pod_serve_params(params, api.cfg, mesh, coords, device="cpu")
    prefill, step = wp.make_pod_serve(api, mesh, B, cache_len, comm=comm)
    out = greedy(prefill, step, local, batch)
    out["shapes"] = {p: tuple(t.shape)
                     for p, t in tree_util.flatten_with_paths(local)}
    return out


def on_threads(family, shape, B, cache_len, params=None):
    api = model_of(FAMILIES[family])
    params = params if params is not None else api.init(seed=0,
                                                        device="cpu")
    sizes = dict(zip(AXES, shape))
    batch = batch_of(api.cfg, B)
    return wp.in_threads(sizes, lambda coords, shards: serve_rank(
        api, params, batch, wp.AxisSizes(sizes), coords, B, cache_len,
        comm=shards.comm))


def check_ranks(got, family, shape, B, cache_len):
    """Every rank's logits, tokens, cache blocks and parameter blocks
    against the mesh-free run."""
    want = mesh_free(family, B, cache_len)
    api = model_of(FAMILIES[family])
    sizes = dict(zip(AXES, shape))
    mesh = wp.AxisSizes(sizes)
    meta = api.init(device="meta")
    specs = dict(tree_util.flatten_with_paths(param_shardings(
        meta, api.cfg, mesh)))
    for c, r in got.items():
        coords = dict(zip(AXES, c))
        for s, (g, w) in enumerate(zip(r["logits"], want["logits"])):
            err = float((g - w).abs().max())
            assert err <= TOL * float(w.abs().max()), (c, s, err)
        for g, w in zip(r["tokens"], want["tokens"]):
            assert torch.equal(g, w), c
        for s, (g, w) in enumerate(zip(r["caches"], want["caches"])):
            placed = dict(tree_util.flatten_with_paths(shard_tree(
                w, cache_placement(w, mesh, B), mesh, coords)))
            for path, t in tree_util.flatten_with_paths(g):
                ref = placed[path]
                assert t.shape == ref.shape, (c, s, path, t.shape)
                if not t.is_floating_point():
                    assert torch.equal(t, ref), (c, s, path)
                    continue
                err = float((t - ref).abs().max())
                assert err <= TOL * max(float(ref.abs().max()), 1e-30), (
                    c, s, path, err)
        for path, leaf in tree_util.flatten_with_paths(meta):
            blocks = [int(np.prod([sizes[a] for a in
                                   (e if isinstance(e, tuple) else (e,))]))
                      if e is not None else 1 for e in specs[path]]
            assert r["shapes"][path] == tuple(
                d // n for d, n in zip(leaf.shape, blocks)), (c, path)


@pytest.mark.parametrize("family,shape,B,cache_len", CASES)
def test_pod_serve_matches_the_mesh_free_port(family, shape, B, cache_len):
    got = on_threads(family, shape, B, cache_len)
    check_ranks(got, family, shape, B, cache_len)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _shared(arch):
    """One f32 smoke parameter tree as numpy arrays, fed to both
    packages: the reference takes them as they are, the port through
    ``convert.params_from_jax``."""
    params = model_of(arch).init(seed=1, device="cpu")
    return tree_util.tree_map(lambda t: t.numpy(), params)


def _reference_prefill(arch, B, cache_len):
    """The reference's own mesh-free ``prefill`` (JAX, CPU) on
    :func:`_shared`'s parameters -> last-token logits [B, V]."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as j_smoke
    from repro.models import Runtime
    from repro.models import build as j_build
    cfg = dataclasses.replace(j_smoke(arch, n_units=2), dtype="float32")
    params = jax.tree_util.tree_map(jnp.asarray, _shared(arch))
    batch = {k: jnp.asarray(v.numpy().astype(
        np.int32 if k == "tokens" else np.float32))
        for k, v in batch_of(model_of(arch).cfg, B).items()}
    lg, _ = j_build(cfg).prefill(params, batch, Runtime(remat_policy="none"),
                                 cache_len)
    return torch.as_tensor(np.array(lg)[:, -1])


@pytest.mark.parametrize("family", REF_FAMILIES)
def test_pod_prefill_matches_the_reference(family):
    """The pod prefill on (1, 2, 2) of the reference's parameters within
    REF_TOL of the largest |logit| of the reference's prefill."""
    from repro_torch.convert import params_from_jax
    arch = FAMILIES[family]
    want = _reference_prefill(arch, BATCH, CACHE_LEN)
    got = on_threads(family, (1, 2, 2), BATCH, CACHE_LEN,
                     params=params_from_jax(_shared(arch), device="cpu"))
    for c, r in got.items():
        err = float((r["logits"][0] - want).abs().max())
        assert err <= REF_TOL * float(want.abs().max()), (family, c, err)


# ---------------------------------------------------------------------------
# gloo ranks: the real collectives
# ---------------------------------------------------------------------------

CHILD = r"""
import sys, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[5])
import test_torch_pod_serve as t
from repro_torch.launch.mesh import make_production_mesh
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
family, shape, B, L = sys.argv[6], tuple(int(n) for n in sys.argv[7].split(",")), int(sys.argv[8]), int(sys.argv[9])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
mesh = make_production_mesh(shape=shape, device="cpu")
coords = tuple(mesh.get_local_rank(a) for a in t.AXES)
api = t.model_of(t.FAMILIES[family])
with torch.no_grad():
    res = t.serve_rank(api, api.init(seed=0, device="cpu"),
                       t.batch_of(api.cfg, B), mesh, None, B, L)
torch.save((coords, res), out)
dist.destroy_process_group()
"""


def test_pod_serve_on_gloo_ranks(tmp_path):
    """jamba on (1, 2, 2) as four gloo processes: the mesh's own
    collectives (``collectives.MeshComm``) held as the threads are."""
    from mesh_cases import free_port
    family, shape = "jamba", (1, 2, 2)
    n, port = int(np.prod(shape)), free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    here = os.path.dirname(os.path.abspath(__file__))
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(n)]
    kids = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(n), str(port), outs[r],
         here, family, ",".join(map(str, shape)), str(BATCH),
         str(CACHE_LEN)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]
    try:
        for p in kids:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in kids:
            if p.poll() is None:
                p.kill()
    got = dict(torch.load(o) for o in outs)
    assert sorted(got) == sorted(wp._coords(dict(zip(AXES, shape))))
    check_ranks(got, family, shape, BATCH, CACHE_LEN)


# ---------------------------------------------------------------------------
# Every registered config: no leaf gathered over "model"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_no_leaf_is_gathered_over_model_when_serving(arch, monkeypatch):
    """The pod prefill and a decode step on (1, 2, 2) threads gather
    leaves over "data" only (``within_pod._gather_dim`` recorded)."""
    record = []
    gather = wp._gather_dim

    def recorded(t, dim, run, axis):
        record.append(axis)
        return gather(t, dim, run, axis)

    monkeypatch.setattr(wp, "_gather_dim", recorded)
    api = model_of(arch, n_units=1)
    params = api.init(seed=0, device="cpu")
    sizes = dict(zip(AXES, (1, 2, 2)))
    batch = batch_of(api.cfg, BATCH)

    def rank(coords, shards):
        mesh = wp.AxisSizes(sizes)
        local = wp.pod_serve_params(params, api.cfg, mesh, coords,
                                    device="cpu")
        prefill, step = wp.make_pod_serve(api, mesh, BATCH, 16,
                                          comm=shards.comm)
        lg, cache = prefill(local, batch)
        lg, _ = step(local, lg[:, -1].argmax(-1)[:, None], cache)
        return lg

    got = wp.in_threads(sizes, rank)
    assert all(torch.isfinite(lg).all() for lg in got.values())
    assert "data" in record and "model" not in record, (arch, set(record))
