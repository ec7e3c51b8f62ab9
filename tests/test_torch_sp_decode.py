"""Sequence-parallel flash decoding of the port: ``decode_attention_partial``
against the reference's on the same numpy inputs (window, softcap,
``start``), the rank-order combine against the reference's two-halves
combine (``tests/test_attention.py``), and the decode step over a ring
cut along the sequence on gloo ranks (a (data, model) mesh, each rank a
child process on one torch thread): (1, 2) at batch 2 and (2, 2) at
batch 1 (the sequence over every axis, the long-context layout), each
within 2e-5 of the largest |logit| of local decode with the same greedy
tokens, and a ring that does not divide over the shards running local
attention.  The vocab-parallel lookup's forward and table gradient on
(1, 2) are bitwise the unsharded lookup's on the rank's rows."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AttnCfg as JAttnCfg
from repro.models import attention as jattn
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import AttnCfg
from repro_torch.distributed.collectives import combine_partials
from repro_torch.models import attention as tattn
from repro_torch.models import build

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TOL = 2e-5          # of the largest |logit| of local decode (f32)
PROMPT, STEPS = 12, 6
# (name, mesh (data, model), batch, cache_len): 16 divides over 2 and 4
# sequence shards, 18 over neither (local attention on every rank)
CASES = (("b2", (1, 2), 2, 16), ("b1", (2, 2), 1, 16),
         ("odd", (2, 2), 1, 18))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B=2, S=16, Hq=4, Hkv=2, D=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    pos[3] = -1                         # an empty slot
    return q, k, v, pos


@pytest.mark.parametrize("window,cap,start", [
    (None, None, False), (6, None, False), (None, 5.0, True),
    (6, 5.0, True)])
def test_decode_attention_partial_matches_reference(window, cap, start):
    q, k, v, pos = _qkv(0)
    cur = 14
    st = np.array([0, 9], np.int32) if start else None
    jcfg = JAttnCfg(n_q=4, n_kv=2, head_dim=8, window=window,
                    attn_softcap=cap)
    tcfg = AttnCfg(n_q=4, n_kv=2, head_dim=8, window=window,
                   attn_softcap=cap)
    want = jattn.decode_attention_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(cur, jnp.int32), jcfg,
        start=None if st is None else jnp.asarray(st))
    got = tattn.decode_attention_partial(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(pos), torch.tensor(cur, dtype=torch.int32), tcfg,
        start=None if st is None else torch.as_tensor(st))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_flash_combine_matches_the_reference_two_halves():
    """The cache cut in two: the rank-order combine of the halves'
    partials equals the reference's two-halves combine and attention over
    the whole cache."""
    q, k, v, pos = _qkv(4, B=1)
    pos = np.arange(16, dtype=np.int32)
    cfg = AttnCfg(n_q=4, n_kv=2, head_dim=8)
    jcfg = JAttnCfg(n_q=4, n_kv=2, head_dim=8)
    cur = 15
    halves, jhalves = [], []
    for sl in (slice(0, 8), slice(8, 16)):
        halves.append(tattn.decode_attention_partial(
            torch.as_tensor(q), torch.as_tensor(k[:, sl]),
            torch.as_tensor(v[:, sl]), torch.as_tensor(pos[sl]),
            torch.tensor(cur), cfg))
        jhalves.append(jattn.decode_attention_partial(
            jnp.asarray(q), jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
            jnp.asarray(pos[sl]), jnp.asarray(cur), jcfg))
    got = combine_partials(*(torch.stack([h[i] for h in halves])
                             for i in range(3)))
    m = jnp.maximum(jhalves[0][1], jhalves[1][1])
    l = sum(h[2] * jnp.exp(h[1] - m) for h in jhalves)
    o = sum(h[0] * jnp.exp(h[1] - m)[..., None] for h in jhalves)
    want = o / jnp.maximum(l[..., None], 1e-30)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)
    whole = tattn.finalize_partial(*tattn.decode_attention_partial(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(pos), torch.tensor(cur), cfg))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=2e-6)


def _model():
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("qwen2_5_3b", n_units=2),
                              dtype="float32")
    api = build(cfg)
    return api, api.init(seed=0, device="cpu")


def _prompts(batch):
    rng = np.random.default_rng(batch)
    return torch.as_tensor(rng.integers(1, 512, (batch, PROMPT)))


def decode_run(api, params, tokens, cache_len, mesh=None):
    """Greedy decode of ``tokens`` for STEPS steps -> (logits [STEPS, B,
    V], tokens).  With ``mesh`` this rank prefills its rows, keeps its
    sequence slice (``shard_decode_cache``) and decodes through the
    sequence-parallel attention."""
    from repro_torch.distributed.collectives import (make_sp_decode_attn,
                                                     shard_decode_cache)
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  decode_layout,
                                                  local_shard)
    B = tokens.shape[0]
    attn = None
    if mesh is not None:
        if decode_layout(mesh, B)[0] is not None:
            tokens = local_shard(tokens, batch_shardings(tokens, mesh),
                                 mesh)
        attn = make_sp_decode_attn(mesh, B, cache_len)
    lg, cache = api.prefill(params, {"tokens": tokens}, cache_len)
    if mesh is not None:
        cache = shard_decode_cache(cache, mesh, B)
    tok = lg[:, -1].argmax(-1)[:, None]
    logits, toks = [], []
    for _ in range(STEPS):
        lg, cache = api.decode_step(params, tok, cache, decode_attn=attn)
        logits.append(lg[:, 0])
        tok = lg[:, 0].argmax(-1)[:, None]
        toks.append(tok[:, 0])
    return torch.stack(logits), torch.stack(toks)


CHILD = r"""
import sys, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[6])
import test_torch_sp_decode as t
from repro_torch.distributed.collectives import make_vp_embed_lookup
from repro_torch.distributed.sharding import local_shard
from repro_torch.launch.mesh import make_production_mesh
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
names = sys.argv[5].split(",")
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
cases = {c[0]: c for c in t.CASES}
mesh = make_production_mesh(shape=cases[names[0]][1], device="cpu")
api, params = t._model()
res = {}
for name in names:
    _, _, B, L = cases[name]
    res[name] = t.decode_run(api, params, t._prompts(B), L, mesh)
if cases[names[0]][1] == (1, 2):
    table = local_shard(params["embed"], ("model", None), mesh)
    table.requires_grad_(True)
    toks = t._prompts(3)
    x = make_vp_embed_lookup(mesh)(table, toks)
    w = torch.linspace(-1, 1, x.numel()).reshape(x.shape)
    (g,) = torch.autograd.grad((x * w).sum(), table)
    res["vp"] = (x.detach(), g)
torch.save(res, out)
dist.destroy_process_group()
"""


def _run(shape, names, tmp_path) -> list:
    from mesh_cases import free_port
    n = shape[0] * shape[1]
    port = free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    here = os.path.dirname(os.path.abspath(__file__))
    outs = [str(tmp_path / f"sp{r}.pt") for r in range(n)]
    kids = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(n), str(port), outs[r],
         ",".join(names), here], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]
    try:
        for p in kids:
            _, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in kids:
            if p.poll() is None:
                p.kill()
    return [torch.load(o) for o in outs]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sp_decode_matches_local_decode(shape, tmp_path):
    names = [c[0] for c in CASES if c[1] == shape]
    got = _run(shape, names, tmp_path)
    api, params = _model()
    for name in names:
        _, _, B, L = next(c for c in CASES if c[0] == name)
        want_l, want_t = decode_run(api, params, _prompts(B), L)
        tol = TOL * float(want_l.abs().max())
        for r, res in enumerate(got):
            lg, toks = res[name]
            assert torch.equal(toks, want_t), (name, r)
            err = float((lg - want_l).abs().max())
            assert err <= tol, (name, r, err, tol)
        # every rank of the mesh holds the same combined logits
        for res in got[1:]:
            assert torch.equal(res[name][0], got[0][name][0])
    if shape == (1, 2):
        toks = _prompts(3)
        table = params["embed"].clone().requires_grad_(True)
        x = table[toks]
        w = torch.linspace(-1, 1, x.numel()).reshape(x.shape)
        (g,) = torch.autograd.grad((x * w).sum(), table)
        rows = table.shape[0] // 2
        for r, res in enumerate(got):
            xr, gr = res["vp"]
            assert torch.equal(xr, x.detach())
            assert torch.equal(gr, g[r * rows:(r + 1) * rows])
