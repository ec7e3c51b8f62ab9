"""The model families outside the overlay in the port, against the JAX
package at smoke size on the reference's weights (carried by
``repro_torch.convert``; seeded noise on the leaves its init leaves at
zero or one, so those branches carry values): rwkv6-3b (rwkv blocks),
jamba-1.5-large (mamba blocks, an attention block, MoE FFNs),
seamless-m4t-medium (encoder, cross-attention, audio stub frames) and
internvl2-1b (vision stub prefix).  f32.  Loss, forward logits, prefill
and two decode steps (as ``tests/test_arch_smoke.py`` drives them), with
the scans at chunk 8 over a 24-token prompt so several chunks run; init
leaves, the full configs and the overlay plan (none, in both packages).
Logits are held within an absolute 5e-5 and a relative 1e-4 (sums in
other orders; the chunked scans' orders differ too).  The merge-path
engine is held in ``test_torch_family_serve.py``, training in
``test_torch_family_train.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, get_smoke_config
from repro.models import Runtime, build
from repro.models.delta import plan_overlay as j_plan_overlay
from repro_torch import tree as tree_util
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import build as t_build
from repro_torch.models import mamba as t_mamba
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models.delta import plan_overlay

FAMILIES = ("rwkv6_3b", "jamba_1_5_large_398b", "seamless_m4t_medium",
            "internvl2_1b")
TOL = dict(rtol=1e-4, atol=5e-5)
# leaves the reference's init fills with constants; the tests put seeded
# noise on them so their branches carry values
NOISY = ("u", "mu_x", "mu_w", "mu_k", "mu_v", "mu_r", "mu_g", "cm_mu_k",
         "cm_mu_r", "conv_b", "ln_x_bias", "bq", "bk", "bv", "cross_norm")
B, T = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUPS: dict = {}


def _setup(arch, n_units=2):
    key = (arch, n_units)
    if key not in _SETUPS:
        cfg = get_smoke_config(arch, n_units=n_units)
        api = build(cfg)
        base = api.init(jax.random.PRNGKey(0))
        nrng = np.random.default_rng(3)
        base = jax.tree_util.tree_map_with_path(
            lambda path, l: (l + 0.3 * nrng.normal(size=l.shape)).astype(
                l.dtype) if path[-1].key in NOISY else l, base)
        tbase = params_from_jax(jax.tree_util.tree_map(np.asarray, base),
                                device="cpu")
        _SETUPS[key] = (cfg, api, base, t_build(t_smoke(arch,
                                                         n_units=n_units)),
                        tbase)
    return _SETUPS[key]


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    batch = {"tokens": toks,
             "targets": np.concatenate([toks[:, 1:],
                                        np.full((B, 1), -1, np.int32)], 1)}
    if cfg.family in ("vlm", "audio"):
        key = "mm_embeds" if cfg.family == "vlm" else "frames"
        batch[key] = rng.normal(0, 1, (B, cfg.frontend.n_tokens,
                                       cfg.frontend.embed_dim)
                                ).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_prefill_decode_match_reference(arch, monkeypatch):
    """Loss (1e-5 relative), logits of the whole sequence, prefill's last
    logits and two decode steps' logits; the caches' recurrent states and
    cross-KV after them; ``cur`` counts the mm prefix."""
    monkeypatch.setattr(t_mamba, "CHUNK", 8)
    monkeypatch.setattr(t_rwkv, "CHUNK", 8)
    rt = Runtime(attn_chunk_q=16, attn_chunk_k=16, mamba_chunk=8,
                 rwkv_chunk=8, remat_policy="none")
    cfg, api, base, tapi_m, tbase = _setup(arch)
    jb, tb = _batch(cfg)
    jloss, (jlog, jaux) = jax.jit(lambda p, b: api.loss_and_logits(
        p, b, rt))(base, jb)
    with torch.no_grad():
        tloss, (tlog, taux) = tapi_m.loss_and_logits(tbase, tb)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-4, abs=1e-7)
    assert tuple(tlog.shape) == (B, T, cfg.vocab)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    n_mm = cfg.frontend.n_tokens if cfg.family == "vlm" else 0
    cache_len = T + n_mm + 8
    jl, jc = api.prefill(base, jb, rt, cache_len=cache_len)
    with torch.no_grad():
        tl, tc = tapi_m.prefill(tbase, tb, cache_len)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        for _ in range(2):
            tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
            jl, jc = api.decode_step(base, jnp.asarray(tok), jc, rt)
            tl, tc = tapi_m.decode_step(tbase, torch.from_numpy(tok), tc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tc["cur"]) == int(jc["cur"]) == T + n_mm + 2
    for name, layer in jc["layers"].items():
        for k, v in layer.items():
            if k == "pos":
                np.testing.assert_array_equal(tc["layers"][name][k].numpy(),
                                              np.asarray(v))
            else:
                np.testing.assert_allclose(tc["layers"][name][k].numpy(),
                                           np.asarray(v), **TOL,
                                           err_msg=f"{name}/{k}")
    assert ("cross" in tc) == ("cross" in jc) == (arch ==
                                                  "seamless_m4t_medium")
    if "cross" in jc:
        for k in ("k", "v"):
            np.testing.assert_allclose(tc["cross"][k].numpy(),
                                       np.asarray(jc["cross"][k]), **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_has_reference_leaves(arch):
    """The port's init makes the reference's tree: paths, shapes, dtypes;
    the constant leaves (norms, rwkv's decay base, mamba's A and dt bias,
    D) equal; the encoder's blocks hold cross leaves, as the reference's
    do."""
    cfg, api, _, tapi_m, _ = _setup(arch)
    ref = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.jit(api.init)(jax.random.PRNGKey(0))), device="cpu")
    mine = dict(tree_util.flatten_with_paths(tapi_m.init(seed=0,
                                                         device="cpu")))
    ref = dict(tree_util.flatten_with_paths(ref))
    assert sorted(mine) == sorted(ref)
    for path, leaf in ref.items():
        assert mine[path].shape == leaf.shape, path
        assert mine[path].dtype == leaf.dtype, path
        if path.rsplit("/", 1)[-1] in ("pre_norm", "ffn_norm", "final_norm",
                                       "norm", "cross_norm",
                                       "enc_final_norm", "w0", "A_log",
                                       "dt_bias", "D_skip", "u",
                                       "ln_x_scale", "ln_x_bias", "mu_x",
                                       "conv_b"):
            assert torch.equal(mine[path], leaf), path
    assert any("enc_blocks/block0/cross/" in p for p in mine) == (
        arch == "seamless_m4t_medium")
    assert ("frontend_proj" in mine) == (cfg.frontend is not None)


@pytest.mark.parametrize("arch", FAMILIES)
def test_full_configs_equal_reference(arch):
    tcfg, jcfg = t_config(arch), get_config(arch)
    assert repr(tcfg) == repr(jcfg)
    assert tcfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", FAMILIES)
def test_no_overlay_plan_in_either_package(arch):
    cfg, _, base, tapi_m, tbase = _setup(arch)
    assert j_plan_overlay(base, cfg) is None
    assert plan_overlay(tbase, tapi_m.cfg) is None
