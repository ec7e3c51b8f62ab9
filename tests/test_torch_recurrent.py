"""The port's recurrent blocks (``repro_torch/models/rwkv.py``,
``repro_torch/models/mamba.py``) against ``repro/models/rwkv.py`` and
``repro/models/mamba.py`` on the same numpy-seeded inputs and the
reference's weights (noise added to the leaves its init leaves at zero:
rwkv's bonus u and token-shift mixes, mamba's conv bias).  f32
throughout.  The chunked forms sum in other orders than the reference's
(mamba's intra-chunk scan is log-depth where the reference's is an
associative scan), so outputs and states are held within an absolute
2e-5 and a relative 1e-4; chunk sizes that divide T and that do not;
state carried across calls; prefill then decode steps equal to one
forward; and the reference's own naive recurrences
(``tests/test_ssm_blocks.py``) as a second oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_ssm_blocks import naive_rwkv_heads, naive_ssm

from repro.configs.base import MambaCfg, RWKVCfg
from repro.models import mamba as jm
from repro.models import rwkv as jr
from repro.models.transformer import init_mamba, init_rwkv
from repro_torch.models import mamba as tm
from repro_torch.models import rwkv as tr

TOL = dict(rtol=1e-4, atol=2e-5)
# the reference's functions jitted whole (op-by-op dispatch of their scans
# compiles several times slower)
J_TIME_MIX = jax.jit(jr.rwkv_time_mix, static_argnames=("cfg", "chunk",
                                                        "impl"))
J_CHANNEL_MIX = jax.jit(jr.rwkv_channel_mix)
J_MAMBA = jax.jit(jm.mamba_forward, static_argnames=("cfg", "chunk"))
J_SCAN = jax.jit(jm._ssm_scan_chunked, static_argnames=("chunk",))
J_CONV = jax.jit(jm._conv1d_causal)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy()


def _noisy(p: dict, names, seed: int, scale: float = 0.3) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (v + scale * rng.normal(size=v.shape)).astype(v.dtype)
            if any(k.startswith(n) for n in names) else v
            for k, v in ((k, np.asarray(v)) for k, v in p.items())}


def _rwkv_setup(d=32, dh=8, seed=0):
    cfg = RWKVCfg(head_dim=dh, decay_lora=8, mix_lora=4)
    p = _noisy(init_rwkv(jax.random.PRNGKey(seed), d, cfg, jnp.float32),
               ("u", "mu_"), seed)
    return cfg, {k: jnp.asarray(v) for k, v in p.items()}, \
        {k: _t(v) for k, v in p.items()}


def _x(shape, seed, scale=0.5):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(
        np.float32)


@pytest.mark.parametrize("impl", ["matmul", "einsum"])
@pytest.mark.parametrize("T,chunk", [(16, 8), (13, 4), (9, 16), (24, 24),
                                     (7, 3)])
def test_rwkv_time_mix_matches_reference(impl, T, chunk):
    cfg, jp, tp = _rwkv_setup()
    x = _x((2, T, 32), T)
    S0 = _x((2, 4, 8, 8), 1, 0.2)
    last = _x((2, 1, 32), 2)
    for state in (None, "given"):
        js = (jnp.asarray(S0), jnp.asarray(last)) if state else None
        ts = (_t(S0), _t(last)) if state else None
        jy, (jS, jl) = J_TIME_MIX(jnp.asarray(x), jp, cfg, state=js,
                                  chunk=chunk, impl=impl)
        ty, (tS, tl) = tr.rwkv_time_mix(_t(x), tp, cfg, state=ts,
                                        chunk=chunk, impl=impl)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
        np.testing.assert_allclose(_np(tS), np.asarray(jS), **TOL)
        np.testing.assert_array_equal(_np(tl), np.asarray(jl))


def test_rwkv_chunk_math_matches_naive_recurrence():
    """The port's chunk step over random r/k/v/log w (the reference's
    ``naive_rwkv_heads`` oracle), exact and factorised forms."""
    rng = np.random.default_rng(1)
    B, T, H, dh, L = 2, 12, 2, 4, 5
    r, k, v = (rng.normal(0, 1, (B, T, H, dh)).astype(np.float32)
               for _ in range(3))
    logw = -rng.uniform(0.01, 2.0, (B, T, H, dh)).astype(np.float32)
    u = rng.normal(0, 1, (H, dh)).astype(np.float32)
    S0 = rng.normal(0, 1, (B, H, dh, dh)).astype(np.float32)
    y_ref, S_ref = naive_rwkv_heads(*(jnp.asarray(a) for a in
                                      (r, k, v, logw, u, S0)))
    pad = (-T) % L
    padded = [torch.nn.functional.pad(_t(a), (0, 0, 0, 0, 0, pad))
              for a in (r, k, v, logw)]
    for impl in ("einsum", "matmul"):
        S, ys = _t(S0), []
        for c in range((T + pad) // L):
            sl = slice(c * L, (c + 1) * L)
            ci = torch.cumsum(padded[3][:, sl], dim=1)
            S, y = tr._chunk_step(S, padded[0][:, sl], padded[1][:, sl],
                                  padded[2][:, sl], ci,
                                  ci - padded[3][:, sl], _t(u), impl)
            ys.append(y)
        np.testing.assert_allclose(_np(torch.cat(ys, 1)[:, :T]),
                                   np.asarray(y_ref), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(S), np.asarray(S_ref), rtol=1e-4,
                                   atol=1e-4)


def test_rwkv_prefill_then_decode_equals_one_forward():
    cfg, _, tp = _rwkv_setup(seed=3)
    x = _t(_x((2, 21, 32), 5))
    y_full, (S_full, _) = tr.rwkv_time_mix(x, tp, cfg, chunk=8)
    y0, st = tr.rwkv_time_mix(x[:, :13], tp, cfg, chunk=8)
    ys = [y0]
    for t in range(13, 21):
        y, st = tr.rwkv_time_mix(x[:, t:t + 1], tp, cfg, state=st, chunk=1,
                                 impl="einsum")
        ys.append(y)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(y_full), **TOL)
    np.testing.assert_allclose(_np(st[0]), _np(S_full), **TOL)


def test_rwkv_channel_mix_matches_reference():
    from repro.configs.base import BlockCfg, FFNCfg
    from repro.models.transformer import init_block

    class _C:
        d_model = 16
        dtype = "float32"
        cross_attn = False
        name = "t"
        rms_eps = 1e-6
    b = BlockCfg(kind="rwkv", rwkv=RWKVCfg(head_dim=8, decay_lora=4,
                                           mix_lora=4),
                 ffn=FFNCfg(d_ff=32, activation="relu2"))
    p = _noisy(init_block(jax.random.PRNGKey(3), _C, b)["ffn"],
               ("cm_mu",), 4)
    x = _x((2, 6, 16), 6)
    last = _x((2, 1, 16), 7)
    for st in (None, last):
        jy, jl = J_CHANNEL_MIX(jnp.asarray(x),
                                     {k: jnp.asarray(v) for k, v in p.items()},
                                     state=None if st is None
                                     else jnp.asarray(st))
        ty, tl = tr.rwkv_channel_mix(_t(x), {k: _t(v) for k, v in p.items()},
                                     state=None if st is None else _t(st))
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
        np.testing.assert_array_equal(_np(tl), np.asarray(jl))


def test_init_rwkv_state_shapes():
    cfg = RWKVCfg(head_dim=8, decay_lora=4, mix_lora=4)
    want = jr.init_rwkv_state(3, 32, cfg, jnp.float32)
    got = tr.init_rwkv_state(3, 32, cfg, torch.float32, device="cpu")
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape and not g.any()
    assert got[0].dtype == torch.float32


# ---------------------------------------------------------------- mamba


def _mamba_setup(d=16, seed=0, d_state=4, dt_rank=4):
    cfg = MambaCfg(d_state=d_state, d_conv=4, expand=2, dt_rank=dt_rank)
    p = _noisy(init_mamba(jax.random.PRNGKey(seed), d, cfg, jnp.float32),
               ("conv_b",), seed, 0.1)
    return cfg, {k: jnp.asarray(v) for k, v in p.items()}, \
        {k: _t(v) for k, v in p.items()}


@pytest.mark.parametrize("T", [1, 3, 10])
def test_conv1d_causal_matches_reference(T):
    x = _x((2, T, 6), T)
    w = _x((4, 6), 1)
    b = _x((6,), 2)
    pre = _x((2, 3, 6), 3)
    for prefix in (None, pre):
        want = J_CONV(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), None if prefix is None
                                 else jnp.asarray(prefix))
        got = tm._conv1d_causal(_t(x), _t(w), _t(b), None if prefix is None
                                else _t(prefix))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("T,chunk", [(8, 4), (10, 4), (16, 16), (7, 3),
                                     (33, 8), (5, 64)])
def test_ssm_scan_matches_reference_and_naive(T, chunk):
    rng = np.random.default_rng(T)
    B, Din, S = 2, 6, 4
    dt = rng.uniform(0.1, 0.5, (B, T, Din)).astype(np.float32)
    A = -rng.uniform(0.1, 1.0, (Din, S)).astype(np.float32)
    Bs, C = (rng.normal(0, 1, (B, T, S)).astype(np.float32) for _ in range(2))
    x = rng.normal(0, 1, (B, T, Din)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, Din, S)).astype(np.float32)
    jy, jh = J_SCAN(*(jnp.asarray(a) for a in (dt, A, Bs, C, x, h0)),
                    chunk=chunk)
    ty, th = tm._ssm_scan_chunked(*(_t(a) for a in (dt, A, Bs, C, x, h0)),
                                  chunk=chunk)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(_np(th), np.asarray(jh), **TOL)
    dA = jnp.exp(jnp.asarray(dt)[..., None] * jnp.asarray(A)[None, None])
    dBx = jnp.asarray(dt * x)[..., None] * jnp.asarray(Bs)[:, :, None, :]
    ny, nh = naive_ssm(dA, dBx, jnp.asarray(C), jnp.asarray(h0))
    np.testing.assert_allclose(_np(ty), np.asarray(ny), atol=1e-4)
    np.testing.assert_allclose(_np(th), np.asarray(nh), atol=1e-4)


@pytest.mark.parametrize("T,chunk", [(10, 4), (16, 8), (5, 64)])
def test_mamba_forward_matches_reference(T, chunk):
    cfg, jp, tp = _mamba_setup()
    x = _x((2, T, 16), T)
    h0 = _x((2, 32, 4), 1, 0.3)
    conv = _x((2, 3, 32), 2)
    for state in (None, "given"):
        js = (jnp.asarray(h0), jnp.asarray(conv)) if state else None
        ts = (_t(h0), _t(conv)) if state else None
        jy, (jh, jc) = J_MAMBA(jnp.asarray(x), jp, cfg, state=js,
                               chunk=chunk)
        ty, (th, tc) = tm.mamba_forward(_t(x), tp, cfg, state=ts,
                                        chunk=chunk)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
        np.testing.assert_allclose(_np(th), np.asarray(jh), **TOL)
        np.testing.assert_array_equal(_np(tc), np.asarray(jc))


def test_mamba_decode_step_matches_reference():
    cfg, jp, tp = _mamba_setup(seed=2)
    jst = jm.init_mamba_state(2, 16, cfg, jnp.float32)
    tst = tm.init_mamba_state(2, 16, cfg, torch.float32, device="cpu")
    for t in range(6):
        x = _x((2, 1, 16), 10 + t)
        jy, jst = J_MAMBA(jnp.asarray(x), jp, cfg, state=jst, chunk=1)
        ty, tst = tm.mamba_decode_step(_t(x), tp, cfg, tst)
        np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
        np.testing.assert_allclose(_np(tst[0]), np.asarray(jst[0]), **TOL)


@pytest.mark.parametrize("T0", [1, 5, 17])
def test_mamba_prefill_then_decode_equals_one_forward(T0):
    cfg, _, tp = _mamba_setup(seed=4)
    x = _t(_x((2, 24, 16), 8))
    y_full, (h_full, c_full) = tm.mamba_forward(x, tp, cfg, chunk=8)
    y0, st = tm.mamba_forward(x[:, :T0], tp, cfg, chunk=8)
    ys = [y0]
    for t in range(T0, 24):
        y, st = tm.mamba_decode_step(x[:, t:t + 1], tp, cfg, st)
        ys.append(y)
    np.testing.assert_allclose(_np(torch.cat(ys, 1)), _np(y_full), **TOL)
    np.testing.assert_allclose(_np(st[0]), _np(h_full), **TOL)
    np.testing.assert_allclose(_np(st[1]), _np(c_full), **TOL)


def test_chunked_scans_backward_matches_unchunked():
    """Autograd through the checkpointed chunk steps gives the gradients
    of one chunk over the whole sequence."""
    cfg, _, tp = _mamba_setup(seed=5)
    rcfg, _, rp = _rwkv_setup(seed=6)
    x = _t(_x((2, 20, 16), 9)).requires_grad_(True)
    xr = _t(_x((2, 20, 32), 10)).requires_grad_(True)
    grads = []
    for chunk in (4, 32):
        gm = torch.autograd.grad(tm.mamba_forward(x, tp, cfg,
                                                  chunk=chunk)[0].square()
                                 .sum(), x)[0]
        gr = torch.autograd.grad(tr.rwkv_time_mix(xr, rp, rcfg,
                                                  chunk=chunk)[0].square()
                                 .sum(), xr)[0]
        grads.append((gm, gr))
    for a, b in zip(*grads):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)


def test_init_mamba_state_shapes():
    cfg = MambaCfg(d_state=4, d_conv=4, expand=2, dt_rank=4)
    want = jm.init_mamba_state(3, 16, cfg, jnp.float32)
    got = tm.init_mamba_state(3, 16, cfg, torch.float32, device="cpu")
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape and not g.any()
    assert tm._dt_rank(dataclasses.replace(cfg, dt_rank=None), 40) == 3
