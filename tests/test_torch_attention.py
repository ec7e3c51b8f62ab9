"""The port's chunked flash attention (``repro_torch.models.attention.
flash_attention``) against the reference's (``repro.models.attention.
flash_attention``, jnp on the CPU) at the same chunk sizes, on inputs
drawn from numpy seeds: the reference's own cases (GQA, a sliding window,
a softcap, a chunk that does not divide T, cross and ragged shapes) plus
left-padded rows (a whole q-chunk inside the pad among them),
``kv_valid_len`` and ``q_offset``, within the reference's 2e-5 in f32 and
3e-2 in bf16; a call of one tile bitwise the whole-matrix arithmetic it
replaced; dq, dk and dv against ``jax.grad`` of the reference over 3 x 3
and more tiles, and ``gradcheck`` in f64; no tensor of a chunked forward
and backward larger than q or four tiles' scores.  Then the model at a
length above the chunk, the port's ``CHUNK_Q``/``CHUNK_K`` set to the
reference's ``Runtime`` chunks: qwen2.5 and gemma2 prefill logits (with
left-padded rows; gemma's window of 32 prunes tiles), a training
gradient, and seamless's encoder and cross-attention prefill."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config
from repro.configs.base import AttnCfg
from repro.models import Runtime, build
from repro.models.attention import flash_attention as j_flash
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as t_attention
from repro_torch.models import build as t_build
from repro_torch.models.attention import flash_attention

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B, T, S, Hq, Hkv, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((B, T, Hq, D), (B, S, Hkv, D),
                               (B, S, Hkv, D)))


def _both(x, dtype="float32"):
    """A numpy array as the reference's and the port's input of ``dtype``
    (the bf16 cast made once, in torch, so both see the same values)."""
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    j = jnp.asarray(t.to(torch.float32).numpy()).astype(dtype)
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _cfg(Hq, Hkv, D, window=None, cap=None):
    return AttnCfg(n_q=Hq, n_kv=Hkv, head_dim=D, window=window,
                   attn_softcap=cap)


# the reference's CASES (tests/test_attention.py):
# (T, S, Hq, Hkv, D, causal, window, cap, chunk)
REF_CASES = [
    (32, 32, 4, 4, 16, True, None, None, 8),
    (32, 32, 4, 2, 16, True, None, None, 8),     # GQA
    (64, 64, 4, 1, 8, True, 16, None, 16),       # SWA
    (32, 32, 2, 2, 16, True, None, 50.0, 8),     # softcap
    (48, 48, 4, 2, 16, True, None, None, 16),    # chunk not dividing T
    (16, 40, 4, 4, 8, False, None, None, 8),     # cross/bidirectional
    (33, 17, 2, 1, 8, False, None, None, 8),     # ragged shapes
]


def _run(case, seed=0, dtype="float32", **kw):
    T, S, Hq, Hkv, D, causal, window, cap, chunk = case
    q, k, v = _qkv(seed, 2, T, S, Hq, Hkv, D)
    (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, k, v))
    cfg = _cfg(Hq, Hkv, D, window, cap)
    jkw = dict(kw)
    tkw = dict(kw)
    if kw.get("kv_start") is not None:
        jkw["kv_start"] = jnp.asarray(kw["kv_start"], jnp.int32)
        tkw["kv_start"] = torch.as_tensor(kw["kv_start"], dtype=torch.int32)
    want = j_flash(jq, jk, jv, cfg, causal=causal, chunk_q=chunk,
                   chunk_k=chunk, **jkw)
    got = flash_attention(tq, tk, tv, cfg, causal=causal, chunk_q=chunk,
                          chunk_k=chunk, **tkw)
    return got, want


@pytest.mark.parametrize("case", REF_CASES)
def test_flash_matches_reference(case):
    got, want = _run(case)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", [REF_CASES[1], REF_CASES[3], REF_CASES[4],
                                  REF_CASES[6]])
def test_flash_bf16_keeps_dtype(case):
    got, want = _run(case, seed=1, dtype="bfloat16")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-2, rtol=3e-2)


# (case, kwargs): left-padded rows (row 1's first 20 positions are pad, a
# whole q-chunk of 8 and part of the next), kv_valid_len, q_offset
EXTRA_CASES = [
    ((32, 32, 4, 2, 16, True, None, None, 8), dict(kv_start=[0, 20])),
    ((48, 48, 4, 1, 8, True, 16, 30.0, 16), dict(kv_start=[3, 17])),
    ((24, 24, 2, 2, 8, False, None, None, 8), dict(kv_start=[9, 0])),
    ((8, 32, 2, 2, 8, False, None, None, 8), dict(kv_valid_len=20)),
    ((16, 40, 4, 2, 8, True, None, None, 8), dict(q_offset=24)),
    ((16, 40, 4, 2, 8, True, 12, None, 8), dict(q_offset=24,
                                                 kv_valid_len=37)),
]


@pytest.mark.parametrize("case,kw", EXTRA_CASES)
def test_flash_masks_match_reference(case, kw):
    got, want = _run(case, seed=2, **kw)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    if kw.get("kv_start") == [0, 20]:
        # row 1's queries inside its pad see no key: zeros, as the
        # reference's
        assert not got[1, :20].any()


def _whole_matrix(q, k, v, cfg, causal=True, kv_start=None):
    """The whole-matrix arithmetic the chunked form replaced: every score
    of [T, S] at once, masked, softmaxed and applied to v in f32."""
    B, T, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, T, Hkv, G, D).to(torch.float32)
    s = torch.einsum("bthgd,bshd->bhgts", qf, k.to(torch.float32))
    s = s * (1.0 / np.sqrt(D))
    if cfg.attn_softcap is not None:
        cap = cfg.attn_softcap
        s = (cap * torch.tanh(s.to(torch.float32) / cap)).to(s.dtype)
    q_pos = torch.arange(T)[:, None]
    k_pos = torch.arange(S)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool)
    if causal:
        mask &= q_pos >= k_pos
    if cfg.window is not None and causal:
        mask &= (q_pos - k_pos) < cfg.window
    mask = mask[None, None, None]
    if kv_start is not None:
        mask = mask & (k_pos[None] >= kv_start.to(torch.int64)[
            :, None, None])[:, None, None]
    s = torch.where(mask, s, t_attention.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= t_attention.NEG_INF / 2, 0.0, m)
    p = torch.exp(s - m_safe) * mask.to(torch.float32)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgts,bshd->bthgd", p, v.to(torch.float32))
    o = o / torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2, 4)
    return o.reshape(B, T, Hq, D).to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,S,causal,window,cap,pad", [
    (37, 37, True, None, None, False),
    (48, 48, True, 16, 50.0, True),
    (20, 64, False, None, None, False),
    (64, 64, True, None, None, True),
])
def test_one_tile_is_the_whole_matrix_bitwise(T, S, causal, window, cap,
                                              pad, dtype):
    """T <= chunk_q and S <= chunk_k: one tile, bitwise the whole-matrix
    arithmetic (the serving prompts' case, whose bitwise gates rest on
    it), at the model's default chunks and at chunks of exactly T and S."""
    q, k, v = (_both(x, dtype)[1] for x in _qkv(3, 2, T, S, 4, 2, 16))
    cfg = _cfg(4, 2, 16, window, cap)
    kv_start = torch.tensor([0, 5], dtype=torch.int32) if pad else None
    want = _whole_matrix(q, k, v, cfg, causal, kv_start)
    for cq, ck in ((t_attention.CHUNK_Q, t_attention.CHUNK_K), (T, S)):
        got = flash_attention(q, k, v, cfg, causal=causal, kv_start=kv_start,
                              chunk_q=cq, chunk_k=ck)
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


# (T, S, causal, window, cap, kv_start, chunk): 3 x 3 tiles and more
GRAD_CASES = [
    (48, 48, True, None, None, None, 16),
    (80, 80, True, 20, None, None, 16),          # the window prunes tiles
    (48, 48, True, None, 20.0, None, 16),
    (48, 48, True, None, None, [0, 19], 16),     # row 1: a whole padded tile
    (80, 80, True, 20, 20.0, [5, 33], 16),
    (40, 56, False, None, 30.0, [0, 7], 16),     # cross, ragged
]


@pytest.mark.parametrize("T,S,causal,window,cap,kv_start,chunk", GRAD_CASES)
def test_gradients_match_reference(T, S, causal, window, cap, kv_start,
                                   chunk):
    """dq, dk, dv of <out, w> (w a fixed random cotangent), f32, each
    within 1e-4 of its largest magnitude: against ``jax.grad`` of the
    reference, and against autograd through the whole-matrix arithmetic.
    The reference's gradient is NaN for the queries of a left-padded row
    that see no key and for the keys of every tile holding such a query
    (a tile step's backward through a row of -2e38 scores), so it is
    compared where it is finite, the whole-matrix one everywhere; rows
    that see no key get exactly zero gradient."""
    Hq, Hkv, D = 4, 2, 16
    q, k, v = _qkv(4, 2, T, S, Hq, Hkv, D)
    w = np.random.default_rng(5).normal(size=q.shape).astype(np.float32)
    cfg = _cfg(Hq, Hkv, D, window, cap)
    js = None if kv_start is None else jnp.asarray(kv_start, jnp.int32)
    ts = None if kv_start is None else torch.as_tensor(kv_start,
                                                       dtype=torch.int32)

    def j_loss(q_, k_, v_):
        o = j_flash(q_, k_, v_, cfg, causal=causal, kv_start=js,
                    chunk_q=chunk, chunk_k=chunk)
        return jnp.sum(o * w)

    def t_grads(fn):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        o = fn(tq, tk, tv)
        return torch.autograd.grad((o * torch.from_numpy(w)).sum(),
                                   (tq, tk, tv))

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = t_grads(lambda a, b, c: flash_attention(
        a, b, c, cfg, causal=causal, kv_start=ts, chunk_q=chunk,
        chunk_k=chunk))
    whole = t_grads(lambda a, b, c: _whole_matrix(a, b, c, cfg, causal, ts))
    for name, g, jg, wg in zip("qkv", got, want, whole):
        jg, wg, g = np.asarray(jg), _np(wg), _np(g)
        fin = np.isfinite(jg)
        assert fin.all() or (kv_start is not None and causal)
        scale = float(np.abs(wg).max())
        assert scale > 0
        np.testing.assert_allclose(g[fin], jg[fin], atol=1e-4 * scale,
                                   rtol=0, err_msg=f"d{name}")
        np.testing.assert_allclose(g, wg, atol=1e-4 * scale, rtol=0,
                                   err_msg=f"d{name} (whole matrix)")
    if kv_start is not None and causal:
        # the queries inside row 1's pad see no key
        assert not got[0][1, :kv_start[1]].any()


def test_gradcheck_f64_two_by_two_tiles():
    """``gradcheck`` in f64 over 2 x 2 tiles: causal, a window, a softcap
    and a left-padded row (whose first queries see no key)."""
    Hq, Hkv, D = 2, 1, 4
    q, k, v = (torch.from_numpy(x).double().requires_grad_()
               for x in _qkv(6, 2, 8, 8, Hq, Hkv, D))
    cfg = _cfg(Hq, Hkv, D, window=6, cap=3.0)
    start = torch.tensor([0, 2], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda a, b, c: flash_attention(a, b, c, cfg, kv_start=start,
                                        chunk_q=4, chunk_k=4),
        (q, k, v))


class _Sizes(TorchDispatchMode):
    """The element count of the largest tensor any op makes."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_no_tensor_of_size_t_by_s():
    """One forward and backward at T = S = 1024 with chunks of 64: no op
    makes a tensor larger than q or four tiles' scores (the whole-matrix
    form makes B Hq T S)."""
    B, T, Hq, Hkv, D, c = 1, 1024, 4, 2, 16, 64
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(7, B, T, T, Hq, Hkv, D))
    cfg = _cfg(Hq, Hkv, D, cap=30.0)
    start = torch.tensor([100], dtype=torch.int32)
    with _Sizes() as sizes:
        o = flash_attention(q, k, v, cfg, kv_start=start, chunk_q=c,
                            chunk_k=c)
        o.square().sum().backward()
    limit = max(q.numel(), B * Hq * c * c * 4)
    assert 0 < sizes.largest <= limit < B * Hq * T * T
    assert q.grad is not None and k.grad is not None and v.grad is not None


# the model above the chunk: the reference at Runtime chunks of 16, the
# port with CHUNK_Q = CHUNK_K = 16
RT16 = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")
MODEL_TOL = dict(rtol=1e-5, atol=2e-5)         # tests/test_torch_model.py


@pytest.fixture
def chunk16(monkeypatch):
    monkeypatch.setattr(t_attention, "CHUNK_Q", 16)
    monkeypatch.setattr(t_attention, "CHUNK_K", 16)


def _model(arch, jcfg=None, tcfg=None):
    jcfg = jcfg or get_smoke_config(arch, n_units=2)
    tcfg = tcfg or t_smoke(arch, n_units=2)
    api = build(jcfg)
    base = api.init(jax.random.PRNGKey(0))
    tbase = params_from_jax(jax.tree_util.tree_map(np.asarray, base),
                            device="cpu")
    return jcfg, api, base, t_build(tcfg), tbase


@pytest.mark.parametrize("arch,T", [("qwen2_5_3b", 50), ("gemma2_9b", 80)])
def test_prefill_above_the_chunk_matches_reference(arch, T, chunk16):
    """Prefill logits and the KV ring over 4-5 q-chunks, with left-padded
    rows; gemma2's smoke window of 32 prunes the tiles outside it."""
    cfg, api, base, tapi_m, tbase = _model(arch)
    rng = np.random.default_rng(8)
    toks = rng.integers(1, cfg.vocab, (3, T)).astype(np.int32)
    start = np.asarray([0, 21, 3], np.int32)
    cache_len = T + 8
    jl, jc = api.prefill(base, {"tokens": jnp.asarray(toks)}, RT16,
                         cache_len, start=jnp.asarray(start))
    with torch.no_grad():
        tl, tc = tapi_m.prefill(tbase, {"tokens": torch.from_numpy(toks)},
                                cache_len, start=torch.from_numpy(start))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL_TOL)
    for name, layer in jc["layers"].items():
        np.testing.assert_allclose(tc["layers"][name]["v"].numpy(),
                                   np.asarray(layer["v"]), **MODEL_TOL)


def test_training_gradient_above_the_chunk_matches_reference(chunk16):
    """qwen2.5 smoke, 4 rows of 48 tokens (3 x 3 tiles, 6 kept): the loss
    within 1e-5 relative, every gradient within 1e-5 of its leaf's
    largest (``tests/test_torch_train.py``'s tolerances)."""
    from repro.data.pipeline import make_batch_for as j_batch
    from repro_torch import tree as tree_util
    from repro_torch.data.pipeline import make_batch_for as t_batch
    from repro_torch.train.train_step import value_and_grad
    cfg, api, base, tapi_m, _ = _model("qwen2_5_3b")
    b = j_batch(cfg, 0, 48, 4, 1)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: api.loss_and_logits(p, b, RT16), has_aux=True))(base)
    tb = t_batch(t_smoke("qwen2_5_3b", n_units=2), 0, 48, 4, 1, device="cpu")
    tloss, tgrads = value_and_grad(
        lambda p, bb: tapi_m.loss_and_logits(p, bb)[0],
        params_from_jax(jax.tree_util.tree_map(np.asarray, base),
                        device="cpu"), tb)
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)
    for g, tg in zip(jax.tree_util.tree_leaves(grads),
                     tree_util.leaves(tgrads)):
        scale = float(np.abs(_np(g)).max()) or 1.0
        np.testing.assert_allclose(_np(tg), _np(g), atol=1e-5 * scale,
                                   rtol=0)


def test_enc_dec_cross_attention_above_the_chunk(chunk16):
    """seamless smoke with 40 stub frames: the encoder's self-attention
    over 3 x 3 non-causal tiles and each decoder block's cross-attention
    over 24 x 40 (2 x 3 tiles); prefill logits and the cross-KV within
    ``tests/test_torch_families.py``'s tolerances."""
    arch = "seamless_m4t_medium"
    jcfg, tcfg = (dataclasses.replace(c, frontend=dataclasses.replace(
        c.frontend, n_tokens=40)) for c in (get_smoke_config(arch,
                                                             n_units=2),
                                            t_smoke(arch, n_units=2)))
    cfg, api, base, tapi_m, tbase = _model(arch, jcfg, tcfg)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    frames = rng.normal(0, 1, (2, 40, cfg.frontend.embed_dim)).astype(
        np.float32)
    jl, jc = api.prefill(base, {"tokens": jnp.asarray(toks),
                                "frames": jnp.asarray(frames)}, RT16, 32)
    with torch.no_grad():
        tl, tc = tapi_m.prefill(tbase, {"tokens": torch.from_numpy(toks),
                                        "frames": torch.from_numpy(frames)},
                                32)
    tol = dict(rtol=1e-4, atol=5e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["cross"][k].numpy(),
                                   np.asarray(jc["cross"][k]), **tol)
