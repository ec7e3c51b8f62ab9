"""Sampled decoding in the port against the JAX package: the threefry
words, keys and bits bitwise ``jax.random``'s, the gumbel noise within 2
f32 ulps, ``select_tokens`` equal to the reference's, the port's engine
sampling the reference engine's token streams (qwen2.5-3b smoke config,
f32, slot refill, every chunk size, mixed and merge-on-swap), and the
reference's own invariants from ``tests/test_decode_loop.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.configs import get_smoke_config
from repro.models import Runtime, build
from repro.serve import Request as JRequest
from repro.serve import SamplingConfig as JSamplingConfig
from repro.serve.decode_loop import row_keys as j_row_keys
from repro.serve.decode_loop import select_tokens as j_select_tokens
from repro_torch import api as tapi
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.kernels.sample import (sample_gumbel_argmax, sample_tokens,
                                        scale_and_mask)
from repro_torch.models import build as t_build
from repro_torch.serve import BASE, Request, SamplingConfig
from repro_torch.serve import sampling
from repro_torch.serve.decode_loop import select_tokens

RT = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")
SEEDS = [0, 1, 2 ** 31 - 1]
UIDS = [0, 1, 7, 2014, 123456, 2 ** 31, 2 ** 32 - 1]
GENS = [0, 1, 5, 31, 2 ** 20, 2 ** 31 - 1, 2 ** 31]


@pytest.fixture
def one_thread():
    """Run the vocabulary-sized comparisons on torch's calling thread.
    In a process that has run XLA computations, one of torch's OpenMP
    workers was seen to return a wrong chunk from a large vectorised
    ``torch.log`` (in 8 of 72 fresh processes on this CPU; a second call
    was right); on one thread it was not seen in 72."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def _step_keys(seed):
    """The reference's step keys fold_in(fold_in(PRNGKey(seed), uid), gen)
    over UIDS x GENS, and the port's."""
    jk = jax.vmap(lambda k: jax.vmap(
        lambda g: jax.random.fold_in(k, g))(jnp.asarray(GENS, jnp.uint32)))(
        j_row_keys(seed, UIDS))
    tk = sampling.fold_in(sampling.row_keys(seed, UIDS)[:, None],
                          torch.tensor(GENS)[None])
    return jk, tk


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_equal_jax_random(seed):
    """Bitwise: PRNGKey, row keys, fold_in at every gen, the raw threefry
    words of a key's counters and 32-bit draws of two shapes."""
    assert sampling.threefry_seed(seed) == tuple(
        int(w) for w in np.asarray(jax.random.PRNGKey(seed)))
    np.testing.assert_array_equal(sampling.row_keys(seed, UIDS).numpy(),
                                  _words(j_row_keys(seed, UIDS)))
    jk, tk = _step_keys(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    from jax._src.prng import threefry_2x32 as j_threefry
    key = jk[3, 4]
    counts = np.arange(64, dtype=np.uint32)
    want = _words(j_threefry(key, jnp.asarray(counts)))
    words = torch.from_numpy(counts.astype(np.int64))
    y0, y1 = sampling.threefry_2x32(int(key[0]), int(key[1]), words[:32],
                                    words[32:])
    np.testing.assert_array_equal(torch.cat([y0, y1]).numpy(), want)
    for V in (1, 1000):
        np.testing.assert_array_equal(
            sampling.random_bits(tk[3, 4], V).numpy(),
            _words(jax.random.bits(key, (V,))))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_two_ulps_of_jax(seed, one_thread):
    """The uniform draws are bitwise; the noise is -log(-log(u)) and the
    two libraries' f32 logs may round apart by an ulp each, so the noise
    stays within 2 ulps of max(|g|, 1) (near g = 0 the inner log's ulp
    sets the error)."""
    jk, tk = _step_keys(seed)
    V = 151936
    for i, j in ((0, 0), (4, 6), (6, 2)):
        key = jk[i, j]
        u = sampling.uniform(sampling.random_bits(tk[i, j], V)).numpy()
        np.testing.assert_array_equal(u, np.asarray(jax.random.uniform(
            key, (V,), minval=np.finfo(np.float32).tiny)))
        want = np.asarray(jax.random.gumbel(key, (V,)))
        got = sampling.gumbel(tk[i, j], V).numpy()
        ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
        assert float((np.abs(got - want) / ulp).max()) <= 2.0


@pytest.mark.parametrize("V", [512, 151936])
@pytest.mark.parametrize("top_k", [0, 1, 5])
@pytest.mark.parametrize("temperature", [0.5, 1.0])
def test_select_tokens_equal_reference(V, top_k, temperature, one_thread):
    rng = np.random.default_rng(V + top_k)
    logits = (3.0 * rng.normal(size=(4, V))).astype(np.float32)
    uids, gens = [3, 2014, 2 ** 31, 77], [0, 1, 9, 2 ** 31 - 1]
    jcfg = JSamplingConfig(temperature=temperature, top_k=top_k, seed=11)
    tcfg = SamplingConfig(temperature=temperature, top_k=top_k, seed=11)
    want = np.asarray(j_select_tokens(
        jnp.asarray(logits), j_row_keys(11, uids),
        jnp.asarray(gens, jnp.uint32), jcfg))
    got = select_tokens(torch.from_numpy(logits),
                        sampling.row_keys(11, uids), torch.tensor(gens),
                        tcfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if top_k:
        top = np.argsort(-logits, axis=-1)[:, :top_k]
        assert all(int(t) in top[b] for b, t in enumerate(got))


def _tied_logits(V, seed):
    """bf16-rounded logits [6, V] from a seed: rows 0-3 on a grid of 0.25,
    so the k-th value repeats many times; row 4 holds 10 values of 2.0,
    20 of +0.0 and 20 of -0.0 over negatives, so the 11th to 50th largest
    are zeros of both signs; row 5 is row 4 reversed."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=(6, V)) * 12.0) / 4.0
    x[4] = -1.0 - rng.random(V)
    x[4, :10], x[4, 10:30], x[4, 30:50] = 2.0, 0.0, -0.0
    x[5] = x[4, ::-1]
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("V", [512, 32000])
@pytest.mark.parametrize("top_k", [1, 40, "V-1", "V"])
def test_sample_tokens_tied_thresholds_equal_reference(V, top_k, one_thread):
    """The plain ``sample_tokens`` on bf16 logits whose k-th value is tied
    (and is -0.0 or +0.0 with both zeros at the boundary): tokens equal
    the reference's ``select_tokens``, and every value equal to the
    threshold survives the mask, as the radix select must keep."""
    k = {"V-1": V - 1, "V": V}.get(top_k, top_k)
    logits = _tied_logits(V, seed=V + 7)
    scaled_ref = logits.to(torch.float32).numpy()
    uids, gens = [3, 2014, 2 ** 31, 77, 5, 2 ** 32 - 1], [0, 1, 9, 2 ** 31 - 1,
                                                         4, 2 ** 31]
    jlogits = jnp.asarray(logits.to(torch.float32).numpy(), jnp.bfloat16)
    for T in (0.7, 1.0):
        jcfg = JSamplingConfig(temperature=T, top_k=k, seed=5)
        want = np.asarray(j_select_tokens(jlogits, j_row_keys(5, uids),
                                          jnp.asarray(gens, jnp.uint32),
                                          jcfg))
        got = sample_tokens(logits, sampling.row_keys(5, uids),
                            torch.tensor(gens), T, k)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        scaled = scaled_ref / np.float32(T)
        masked = scale_and_mask(logits, T, k).numpy()
        if k < V:
            kth = -np.sort(-scaled, axis=-1)[:, k - 1:k]
            keep = scaled >= kth           # as floats: -0.0 == +0.0
            assert (keep.sum(-1) >= k).all()
        else:
            keep = np.ones_like(scaled, dtype=bool)
        np.testing.assert_array_equal(np.isfinite(masked), keep)
        np.testing.assert_array_equal(masked[keep], scaled[keep])
    if k == 40:      # the 11th-50th largest of rows 4 and 5 are zeros
        assert np.isfinite(scale_and_mask(logits, 1.0, 40)[4:].numpy()).sum(
            -1).tolist() == [50, 50]


def test_sampler_edge_rows():
    """-inf stays -inf (a masked value is never drawn), a row of all -inf
    gives index 0 as argmax does, and the CPU wrapper is the plain
    version, noise included."""
    keys = sampling.row_keys(0, [1, 2])
    gen = torch.tensor([0, 3])
    x = torch.full((2, 64), float("-inf"))
    x[0, 17] = -5.0
    tok, g = sample_gumbel_argmax(x, keys, gen, noise=True)
    assert tok.tolist() == [17, 0]
    assert torch.equal(g, sampling.gumbel(sampling.fold_in(keys, gen), 64))
    assert bool(torch.isfinite(g).all())


# ---------------------------------------------------------------------------
# The engine, sampled, against the reference engine
# ---------------------------------------------------------------------------

SAMPLED = dict(temperature=0.8, top_k=5, seed=7)
NAMES = ["e0", "e1", BASE, "e2", "e0", "e1", "e2"]


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("qwen2_5_3b", n_units=1)
    api = build(cfg)
    base = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(21)
    taus = [jax.tree_util.tree_map(
        lambda l: (0.03 * rng.normal(size=l.shape)).astype(np.float32), base)
        for _ in range(3)]
    jreg = rapi.registry(experts=[
        rapi.compress(jax.tree_util.tree_map(jnp.asarray, t), name=f"e{i}",
                      density=0.2) for i, t in enumerate(taus)])
    treg = tapi.registry(device="cpu", experts=[
        tapi.compress(params_from_jax(t, device="cpu"), name=f"e{i}",
                      density=0.2, device="cpu") for i, t in enumerate(taus)])
    tbase = params_from_jax(jax.tree_util.tree_map(np.asarray, base),
                            device="cpu")
    model = t_build(t_smoke("qwen2_5_3b", n_units=1))
    return cfg, api, base, jreg, model, tbase, treg


def _traffic(cfg, seed=0):
    """(expert, prompt, budget): prompts of 6-10 tokens, budgets of 2-5,
    more requests than slots (as ``tests/test_decode_loop.py``)."""
    rng = np.random.default_rng(seed)
    return [(n, rng.integers(1, cfg.vocab, 6 + 2 * (i % 3)), 2 + i % 4)
            for i, n in enumerate(NAMES)]


def _tserve(setup, traffic, uid0=10, **kw):
    _, _, _, _, model, tbase, treg = setup
    reqs = [Request(uid=uid0 + i, expert=n, prompt=p, max_new_tokens=b)
            for i, (n, p, b) in enumerate(traffic)]
    eng = tapi.serve(model, tbase, treg, **kw)
    eng.run(reqs)
    return {r.uid: r.out_tokens for r in reqs}, eng


@pytest.mark.parametrize("scheduling,chunk,top_k", [
    ("mixed", 0, 5), ("mixed", 1, 5), ("mixed", 4, 5), ("mixed", 16, 5),
    ("mixed", 4, 0), ("grouped", 0, 5), ("grouped", 4, 5)])
def test_sampled_streams_equal_reference_engine(setup, scheduling, chunk,
                                                top_k):
    """f32, slot refill (``continuous=True``), 7 requests over 3 slots:
    every sampled stream is the reference engine's, token for token."""
    cfg, api, base, jreg = setup[:4]
    kw = dict(max_batch=3, cache_len=64, decode_chunk=chunk,
              scheduling=scheduling, **dict(SAMPLED, top_k=top_k))
    traffic = _traffic(cfg)
    jr = [JRequest(uid=10 + i, expert=n, prompt=jnp.asarray(p, jnp.int32),
                   max_new_tokens=b) for i, (n, p, b) in enumerate(traffic)]
    jeng = rapi.serve(api, RT, base, jreg, **kw)
    jeng.run(jr)
    got, eng = _tserve(setup, traffic, **kw)
    assert got == {r.uid: list(r.out_tokens) for r in jr}
    if scheduling == "mixed":
        assert eng.swap_summary()["admitted"] == \
            jeng.swap_summary()["admitted"] >= 1


def test_sampled_streams_do_not_depend_on_chunk_or_admission(setup):
    """The reference's invariants (``tests/test_decode_loop.py``): the same
    streams for every chunk size and the eager loop, repeatable, another
    seed gives another stream; and each request, admitted mid-wave or
    not, draws the stream it draws served alone."""
    cfg = setup[0]
    kw = dict(max_batch=3, cache_len=64, **SAMPLED)
    runs = {k: _tserve(setup, _traffic(cfg, seed=4), decode_chunk=k,
                       **kw)[0] for k in (0, 2, 8)}
    assert runs[0] == runs[2] == runs[8]
    assert _tserve(setup, _traffic(cfg, seed=4), decode_chunk=2,
                   **kw)[0] == runs[2]
    other = _tserve(setup, _traffic(cfg, seed=4), decode_chunk=2,
                    **dict(kw, seed=8))[0]
    assert other != runs[2]
    assert all(0 <= t < cfg.vocab for s in runs[2].values() for t in s)
    for uid, (n, p, b) in enumerate(_traffic(cfg, seed=4), start=10):
        solo, _ = _tserve(setup, [(n, p, b)], uid0=uid, max_batch=1,
                          cache_len=64, continuous=False, decode_chunk=4,
                          **SAMPLED)
        assert solo[uid] == runs[8][uid], uid


def test_top_k_samples_stay_in_top_k():
    """Mirror of ``tests/test_decode_loop.py``: every draw at top_k = 4
    lies among its row's 4 largest logits, at every stream position."""
    logits = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (8, 64)).astype(np.float32))
    keys = sampling.row_keys(3, list(range(8)))
    scfg = SamplingConfig(temperature=1.5, top_k=4, seed=3)
    top = torch.argsort(logits, dim=-1, descending=True)[:, :4]
    for g in range(5):
        got = select_tokens(logits, keys, torch.full((8,), g), scfg)
        assert all(int(t) in top[b].tolist() for b, t in enumerate(got))
