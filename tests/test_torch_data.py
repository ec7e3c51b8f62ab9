"""The port's PRNG draws and synthetic data pipeline against the JAX
package: ``repro_torch.prng``'s keys, splits, uniform, randint and
bernoulli draws bitwise ``jax.random``'s, and ``make_batch_for`` batches
bitwise the reference's for tasks 0, 1 and the mixture task 100 at
several steps (tolerance: none, every comparison is exact), and the
frontend families' stub inputs from ``prng.normal`` (within a relative
1e-5)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.data import pipeline as jpipe
from repro_torch import prng
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.data import pipeline as tpipe

SEEDS = [0, 1, 9001, 2 ** 31 - 1, 2 ** 32 - 1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from torch's thread pool, and six
    test workers each spinning a pool of every core's threads slow each
    other several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key_words(k) -> list:
    return np.asarray(k).astype(np.int64).tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_splits_and_fold_in_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert _key_words(jk) == tk.tolist()
    for num in (1, 2, 3, 64):
        assert _key_words(jax.random.split(jk, num)) == \
            prng.split(tk, num).tolist()
    for data in (0, 1, 77, 2 ** 31, 2 ** 32 - 1):
        assert _key_words(jax.random.fold_in(jk, data)) == \
            prng.fold_in(tk, data).tolist()
    # a batch of keys splits and folds row by row
    keys = jax.random.split(jk, 5)
    want = np.stack([np.asarray(jax.random.split(k, 3)) for k in keys])
    assert want.astype(np.int64).tolist() == \
        prng.split(prng.split(tk, 5), 3).tolist()


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_randint_bernoulli_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (4099,))),
        prng.uniform(prng.random_bits(tk, 4099)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (257,), minval=-2.0, maxval=3.0)),
        prng.uniform(prng.random_bits(tk, 257), -2.0, 3.0).numpy())
    # spans below, at and above 2**16 (the multiplier wraps in uint32),
    # a power of two, an empty span and a negative minval
    for lo, hi in ((0, 64), (0, 7), (0, 65536), (0, 100_000), (0, 3 ** 19),
                   (0, 2 ** 31 - 1), (5, 5), (-5, 50)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(jk, (513,), lo, hi)),
            prng.randint(tk, 513, lo, hi).numpy())
    for p in (0.0, 0.1, 0.5, 0.999):
        np.testing.assert_array_equal(
            np.asarray(jax.random.bernoulli(jk, p, (1000,))),
            prng.bernoulli(tk, p, 1000).numpy())


def test_sampling_uses_the_one_generator():
    """serve/sampling.py draws through repro_torch.prng (one copy of the
    threefry code)."""
    from repro_torch.serve import sampling
    assert sampling.threefry_2x32 is prng.threefry_2x32
    assert sampling.fold_in is prng.fold_in
    assert sampling.random_bits is prng.random_bits


@pytest.mark.parametrize("task", [0, 1, 2, 3, 7, 100])
def test_chain_params_equal(task):
    a, c, perm = jpipe._chain_params(task, 64)
    ta, tc, tperm = tpipe._chain_params(task, 64)
    assert (a, c) == (ta, tc)
    np.testing.assert_array_equal(np.asarray(perm), tperm.numpy())


@pytest.mark.parametrize("task,step", [(0, 0), (0, 17), (1, 0), (1, 5),
                                       (1, 10_000), (100, 0), (100, 3)])
def test_batches_bitwise(task, step):
    cfg = get_smoke_config("qwen2_5_3b")
    tcfg = t_smoke("qwen2_5_3b")
    want = jpipe.make_batch_for(cfg, step, 48, 9, task)
    got = tpipe.make_batch_for(tcfg, step, 48, 9, task, device="cpu")
    for k in ("tokens", "targets"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy())


@pytest.mark.parametrize("vocab,latent,noise", [(1000, 64, 0.1),
                                                (50, 8, 0.5),
                                                (151936, 64, 0.0)])
def test_sample_tokens_bitwise_other_configs(vocab, latent, noise):
    dcfg = jpipe.DataConfig(vocab=vocab, seq_len=20, global_batch=6,
                            task_id=2, latent_vocab=latent, noise=noise)
    tdcfg = tpipe.DataConfig(**dataclasses.asdict(dcfg))
    key = jax.random.PRNGKey(3)
    np.testing.assert_array_equal(
        np.asarray(jpipe.sample_tokens(key, dcfg)),
        tpipe.sample_tokens(prng.prng_key(3), tdcfg).numpy())


def test_batches_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.make_batch_for(t_smoke("qwen2_5_3b"), 0, 8, 2)


@pytest.mark.parametrize("arch,key", [("internvl2_1b", "mm_embeds"),
                                      ("seamless_m4t_medium", "frames")])
def test_frontend_batches_name_their_item(arch, key):
    """Frontend batches, once refused naming ROADMAP queue 1, item 12, now
    come as the reference's: ``seq_len - n_tokens`` text tokens bitwise,
    and the stub modality input (``mm_embeds`` for vision, ``frames`` for
    audio) [B, n_tokens, embed_dim] f32 from the same threefry bits, its
    uniforms bitwise and its normals within a relative 1e-5 (torch's
    erfinv and XLA's round apart: ``repro_torch/prng.py``)."""
    cfg, tcfg = get_smoke_config(arch), t_smoke(arch)
    for task, step in ((0, 0), (1, 7)):
        want = jpipe.make_batch_for(cfg, step, 32, 3, task)
        got = tpipe.make_batch_for(tcfg, step, 32, 3, task, device="cpu")
        assert sorted(got) == sorted(want) == sorted(["tokens", "targets",
                                                      key])
        for k in ("tokens", "targets"):
            assert tuple(got[k].shape) == (3, 32 - cfg.frontend.n_tokens)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-7)
    # a sequence shorter than the prefix keeps one text token
    assert tpipe.make_batch_for(tcfg, 0, 4, 2, device="cpu")[
        "tokens"].shape == (2, 1)


@pytest.mark.parametrize("shape", [(7,), (3, 5, 11), (2, 1024)])
def test_normal_draws_match_reference(shape):
    """``prng.normal``: the uniforms under it bitwise ``jax.random``'s, the
    normals within a relative 1e-5 and an absolute 1e-7 (XLA's erf_inv is
    up to 73 f32 ulps from the true value near zero, torch's within 1.5)."""
    key = jax.random.fold_in(jax.random.PRNGKey(77), 3)
    tkey = prng.fold_in(prng.prng_key(77), 3)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    n = int(np.prod(shape))
    np.testing.assert_array_equal(
        prng.uniform(prng.random_bits(tkey, n), lo, 1.0).numpy(),
        np.asarray(jax.random.uniform(key, (n,), minval=lo, maxval=1.0)))
    got = prng.normal(tkey, shape)
    assert tuple(got.shape) == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax.random.normal(key, shape)),
                               rtol=1e-5, atol=1e-7)
