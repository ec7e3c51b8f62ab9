"""The port's compression baselines (``repro_torch/core/baselines.py``)
against ``repro/core/baselines.py`` on the same numpy-seeded task vectors:
pruned bitwise (elementwise after a shared threshold); STC, BitDelta and
ComPEFT dense with the same survivors and signs and their scales (a sum
in another order) within 4 f32 ulps; DARE's masks bitwise under the same
key; and
``method_bits`` equal for every method; plus the reference's own checks
(``tests/test_ternary_merge_baselines.py``) on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro_torch import prng
from repro_torch.core import baselines as tb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _taus(seed=0):
    rng = np.random.default_rng(seed)
    tau = {"blocks": {"w": rng.normal(0, 0.02, (3, 64, 48)),
                      "b": rng.normal(0, 0.02, (3, 48))},
           "embed": rng.standard_t(3, (200, 32)) * 0.01,
           "tiny": rng.normal(0, 1, (5,))}
    tau = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tau)
    jt = jax.tree_util.tree_map(jnp.asarray, tau)
    tt = jax.tree_util.tree_map(torch.from_numpy, tau)
    return jt, tt


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(l)
            for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    from repro_torch import tree as tu
    return {p: l.numpy() for p, l in tu.flatten_with_paths(tree)}


@pytest.mark.parametrize("method", ["pruned", "bitdelta", "compeft"])
@pytest.mark.parametrize("density", [0.05, 0.2, 0.5])
def test_elementwise_methods_equal_reference(method, density):
    """Pruned bitwise; BitDelta's mean |tau| and ComPEFT's std are sums in
    another order: the same signs, values within 4 f32 ulps."""
    jt, tt = _taus(1)
    want = _flat(jb.run_method(method, jt, density, alpha=1.5))
    got = _tflat(tb.run_method(method, tt, density, alpha=1.5))
    assert sorted(want) == sorted(got)
    for k in want:
        if method == "pruned":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_array_equal(np.sign(got[k]), np.sign(want[k]),
                                          err_msg=k)
            np.testing.assert_allclose(got[k], want[k], rtol=5e-7, atol=0,
                                       err_msg=k)


@pytest.mark.parametrize("density", [0.05, 0.2, 0.5])
def test_stc_equals_reference(density):
    """The same survivors and signs (a shared threshold); the scale, a
    sum over survivors, within 4 f32 ulps (a relative 5e-7)."""
    jt, tt = _taus(2)
    want = _flat(jb.stc(jt, density))
    got = _tflat(tb.stc(tt, density))
    for k in want:
        np.testing.assert_array_equal(np.sign(got[k]), np.sign(want[k]),
                                      err_msg=k)
        np.testing.assert_allclose(got[k], want[k], rtol=5e-7, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("seed,density", [(0, 0.5), (3, 0.1), (7, 0.9)])
def test_dare_masks_and_values_bitwise(seed, density):
    jt, tt = _taus(seed)
    want = _flat(jb.dare(jt, density, jax.random.PRNGKey(seed)))
    got = _tflat(tb.dare(tt, density, prng.prng_key(seed)))
    for k in want:
        np.testing.assert_array_equal(got[k] != 0, want[k] != 0, err_msg=k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_dare_default_key_is_the_reference_default():
    jt, tt = _taus(4)
    want = _flat(jb.run_method("dare", jt, 0.3))
    got = _tflat(tb.run_method("dare", tt, 0.3))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("method", list(jb.METHODS))
@pytest.mark.parametrize("n,density", [(1000, 0.2), (10_000, 0.1),
                                       (7_000_000, 0.01), (50, 0.9)])
def test_method_bits_equal(method, n, density):
    assert tb.method_bits(method, n, density) == jb.method_bits(
        method, n, density)


def test_methods_and_errors():
    assert tb.METHODS == jb.METHODS
    with pytest.raises(ValueError, match="unknown method"):
        tb.run_method("nope", {}, 0.1)
    with pytest.raises(ValueError):
        tb.method_bits("nope", 10, 0.1)


def test_reference_checks_hold_on_the_port():
    """``tests/test_ternary_merge_baselines.py``'s baseline cases."""
    p = tb.pruned({"w": torch.tensor([0.1, -5.0, 0.01, 3.0])}, 0.5)
    np.testing.assert_allclose(p["w"].numpy(), [0.0, -5.0, 0.0, 3.0])
    s = tb.stc({"w": torch.tensor([0.1, -4.0, 0.01, 2.0])}, 0.5)
    np.testing.assert_allclose(s["w"].numpy(), [0.0, -3.0, 0.0, 3.0],
                               atol=1e-6)
    b = tb.bitdelta({"w": torch.tensor([0.5, -1.5])})
    np.testing.assert_allclose(b["w"].numpy(), [1.0, -1.0])
    w = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (20_000,))
                         .astype(np.float32))
    d = tb.dare({"w": w}, 0.5, prng.prng_key(0))
    assert float((d["w"] - w).mean()) == pytest.approx(0.0, abs=0.02)
    assert (tb.method_bits("compeft", 10_000, 0.1)
            < tb.method_bits("pruned", 10_000, 0.1))


def test_bf16_leaves_keep_their_dtype():
    rng = np.random.default_rng(5)
    a = rng.normal(0, 0.02, (16, 32)).astype(np.float32)
    t = {"w": torch.from_numpy(a).to(torch.bfloat16)}
    j = {"w": jnp.asarray(a).astype(jnp.bfloat16)}
    for m in jb.METHODS:
        got = tb.run_method(m, t, 0.25)["w"]
        want = jb.run_method(m, j, 0.25)["w"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-2, atol=1e-6, err_msg=m)
