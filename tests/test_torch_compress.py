"""Algorithm 1 in the port vs the JAX package, on a qwen2.5-3b smoke tree:
the same numpy task vector through both ``compress_packed``s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.configs import get_smoke_config
from repro.core.compeft import CompressionConfig as JConfig
from repro.core.compeft import compress_packed as j_compress_packed
from repro.models import build
from repro_torch import api as tapi
from repro_torch import tree as tree_util
from repro_torch.convert import packed_from_jax, params_from_jax
from repro_torch.core.compeft import CompressionConfig, compress_packed
from repro_torch.expert import DENSE, PACKED


def _is_pt(x):
    return hasattr(x, "pos")


@pytest.fixture(scope="module")
def tau_np():
    cfg = get_smoke_config("qwen2_5_3b", n_units=1)
    base = build(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda l: rng.standard_t(4, l.shape).astype(np.float32) * 0.01, base)


def _flat_jax(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_pt)
    return {"/".join(str(k.key) for k in p): l for p, l in flat}


@pytest.mark.parametrize("per_tensor", [True, False])
@pytest.mark.parametrize("density", [0.1, 0.3])
def test_planes_bitwise_equal_to_reference(tau_np, per_tensor, density):
    """Planes bitwise equal to ``repro.core.compeft.compress_packed``;
    scales within rtol 1e-5 (the reference's host path sums the moments in
    f64, the port in f32)."""
    want = _flat_jax(j_compress_packed(
        jax.tree_util.tree_map(jnp.asarray, tau_np),
        JConfig(density=density, per_tensor=per_tensor)))
    got = dict(tree_util.flatten_with_paths(compress_packed(
        params_from_jax(tau_np, device="cpu"),
        CompressionConfig(density=density, per_tensor=per_tensor))))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        np.testing.assert_array_equal(g.pos.numpy(),
                                      np.asarray(w.pos).view(np.int32), path)
        np.testing.assert_array_equal(g.neg.numpy(),
                                      np.asarray(w.neg).view(np.int32), path)
        assert g.shape == tuple(w.shape)
        np.testing.assert_allclose(float(g.scale), float(w.scale),
                                   rtol=1e-5, err_msg=path)


def test_expert_facade_matches_reference(tau_np):
    """``api.compress(...).as_(PACKED)`` == the reference expert's planes,
    and the DENSE reconstruction is signs * scale of those planes."""
    jex = rapi.compress(jax.tree_util.tree_map(jnp.asarray, tau_np),
                        name="x", density=0.2)
    tex = tapi.compress(params_from_jax(tau_np, device="cpu"), name="x",
                        density=0.2, device="cpu")
    want = packed_from_jax(jex.as_path_dict(rapi.PACKED), device="cpu")
    got = tex.as_path_dict(PACKED)
    for path, w in want.items():
        assert torch.equal(got[path].pos, w.pos), path
        assert torch.equal(got[path].neg, w.neg), path
    tex.drop(DENSE)
    recon = tex.as_path_dict(DENSE)
    jrecon = _flat_jax(jex.to_dense_tau())
    for path, w in jrecon.items():
        np.testing.assert_allclose(recon[path].numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-8)
    assert tex.nbytes(PACKED) == jex.nbytes(rapi.PACKED)


def test_compress_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.compress({"w": torch.zeros(64)}, density=0.1)


def test_dropped_task_vector_is_freed_without_the_cyclic_collector():
    """With Python's cyclic collector off, a task vector dropped after its
    compression (and the tree walks over it) is freed at once: no
    reference cycle holds its leaves, which on the card are gigabytes."""
    import gc
    import weakref
    g = torch.Generator().manual_seed(3)
    tau = {"a": {"w": torch.randn(64, 96, generator=g)},
           "b": torch.randn(300, generator=g)}
    ex = tapi.compress(tau, density=0.1, device="cpu")
    refs = [weakref.ref(leaf) for leaf in tree_util.leaves(tau)]
    assert len(tree_util.flatten_with_paths(tau)) == 2
    rebuilt = tree_util.unflatten_like(tau, tree_util.leaves(tau))
    gc.disable()
    try:
        ex.as_(PACKED)
        del tau, rebuilt
        ex.drop(DENSE)
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()
