"""The port's ternary algebra and merging against the JAX package's:
``core/ternary_ops.py``, ``core/merging.py``, ``api.merge`` and the alpha
tools of ``core/compeft.py``, on the same numpy inputs.

Tolerances: integer results (dots, popcounts, distances, signs) are
exact.  The merges (Task Arithmetic, TIES, the packed merge, LoRA
composition) and ``decompress``, ``apply_compressed`` and ``rescale`` sum
in f32 in the same order in both packages and are compared bitwise.  So is
the similarity matrix.  The other float results (scaled dots, cosines,
agreement fractions, the packed matvec) are held within 1e-6 relative,
each with its reason beside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.core import compeft as jcompeft
from repro.core import merging as jmerging
from repro.core import ternary_ops as jops
from repro.core.compeft import CompressedTensor as JCT
from repro.core.packing import pack_ternary as j_pack_ternary
from repro.core.packing import pack_tree as j_pack_tree
from repro.expert import _flatten as j_flat
from repro_torch import api as tapi
from repro_torch import tree as tree_util
from repro_torch.convert import packed_from_jax, params_from_jax
from repro_torch.core import compeft, merging, ternary_ops
from repro_torch.expert import Expert
from repro_torch.kernels import ops

RTOL = 1e-6


def _pair(n, seed, density=0.4):
    """Two random ternary vectors as (reference, port) PackedTernary."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(2):
        signs = np.where(rng.random(n) < density, rng.choice([-1, 1], n),
                         0).astype(np.int8)
        scale = np.float32(rng.uniform(0.01, 2.0))
        jp = j_pack_ternary(JCT(signs=jnp.asarray(signs),
                                scale=jnp.float32(scale)))
        out.append((jp, packed_from_jax(jp, device="cpu")))
    return out


SIZES = [(1, 0), (31, 1), (32, 2), (33, 3), (257, 4), (4100, 5)]


@pytest.mark.parametrize("n,seed", SIZES)
def test_integer_ternary_ops_exact(n, seed):
    (ja, ta), (jb, tb) = _pair(n, seed)
    assert float(ternary_ops.ternary_dot(ta, tb)) == float(
        jops.ternary_dot(ja, jb))
    assert ternary_ops.ternary_dot(ta, tb).dtype == torch.float32
    assert int(ternary_ops.hamming_distance(ta, tb)) == int(
        jops.hamming_distance(ja, jb))
    assert int(ternary_ops.nnz(ta)) == int(jops.nnz(ja))
    add, jadd = ternary_ops.ternary_add(ta, tb), jops.ternary_add(ja, jb)
    np.testing.assert_array_equal(add.signs.numpy(), np.asarray(jadd.signs))
    assert float(add.scale) == float(jadd.scale)
    # the popcount dot of a vector with itself is its nnz
    assert float(ternary_ops.ternary_dot(ta, ta)) == int(ternary_ops.nnz(ta))


@pytest.mark.parametrize("n,seed", SIZES)
def test_float_ternary_ops_within_1e6(n, seed):
    """f32 products and quotients of exact integers: equal up to
    rounding, held within 1e-6 relative."""
    (ja, ta), (jb, tb) = _pair(n, seed)
    for fn in ("scaled_dot", "cosine_similarity", "sign_agreement"):
        got = float(getattr(ternary_ops, fn)(ta, tb))
        want = float(getattr(jops, fn)(ja, jb))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12,
                                   err_msg=fn)
    np.testing.assert_allclose(float(ops.expert_dot(ta, tb)),
                               float(jops.scaled_dot(ja, jb)), rtol=RTOL)


def test_packed_matvec_within_1e6():
    """A [24, 40] leaf times a vector: f32 matmuls sum in other orders."""
    rng = np.random.default_rng(5)
    signs = rng.integers(-1, 2, (24, 40)).astype(np.int8)
    jp = j_pack_ternary(JCT(signs=jnp.asarray(signs),
                            scale=jnp.float32(0.25)))
    tp = packed_from_jax(jp, device="cpu")
    x = rng.normal(0, 1, (40,)).astype(np.float32)
    np.testing.assert_allclose(
        ternary_ops.packed_matvec(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jops.packed_matvec(jp, jnp.asarray(x))), rtol=RTOL,
        atol=1e-6)


# ------------------------------------------------------------------ merging


def _taus(n_tasks=3, seed=11, shapes=((32, 16), (48,), (3, 5, 7))):
    rng = np.random.default_rng(seed)
    return [{f"w{i}": rng.normal(0, 0.02, s).astype(np.float32)
             for i, s in enumerate(shapes)} for _ in range(n_tasks)]


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _bits_equal(got: dict, want: dict):
    want = j_flat(want)
    got = dict(tree_util.flatten_with_paths(got))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path].to(torch.float32).numpy()
        np.testing.assert_array_equal(g.view(np.int32), np.asarray(
            w, np.float32).view(np.int32), path)


@pytest.mark.parametrize("lam", [1.0, 0.7])
def test_task_arithmetic_bitwise(lam):
    taus = _taus()
    _bits_equal(merging.task_arithmetic([params_from_jax(t, device="cpu")
                                         for t in taus], lam=lam),
                jmerging.task_arithmetic([_j(t) for t in taus], lam=lam))


def _packed_pairs(density=0.3):
    jp = [j_pack_tree(jcompeft.compress(_j(t), jcompeft.CompressionConfig(
        density=density))) for t in _taus()]
    return jp, [packed_from_jax(p, device="cpu") for p in jp]


@pytest.mark.parametrize("lam", [1.0, 0.7])
def test_merge_packed_bitwise(lam):
    jp, tp = _packed_pairs()
    _bits_equal(merging.merge_packed(tp, lam=lam),
                jmerging.merge_packed(jp, lam=lam))


@pytest.mark.parametrize("density", [0.2, 0.5, 1.0])
def test_ties_merge_bitwise(density):
    """Bitwise: the trim is the exact quantile (bitwise, see
    test_torch_artifacts.py), and XLA sums the three-task stack in index
    order here, as torch does."""
    taus = _taus()
    _bits_equal(merging.ties_merge([params_from_jax(t, device="cpu")
                                    for t in taus], density=density, lam=0.9),
                jmerging.ties_merge([_j(t) for t in taus], density=density,
                                    lam=0.9))


def test_merge_experts_dispatch_matches_reference():
    """api.merge over Experts, bitwise for every method (f32 sums in one
    order over the same planes); auto picks packed for packed-resident
    experts."""
    taus = _taus()
    jex = [rapi.compress(_j(t), name=f"e{i}", density=0.3)
           for i, t in enumerate(taus)]
    tex = [Expert.from_packed(e.name, e.kind, packed_from_jax(
        e.as_(rapi.PACKED), device="cpu"), density=0.3) for e in jex]
    for method in ("task_arithmetic", "packed", "auto"):
        _bits_equal(tapi.merge(tex, method=method, lam=0.7),
                    rapi.merge(jex, method=method, lam=0.7))
    _bits_equal(tapi.merge(tex, method="ties", density=0.5),
                rapi.merge(jex, method="ties", density=0.5))
    # packed == task arithmetic over the reconstructions, bitwise
    _bits_equal(tapi.merge(tex, method="packed"),
                jmerging.task_arithmetic([e.to_dense_tau() for e in jex]))
    merged = tapi.merge(tex, method="packed", as_expert=True, name="m",
                        device="cpu")
    assert merged.name == "m" and merged.density == 0.2
    with pytest.raises(ValueError, match="merge method"):
        tapi.merge(tex, method="average")


def test_pairwise_similarity_matrix_equal():
    jp, tp = _packed_pairs()
    """Each leaf's cosine is the same f32 sqrt, product and quotient of
    exact integers in both packages, and the mean is numpy's: equal."""
    got = merging.pairwise_similarity_matrix(tp)
    want = jmerging.pairwise_similarity_matrix(jp)
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diag(got) == 1.0)


def test_compose_lora_bitwise():
    """Weighted sums over the stacked task axis, summed in index order by
    both packages on these inputs."""
    mods = _taus(4)
    w = np.asarray([0.5, 0.25, -0.25, 0.125], np.float32)
    _bits_equal(merging.compose_lora([params_from_jax(m, device="cpu")
                                      for m in mods], w),
                jmerging.compose_lora([_j(m) for m in mods],
                                      jnp.asarray(w)))


def test_lorahub_search_same_weights():
    """The same numpy generator and a loss read back to numpy: the search
    visits the same candidates and returns the same weights."""
    mods = _taus(3)
    target = mods[0]["w0"] * 0.8 - mods[2]["w0"] * 0.3

    def loss(composed):
        return float(np.sum((np.asarray(composed["w0"]) - target) ** 2))

    w, best = merging.lorahub_search([params_from_jax(m, device="cpu")
                                      for m in mods], loss, n_iters=60,
                                     seed=3)
    jw, jbest = jmerging.lorahub_search([_j(m) for m in mods], loss,
                                        n_iters=60, seed=3)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_allclose(best, jbest, rtol=RTOL)


# ------------------------------------------------- alpha tools and recon


def test_rescale_apply_and_calibrate_match_reference():
    taus = _taus(1)[0]
    cfg = dict(density=0.2)
    ct = compeft.compress(params_from_jax(taus, device="cpu"),
                          compeft.CompressionConfig(**cfg))
    jct = jcompeft.compress(_j(taus), jcompeft.CompressionConfig(**cfg))
    # carry the reference's scales so the float forms compare bitwise
    ct = tree_util.tree_map(
        lambda c, j: compeft.CompressedTensor(
            signs=c.signs, scale=torch.tensor(float(j.scale)),
            orig_dtype=c.orig_dtype), ct, jct,
        is_leaf=lambda x: hasattr(x, "signs"))
    _bits_equal(compeft.decompress(compeft.rescale(ct, 1.0, 3.0)),
                jcompeft.decompress(jcompeft.rescale(jct, 1.0, 3.0)))
    init = {k: np.ones_like(v) for k, v in taus.items()}
    _bits_equal(compeft.apply_compressed(params_from_jax(init, device="cpu"),
                                         ct),
                jcompeft.apply_compressed(_j(init), jct))

    def score(tree):
        return -sum(float(np.sum((np.asarray(tree[k], np.float32)
                                  - taus[k]) ** 2)) for k in taus)

    a, s, best = compeft.calibrate_alpha(params_from_jax(taus, device="cpu"),
                                         score, density=0.2)
    ja, js, _ = jcompeft.calibrate_alpha(_j(taus), score, density=0.2)
    assert a == ja
    np.testing.assert_allclose(s, js, rtol=1e-5)
    assert isinstance(tree_util.leaves(best, is_leaf=lambda x: hasattr(
        x, "signs"))[0], compeft.CompressedTensor)

