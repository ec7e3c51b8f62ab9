"""Expert merges in the port against the JAX package: the unpack_add /
unpack_add_many kernels' plain versions, the flat merge entry points of
``kernels/ops.py``, ``ExpertRegistry.merged_params``, merge-on-swap
serving (``scheduling="grouped"``, and the mixed scheduler's fallback)
and the merged ensemble.

Tolerance is bitwise throughout: every result here is exact in the JAX
package (``s * (+-1)`` is exact, so each add rounds once), and floats are
compared through their bit patterns, so a -0.0 that should have become
+0.0 counts as a difference.  Inputs come from numpy with a seed and go
to both packages; the JAX kernels run in interpret mode, as
``tests/test_kernels.py`` runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.configs import get_smoke_config
from repro.core.packing import PackedTernary as JPacked
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.unpack_add import unpack_add as j_unpack_add
from repro.kernels.unpack_add import unpack_add_many as j_unpack_add_many
from repro.models import Runtime, build
from repro.peft.lora import _path_str
from repro.serve import Request as JRequest
from repro_torch import api as tapi
from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import packed_from_jax, params_from_jax
from repro_torch.convert import tensor_from_numpy
from repro_torch.core.packing import PackedTernary
from repro_torch.expert import PACKED, Expert
from repro_torch.kernels import ops
from repro_torch.kernels.unpack_add import (unpack_add, unpack_add_many,
                                            unpack_add_many_plain,
                                            unpack_add_plain)
from repro_torch.models import build as t_build
from repro_torch.serve import BASE, Request

RT = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")


def _bits(a) -> np.ndarray:
    """The bit patterns of a float array or tensor (f32 or bf16)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a.view(
            torch.int32)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(a, device="cpu")


def _planes(rng, lead, n):
    """Random uint32 planes [*lead, ceil(n/32)] with about 25% of bits set
    each; pos and neg overlap, so some bits are set in both."""
    shape = (*lead, -(-n // 32))
    def draw():
        return (rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
                & rng.integers(0, 2 ** 32, shape, dtype=np.uint32))
    return draw(), draw()


def _base(rng, shape, dtype):
    """Normal values with -0.0 planted in the first row."""
    b = rng.normal(0, 1, shape).astype(np.float32)
    b.reshape(shape[0], -1)[0, :5] = -0.0
    return np.asarray(jnp.asarray(b, dtype))


UNPACK_CASES = [
    # (M, N, dtype, scale)
    (8, 64, jnp.float32, 0.37),
    (5, 70, jnp.float32, -0.21),        # ragged N, negative scale
    (8, 64, jnp.bfloat16, 0.37),
    (9, 100, jnp.bfloat16, -0.5),       # ragged N, negative scale
    (3, 31, jnp.bfloat16, 0.013),       # N below one word
    (16, 96, jnp.float32, 0.0),         # a zero scale (the BASE slot)
]


@pytest.mark.parametrize("M,N,dtype,scale", UNPACK_CASES)
def test_unpack_add_plain_bitwise_equals_reference(M, N, dtype, scale):
    """-0.0 base entries, a word with both bits set, and padding bits
    beyond N set in the last word (never applied) in every case."""
    rng = np.random.default_rng(M * 1000 + N)
    base = _base(rng, (M, N), dtype)
    pos, neg = _planes(rng, (M,), N)
    pos[0, 0], neg[0, 0] = 0xFFFFFFFF, 0x0000FFFF
    pos[:, -1] |= np.uint32(0x80000000)
    s = np.float32(scale)
    want = j_unpack_add(jnp.asarray(base), jnp.asarray(pos), jnp.asarray(neg),
                        jnp.asarray(s), bm=8, bn=64, interpret=True)
    oracle = jref.unpack_add_ref(jnp.asarray(base), jnp.asarray(pos),
                                 jnp.asarray(neg), jnp.asarray(s))
    got = unpack_add(_t(base), _t(pos), _t(neg), torch.tensor(s))
    assert got.dtype == _t(base).dtype and got.shape == (M, N)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(oracle))


@pytest.mark.parametrize("E,dtype", [(1, jnp.bfloat16), (3, jnp.bfloat16),
                                     (3, jnp.float32)])
def test_unpack_add_many_plain_bitwise_equals_reference_and_loop(E, dtype):
    M, N = 11, 100
    rng = np.random.default_rng(E)
    base = _base(rng, (M, N), dtype)
    pos, neg = _planes(rng, (E, M), N)
    scales = np.asarray([0.5, -0.25, 0.125][:E], np.float32)
    want = j_unpack_add_many(jnp.asarray(base), jnp.asarray(pos),
                             jnp.asarray(neg), jnp.asarray(scales), bm=8,
                             bn=64, interpret=True)
    got = unpack_add_many(_t(base), _t(pos), _t(neg), _t(scales))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    loop = _t(base)
    for e in range(E):
        loop = unpack_add(loop, _t(pos[e]), _t(neg[e]), _t(scales[e]))
    np.testing.assert_array_equal(_bits(got), _bits(loop))


def test_plain_versions_are_the_reference_oracles_mirrored():
    """The wrappers take the plain versions on the CPU; inside
    ``ops.plain_versions()`` the ops hand out the same functions."""
    with ops.plain_versions():
        assert ops.kernel("unpack_add") is unpack_add_plain
        assert ops.kernel("unpack_add_many") is unpack_add_many_plain
    assert {"unpack_add", "unpack_add_many"} <= set(ops.launch_counts())


def _packed(rng, shape, scale):
    n = int(np.prod(shape))
    pos, neg = _planes(rng, (), n)
    neg &= ~pos                                    # as the pack kernels emit
    tail = n % 32
    if tail:                                       # zero bits beyond n
        pos[-1] &= np.uint32((1 << tail) - 1)
        neg[-1] &= np.uint32((1 << tail) - 1)
    return JPacked(pos=jnp.asarray(pos), neg=jnp.asarray(neg),
                   scale=jnp.asarray(np.float32(scale)), shape=shape,
                   orig_dtype=jnp.bfloat16)


@pytest.mark.parametrize("shape,dtype", [
    ((5, 7), jnp.float32),                 # 35 elements: a ragged word
    ((3, 4, 11), jnp.bfloat16),            # rank 3, 132 elements
    ((70, 61), jnp.bfloat16),              # 4270 > 4096 (reference rows), ragged
])
def test_flat_merges_bitwise_equal_reference_ops(shape, dtype):
    assert int(np.prod(shape)) % 32
    rng = np.random.default_rng(int(np.prod(shape)))
    base = _base(rng, shape, dtype)
    pts = [_packed(rng, shape, s) for s in (0.02, -0.03, 0.011)]
    tpts = [packed_from_jax(p, device="cpu") for p in pts]
    weights = [0.5, 1.0, -0.25]
    got = ops.apply_ternary_delta_flat(_t(base), tpts[0])
    want = jops.apply_ternary_delta_flat(jnp.asarray(base), pts[0])
    np.testing.assert_array_equal(_bits(got), _bits(want))
    got = ops.apply_ternary_delta_many_flat(_t(base), tpts, weights)
    want = jops.apply_ternary_delta_many_flat(jnp.asarray(base), pts, weights)
    assert got.shape == shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # without weights, and with a single expert (a view of its planes)
    for idx in ([0, 1, 2], [1]):
        got = ops.apply_ternary_delta_many_flat(_t(base),
                                                [tpts[i] for i in idx])
        want = jops.apply_ternary_delta_many_flat(jnp.asarray(base),
                                                  [pts[i] for i in idx])
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_apply_ternary_delta_2d_bitwise_equals_reference():
    """The 2-D form over per-row-padded planes [M, ceil(N/32)]."""
    rng = np.random.default_rng(5)
    M, N = 6, 80
    base = _base(rng, (M, N), jnp.bfloat16)
    pos, neg = _planes(rng, (M,), N)
    pt = JPacked(pos=jnp.asarray(pos.reshape(-1)),
                 neg=jnp.asarray(neg.reshape(-1)),
                 scale=jnp.asarray(np.float32(-0.07)), shape=(M, N))
    got = ops.apply_ternary_delta(_t(base), packed_from_jax(pt, device="cpu"))
    want = jops.apply_ternary_delta(jnp.asarray(base), pt)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# Registry, engine and ensemble on the qwen2.5-3b smoke config
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """The task vectors of ``tests/test_torch_serve.py``'s fixture, plus
    ``x``: an expert that also carries a leaf outside the parameter tree,
    which the overlay plan cannot express."""
    cfg = get_smoke_config("qwen2_5_3b", n_units=1)
    api = build(cfg)
    base = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    taus = [jax.tree_util.tree_map(
        lambda l: (0.03 * rng.normal(size=l.shape)).astype(np.float32), base)
        for _ in range(3)]
    extra = dict(taus[0], extra={"w": (0.03 * rng.normal(size=(4, 32))
                                       ).astype(np.float32)})
    named = [(f"e{i}", t) for i, t in enumerate(taus)] + [("x", extra)]
    jex = [rapi.compress(jax.tree_util.tree_map(jnp.asarray, t), name=n,
                         density=0.2) for n, t in named]
    jreg = rapi.registry(experts=jex)
    # the reference's planes and scales carried across, so that merges
    # can be compared bitwise (the two packages' scales agree only within
    # a tolerance: the reference sums its moments in f64 off the TPU)
    treg = tapi.registry(device="cpu", experts=[
        Expert.from_packed(e.name, "full", tree_util.unflatten_paths(
            packed_from_jax(e.packed, device="cpu"))) for e in jex])
    tbase = params_from_jax(jax.tree_util.tree_map(np.asarray, base),
                            device="cpu")
    model = t_build(t_smoke("qwen2_5_3b", n_units=1))
    return cfg, api, base, jreg, model, tbase, treg


def _leaf_bits(tree_j, tree_t):
    want = {_path_str(p): l for p, l in
            jax.tree_util.tree_flatten_with_path(tree_j)[0]}
    got = dict(tree_util.flatten_with_paths(tree_t))
    assert got.keys() == want.keys()
    return [(path, _bits(got[path]), _bits(want[path])) for path in want]


@pytest.mark.parametrize("names,weights", [
    (["e1"], None), (["e0", "e1", "e2"], [0.5, 1.0, 0.25])])
def test_registry_merged_params_bitwise_equal_reference(setup, names,
                                                        weights):
    _, _, base, jreg, _, tbase, treg = setup
    want = jreg.merged_params(base, names, weights)
    got = treg.merged_params(tbase, names, weights)
    for path, g, w in _leaf_bits(want, got):
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_registry_merge_of_one_equals_weight_one(setup):
    """merged_params(base, ["e"]) is the merge-on-swap promotion, identical
    to the ensemble path with weight 1; a leaf no expert carries is the
    base's own tensor."""
    *_, tbase, treg = setup
    a = treg.merged_params(tbase, ["e0"])
    b = treg.merged_params(tbase, ["e0"], weights=[1.0])
    for (path, x), (_, y) in zip(tree_util.flatten_with_paths(a),
                                 tree_util.flatten_with_paths(b)):
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=path)
    assert treg.merged_params(tbase, [BASE])["embed"] is tbase["embed"]
    with pytest.raises(ValueError):
        treg.merged_params(tbase, ["e0", "e1"], weights=[1.0])


def _prompts(cfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, L) for L in lens]


@pytest.mark.parametrize("chunk", [3, 8])
def test_grouped_engine_tokens_identical_to_reference(setup, chunk):
    cfg, api, base, jreg, model, tbase, treg = setup
    prompts = _prompts(cfg, 5, (5, 9, 7, 12, 6, 8))
    names = ["e0", "e1", BASE, "e0", "e1", "e0"]
    jr = [JRequest(uid=i, expert=n, prompt=jnp.asarray(p, jnp.int32),
                   max_new_tokens=3 + i)
          for i, (n, p) in enumerate(zip(names, prompts))]
    jeng = rapi.serve(api, RT, base, jreg, max_batch=2, cache_len=48,
                      scheduling="grouped", decode_chunk=chunk)
    jeng.run(jr)
    tr = [Request(uid=i, expert=n, prompt=p, max_new_tokens=3 + i)
          for i, (n, p) in enumerate(zip(names, prompts))]
    eng = tapi.serve(model, tbase, treg, max_batch=2, cache_len=48,
                     scheduling="grouped", decode_chunk=chunk)
    eng.run(tr)
    for a, b in zip(jr, tr):
        assert b.out_tokens == a.out_tokens, b.uid
        assert b.status == "done"
    s = eng.swap_summary()
    assert s["n_swaps"] == jeng.swap_summary()["n_swaps"] == 2
    assert s["n_waves"] == 0
    assert s["n_batches"] == 4          # e0: 2 + 1 rows, e1: 2, BASE: 1


def test_merged_ensemble_equals_loop_of_single_merges(setup):
    """W + sum_e a_e D_e in one sweep per leaf equals applying the scaled
    experts one at a time (mirrors the reference's ensemble contract)."""
    *_, model, tbase, treg = setup
    eng = tapi.serve(model, tbase, treg, cache_len=32)
    weights = [0.5, 1.0, 0.25]
    names = ["e0", "e1", "e2"]
    got = dict(tree_util.flatten_with_paths(
        eng.merged_ensemble_params(names, weights)))
    packs = [treg.get(n).as_path_dict(PACKED) for n in names]
    for path, leaf in tree_util.flatten_with_paths(tbase):
        acc = leaf
        for pk, w in zip(packs, weights):
            if path in pk:
                pt = pk[path]
                acc = ops.apply_ternary_delta_flat(acc, PackedTernary(
                    pos=pt.pos, neg=pt.neg, scale=pt.scale * w,
                    shape=pt.shape, orig_dtype=pt.orig_dtype))
        np.testing.assert_array_equal(_bits(got[path]), _bits(acc),
                                      err_msg=path)


def test_mixed_engine_falls_back_to_merge(setup):
    """A wave whose expert carries a leaf outside the overlay plan is served
    by merge-on-swap under mixed scheduling, with the reference engine's
    tokens; the next wave serves mixed."""
    cfg, api, base, jreg, model, tbase, treg = setup
    prompts = _prompts(cfg, 6, (6, 9, 7, 8, 5))
    names = ["x", "e0", "x", "e1", "e2"]
    jr = [JRequest(uid=i, expert=n, prompt=jnp.asarray(p, jnp.int32),
                   max_new_tokens=4)
          for i, (n, p) in enumerate(zip(names, prompts))]
    jeng = rapi.serve(api, RT, base, jreg, max_batch=3, cache_len=48,
                      continuous=False, decode_chunk=3)
    jeng.run(jr)
    tr = [Request(uid=i, expert=n, prompt=p, max_new_tokens=4)
          for i, (n, p) in enumerate(zip(names, prompts))]
    eng = tapi.serve(model, tbase, treg, max_batch=3, cache_len=48,
                     decode_chunk=3)
    eng.run(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    s = eng.swap_summary()
    assert s["n_swaps"] == jeng.swap_summary()["n_swaps"] == 2
    assert s["n_waves"] == 1 and s["n_batches"] == 2
