"""The port's PEFT modules against the JAX package: LoRA and (IA)^3 at
zero init are the identity, ``apply_lora``, ``lora_delta`` and
``apply_ia3`` on trees carried across, path strings equal, ``kind="lora"``
artifacts written by one package read back bitwise by the other, the
deprecated ``compress_expert`` / ``reconstruct_expert`` shims, and the
reference's own LoRA training test on the port (qwen2.5-3b smoke config,
f32 unless a test says bf16; each test states its tolerance)."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.configs import get_smoke_config
from repro.models import Runtime, build
from repro.peft import apply_ia3 as j_apply_ia3
from repro.peft import apply_task_vector as j_apply_task_vector
from repro.peft import apply_lora as j_apply_lora
from repro.peft import compress_expert as j_compress_expert
from repro.peft import init_ia3 as j_init_ia3
from repro.peft import init_lora as j_init_lora
from repro.peft import reconstruct_expert as j_reconstruct
from repro.peft import task_vector as j_task_vector
from repro.peft.lora import LoraConfig as JLoraConfig
from repro.peft.lora import base_shapes_of as j_base_shapes
from repro.peft.lora import lora_delta as j_lora_delta
from repro_torch import api as tapi
from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.expert import PACKED, as_expert
from repro_torch.models import build as t_build
from repro_torch.peft import (ExpertArtifact, IA3Config, LoraConfig,
                              apply_ia3, apply_lora, apply_task_vector,
                              base_shapes_of, compress_expert, init_ia3,
                              init_lora, lora_delta, reconstruct_expert,
                              task_vector)
from repro_torch.train.train_step import value_and_grad

RT = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")
B, T = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from torch's thread pool, and six
    test workers each spinning a pool of every core's threads slow each
    other several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _setup(dtype="float32"):
    cfg = dataclasses.replace(get_smoke_config("qwen2_5_3b"), dtype=dtype)
    tcfg = dataclasses.replace(t_smoke("qwen2_5_3b"), dtype=dtype)
    params = build(cfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    tgt = np.roll(toks, -1, 1)
    tgt[:, -1] = -1
    batch = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgt)}
    return cfg, t_build(tcfg), params, _to_torch(params), batch


def _trained_lora(params, lcfg, seed=1, dtype=None):
    """The reference's LoRA tree with B drawn nonzero (as after training),
    so the product is not trivially zero."""
    lora = j_init_lora(jax.random.PRNGKey(seed), params,
                       JLoraConfig(rank=lcfg.rank, alpha=lcfg.alpha))
    rng = np.random.default_rng(seed)
    return {p: {"a": ab["a"],
                "b": jnp.asarray(0.05 * rng.normal(size=ab["b"].shape),
                                 dtype or ab["b"].dtype)}
            for p, ab in lora.items()}


def test_lora_and_ia3_zero_init_are_identity():
    """Loss unchanged to 1e-6 relative: B = 0 and ell = 0."""
    _, tapi_, _, tparams, batch = _setup()
    l0 = float(tapi_.loss_and_logits(tparams, batch)[0])
    lcfg = LoraConfig(rank=4)
    lora = init_lora(1, tparams, lcfg)
    assert len(lora) > 0
    assert all(float(ab["b"].abs().max()) == 0 for ab in lora.values())
    l1 = float(tapi_.loss_and_logits(apply_lora(tparams, lora, lcfg),
                                     batch)[0])
    ia3 = init_ia3(tparams)
    l2 = float(tapi_.loss_and_logits(apply_ia3(tparams, ia3), batch)[0])
    assert l1 == pytest.approx(l0, rel=1e-6)
    assert l2 == pytest.approx(l0, rel=1e-6)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "llama_7b", "gemma2_9b"])
def test_path_strings_and_shapes_equal_the_reference(arch):
    """LoRA, (IA)^3 and base-shape keys are the reference's strings, in its
    order, with the same factor shapes and dtypes."""
    cfg = get_smoke_config(arch)
    params = build(cfg).init(jax.random.PRNGKey(0))
    tparams = _to_torch(params)
    for rank in (1, 4):
        jl = j_init_lora(jax.random.PRNGKey(1), params, JLoraConfig(rank=rank))
        tl = init_lora(1, tparams, LoraConfig(rank=rank))
        assert list(jl) == sorted(jl) == list(tl)
        for p in jl:
            for k in ("a", "b"):
                assert tuple(jl[p][k].shape) == tuple(tl[p][k].shape)
                assert str(tl[p][k].dtype).endswith(str(jl[p][k].dtype))
    ji, ti = j_init_ia3(params), init_ia3(tparams)
    assert list(ji) == list(ti)
    for p in ji:
        assert tuple(ji[p]["ell"].shape) == tuple(ti[p]["ell"].shape)
    assert j_base_shapes(params) == base_shapes_of(tparams)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_lora_and_delta_match_reference(dtype):
    """The merged weights and dense deltas from the reference's LoRA tree:
    f32 within 1e-6 absolute; bf16 merged weights within one bf16 ulp and
    deltas (a bf16 product in both) within 1% of their leaf's largest."""
    _, _, params, _, _ = _setup(dtype)
    lcfg = LoraConfig(rank=4, alpha=8.0)
    jl = _trained_lora(params, lcfg)
    jcfg = JLoraConfig(rank=4, alpha=8.0)
    want = j_apply_lora(params, jl, jcfg)
    got = apply_lora(_to_torch(params), _to_torch(jl), lcfg)
    for (p, a), (tp, b) in zip(
            jax.tree_util.tree_flatten_with_path(want)[0],
            tree_util.flatten_with_paths(got)):
        a = np.asarray(a, np.float32)
        b = b.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
        else:
            ulp = np.spacing(np.abs(a)) * 2.0 ** 16
            assert (np.abs(a - b) <= ulp).all(), tp
    jd = j_lora_delta(jl, j_base_shapes(params), jcfg)
    td = lora_delta(_to_torch(jl), base_shapes_of(_to_torch(params)), lcfg)
    assert list(jd) == list(td)
    for p in jd:
        a, b = np.asarray(jd[p], np.float32), td[p].float().numpy()
        assert a.shape == b.shape
        tol = 1e-6 if dtype == "float32" else 1e-2 * np.abs(a).max()
        np.testing.assert_allclose(b, a, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_ia3_matches_reference(dtype):
    """Scaled weights from the same ell: bitwise (one f32 product, then
    the cast)."""
    _, _, params, _, _ = _setup(dtype)
    ji = j_init_ia3(params)
    rng = np.random.default_rng(2)
    ji = {p: {"ell": jnp.asarray(0.1 * rng.normal(size=v["ell"].shape),
                                 jnp.float32)} for p, v in ji.items()}
    want = j_apply_ia3(params, ji)
    got = apply_ia3(_to_torch(params), _to_torch(ji), IA3Config())
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_util.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


def test_lora_and_ia3_grads_flow_and_training_reduces_loss():
    """The reference's tests on the port: one SGD step on the LoRA tree
    (0.3) and on the (IA)^3 tree (0.5) lowers the loss."""
    _, tapi_, _, tparams, batch = _setup()
    lcfg = LoraConfig(rank=4, alpha=8.0)
    lora = init_lora(1, tparams, lcfg)

    def lora_loss(lp, b):
        return tapi_.loss_and_logits(apply_lora(tparams, lp, lcfg), b)[0]

    l0, g = value_and_grad(lora_loss, lora, batch)
    assert sum(float(x.abs().sum()) for x in tree_util.leaves(g)) > 0
    lora2 = tree_util.tree_map(lambda p, gg: p - 0.3 * gg, lora, g)
    assert float(lora_loss(lora2, batch)) < float(l0)

    def ia3_loss(ip, b):
        return tapi_.loss_and_logits(apply_ia3(tparams, ip), b)[0]

    ia3 = init_ia3(tparams)
    l0, g = value_and_grad(ia3_loss, ia3, batch)
    ia3_2 = tree_util.tree_map(lambda p, gg: p - 0.5 * gg, ia3, g)
    assert float(ia3_loss(ia3_2, batch)) < float(l0)


def _lora_pair():
    _, _, params, _, _ = _setup("bfloat16")
    lcfg = LoraConfig(rank=4, alpha=8.0)
    lora0 = j_init_lora(jax.random.PRNGKey(1), params,
                        JLoraConfig(rank=4, alpha=8.0))
    return lora0, _trained_lora(params, lcfg, seed=3)


def _planes(ex) -> dict:
    return {p: (np.asarray(pt.pos).view(np.int32),
                np.asarray(pt.neg).view(np.int32))
            for p, pt in ex.packed.items()}


def _tplanes(ex) -> dict:
    return {p: (pt.pos.numpy(), pt.neg.numpy())
            for p, pt in ex.packed.items()}


@pytest.mark.parametrize("suffix", [".npz", ".cpft"])
def test_lora_artifacts_cross_packages_bitwise(tmp_path, suffix):
    """A ``kind="lora"`` expert of a bf16 LoRA fine-tune (density 0.2),
    compressed by each package from the same trees, saved by one and
    loaded by the other: the planes read back bitwise the writer's, the
    kind, paths and scales kept (scales bitwise: the file holds the
    writer's), and the two packages' planes bitwise each other's."""
    lora0, lora = _lora_pair()
    jex = rapi.compress(lora0, lora, name="task", kind="lora", density=0.2)
    tex = tapi.compress(_to_torch(lora0), _to_torch(lora), name="task",
                        kind="lora", density=0.2, device="cpu")
    jp, tp = _planes(jex), _tplanes(tex)
    assert list(jp) == list(tp)
    assert all(p.endswith(("/a", "/b")) for p in jp)
    for p in jp:
        np.testing.assert_array_equal(jp[p][0], tp[p][0])
        np.testing.assert_array_equal(jp[p][1], tp[p][1])
    jpath, tpath = str(tmp_path / f"j{suffix}"), str(tmp_path / f"t{suffix}")
    jex.save(jpath)
    tex.save(tpath)
    back_t = tapi.load(jpath, device="cpu")      # reference -> port
    back_j = rapi.load(tpath)                    # port -> reference
    assert back_t.kind == back_j.kind == "lora"
    for p, (pos, neg) in _tplanes(back_t).items():
        np.testing.assert_array_equal(pos, jp[p][0])
        np.testing.assert_array_equal(neg, jp[p][1])
        assert float(back_t.packed[p].scale) == float(jex.packed[p].scale)
    for p, (pos, neg) in _planes(back_j).items():
        np.testing.assert_array_equal(pos, tp[p][0])
        np.testing.assert_array_equal(neg, tp[p][1])
        assert float(back_j.packed[p].scale) == float(tex.packed[p].scale)


def test_compress_expert_and_reconstruct_match_reference():
    """The deprecated shims: a DeprecationWarning, an ExpertArtifact whose
    planes are bitwise the reference's, scales within 1e-6 relative, its
    bytes the reference's, a reconstruction within 2e-6 of the
    reference's (one bf16 ulp where the scale rounds apart), and the
    artifact accepted as an Expert."""
    lora0, lora = _lora_pair()
    jtau = j_task_vector(lora0, lora)
    ttau = task_vector(_to_torch(lora0), _to_torch(lora))
    for a, b in zip(jax.tree_util.tree_leaves(jtau), tree_util.leaves(ttau)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jart = j_compress_expert("e", "lora", jtau, density=0.2, alpha=1.0)
    with pytest.warns(DeprecationWarning, match="compress_expert"):
        tart = compress_expert("e", "lora", ttau, density=0.2, alpha=1.0)
    assert isinstance(tart, ExpertArtifact) and tart.kind == "lora"
    assert tart.nbytes == jart.nbytes
    jflat = jax.tree_util.tree_flatten_with_path(jart.packed,
                                                 is_leaf=lambda x: hasattr(
                                                     x, "pos"))[0]
    tflat = tree_util.flatten_with_paths(tart.packed,
                                         is_leaf=lambda x: hasattr(x, "pos"))
    assert len(jflat) == len(tflat)
    for (_, a), (_, b) in zip(jflat, tflat):
        np.testing.assert_array_equal(np.asarray(a.pos).view(np.int32),
                                      b.pos.numpy())
        np.testing.assert_array_equal(np.asarray(a.neg).view(np.int32),
                                      b.neg.numpy())
        assert float(b.scale) == pytest.approx(float(a.scale), rel=1e-6)
    want = j_reconstruct(lora0, jart)
    got = reconstruct_expert(_to_torch(lora0), tart)
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_util.leaves(got)):
        a = np.asarray(a, np.float32)
        ulp = np.spacing(np.abs(a)) * 2.0 ** 16
        assert (np.abs(b.float().numpy() - a) <= np.maximum(ulp, 2e-6)).all()
    ex = as_expert(tart)
    assert ex.kind == "lora" and set(ex.packed) == set(
        dict(tree_util.flatten_with_paths(tart.packed,
                                          is_leaf=lambda x: hasattr(x,
                                                                    "pos"))))
    assert ex.as_(PACKED) is tart.packed


def test_apply_task_vector_matches_reference():
    """theta + 0.7 tau in f32, cast to bf16: bitwise."""
    lora0, lora = _lora_pair()
    tau = j_task_vector(lora0, lora)
    want = jax.tree_util.tree_leaves(j_apply_task_vector(lora0, tau, 0.7))
    got = tree_util.leaves(apply_task_vector(_to_torch(lora0),
                                             _to_torch(tau), 0.7))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


def test_compressed_lora_expert_roundtrip():
    """The reference's round trip on the port: 5 SGD steps of a LoRA
    expert, compressed at density 0.3 to under a quarter of its bf16
    bytes, and the reconstruction keeping at least half the fine-tuning
    gain."""
    _, tapi_, _, tparams, batch = _setup()
    lcfg = LoraConfig(rank=4, alpha=8.0)
    lora0 = init_lora(1, tparams, lcfg)

    def loss_fn(lp, b):
        return tapi_.loss_and_logits(apply_lora(tparams, lp, lcfg), b)[0]

    lora = lora0
    for _ in range(5):
        lora = tree_util.tree_map(lambda p, g: p - 0.3 * g, lora,
                                  value_and_grad(loss_fn, lora, batch)[1])
    tau = task_vector(lora0, lora)
    art = tapi.compress(tau, name="exp0", kind="lora", density=0.3,
                        device="cpu")
    assert art.nbytes() < sum(x.numel() * 2
                              for x in tree_util.leaves(tau)) / 4
    lora_hat = tree_util.tree_map(lambda a, d: (a.float() + d).to(a.dtype),
                                  lora0, art.to_dense_tau())
    l_ft, l_hat, l_base = (float(loss_fn(x, batch))
                           for x in (lora, lora_hat, lora0))
    assert l_hat < l_base
    assert l_hat < l_ft + 0.5 * (l_base - l_ft)
