"""The port's forward pass vs ``repro.models.transformer``: prefill and
decode logits under a mixed-expert overlay, on weights carried across by
``repro_torch.convert`` (smoke configs of qwen2.5-3b, llama-7b with its
untied head, and gemma2-9b with sandwich norms, the (1 + scale) RMSNorm
and a local window that binds; f32), and the full configs' sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.configs import get_config, get_smoke_config
from repro.core.packing import stack_packed as j_stack
from repro.models import Runtime, build
from repro.models.delta import build_overlay as j_build_overlay
from repro.models.delta import plan_overlay as j_plan_overlay
from repro_torch import api as tapi
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core.packing import stack_packed
from repro_torch.models import build as t_build
from repro_torch.models.delta import build_overlay, plan_overlay

RT = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")
TOL = dict(rtol=1e-5, atol=2e-5)   # f32, sums in other orders


_SETUPS: dict = {}
# per arch: prompt length and cache length of the logits test (gemma's
# prompt outruns its smoke window of 32, so the window binds in prefill
# and in decode)
LENGTHS = {"qwen2_5_3b": (11, 24), "llama_7b": (11, 24),
           "gemma2_9b": (40, 64)}


def _setup(arch):
    if arch not in _SETUPS:
        _SETUPS[arch] = _build_setup(arch)
    return _SETUPS[arch]


@pytest.fixture(scope="module")
def setup():
    return _setup("qwen2_5_3b")


def _build_setup(arch):
    cfg = get_smoke_config(arch, n_units=2)
    api = build(cfg)
    base = api.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    taus = [jax.tree_util.tree_map(
        lambda l: (0.03 * rng.normal(size=l.shape)).astype(np.float32), base)
        for _ in range(2)]
    jex = [rapi.compress(jax.tree_util.tree_map(jnp.asarray, t), density=0.2)
           for t in taus]
    tex = [tapi.compress(params_from_jax(t, device="cpu"), density=0.2,
                         device="cpu")
           for t in taus]
    tcfg = t_smoke(arch, n_units=2)
    tbase = params_from_jax(jax.tree_util.tree_map(np.asarray, base),
                            device="cpu")
    # slot 0 is the BASE zero slot, as DeviceCache.stacked builds it
    jov = j_build_overlay(j_plan_overlay(base, cfg),
                          j_stack([{}] + [e.packed for e in jex]))
    tov = build_overlay(plan_overlay(tbase, tcfg),
                        stack_packed([{}] + [e.packed for e in tex]))
    return cfg, api, base, jov, t_build(tcfg), tbase, tov


@pytest.mark.parametrize("arch,overlay", [
    pytest.param("qwen2_5_3b", True, id="True"),
    pytest.param("qwen2_5_3b", False, id="False"),
    pytest.param("llama_7b", True, id="llama_7b-True"),
    pytest.param("llama_7b", False, id="llama_7b-False"),
    pytest.param("gemma2_9b", True, id="gemma2_9b-True"),
    pytest.param("gemma2_9b", False, id="gemma2_9b-False")])
def test_prefill_and_decode_logits_match_reference(arch, overlay):
    cfg, api, base, jov, tapi_m, tbase, tov = _setup(arch)
    T, cache_len = LENGTHS[arch]
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab, (3, T)).astype(np.int32)
    start = np.asarray([0, 4, 2], np.int32)          # left-padded rows
    eid = np.asarray([1, 0, 2], np.int32)
    jkw = dict(delta=jov, eid=jnp.asarray(eid)) if overlay else {}
    tkw = dict(delta=tov, eid=torch.from_numpy(eid)) if overlay else {}
    jl, jc = api.prefill(base, {"tokens": jnp.asarray(toks)}, RT, cache_len,
                         start=jnp.asarray(start), **jkw)
    tl, tc = tapi_m.prefill(tbase, {"tokens": torch.from_numpy(toks)},
                            cache_len, start=torch.from_numpy(start),
                            **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(3):     # a few decode steps on the argmax token
        tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
        jl, jc = api.decode_step(base, jnp.asarray(tok), jc, RT, **jkw)
        tl, tc = tapi_m.decode_step(tbase, torch.from_numpy(tok), tc,
                                    **tkw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name, layer in jc["layers"].items():
        np.testing.assert_allclose(tc["layers"][name]["k"].numpy(),
                                   np.asarray(layer["k"]), **TOL)
        np.testing.assert_array_equal(tc["layers"][name]["pos"].numpy(),
                                      np.asarray(layer["pos"]))


def test_plain_runtime_is_the_cpu_path(setup):
    """On CPU tensors the wrappers and ``ops.plain_versions()`` run the
    same plain versions: bitwise equal logits.  The switch is scoped: it
    is undone on leaving the block, an exception included."""
    from repro_torch.kernels import ops
    cfg, _, _, _, tapi_m, tbase, tov = setup
    toks = torch.randint(1, cfg.vocab, (2, 6),
                         generator=torch.Generator().manual_seed(0))
    eid = torch.tensor([2, 1], dtype=torch.int32)
    a, _ = tapi_m.prefill(tbase, {"tokens": toks}, 16,
                          delta=tov, eid=eid)
    with ops.plain_versions():
        assert ops.kernel("ternary_matmul_grouped") is ops.PLAIN[
            "ternary_matmul_grouped"]
        b, _ = tapi_m.prefill(tbase, {"tokens": toks}, 16,
                              delta=tov, eid=eid)
    assert torch.equal(a, b)
    with pytest.raises(KeyError):
        with ops.plain_versions():
            raise KeyError
    assert all(ops.kernel(n) is fn for n, fn in ops.KERNELS.items())


def test_ring_fill_wraps_like_reference():
    from repro.models.transformer import _ring_fill as j_ring_fill
    from repro_torch.models.transformer import _ring_fill
    full = np.arange(2 * 7 * 3, dtype=np.float32).reshape(2, 7, 3)
    for S in (4, 7, 9):
        jc, jp = j_ring_fill(jnp.asarray(full), 7, S)
        tc, tp = _ring_fill(torch.from_numpy(full), S)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "llama_7b", "gemma2_9b"])
def test_full_configs_equal_reference(arch):
    """The port's copies of the configs: the same fields and the same
    parameter count as the reference's."""
    tcfg, jcfg = t_config(arch), get_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert repr(tcfg) == repr(jcfg)


@pytest.mark.parametrize("arch", ["llama_7b", "gemma2_9b"])
def test_init_has_reference_leaves(arch):
    """The port's init makes the reference's parameter tree: the same
    paths, shapes and norm fills (zeros under gemma's (1 + scale) norm);
    the untied head for llama, the sandwich norms for gemma."""
    from repro_torch import tree as tree_util
    cfg, _, base, _, tapi_m, _, _ = _setup(arch)
    mine = dict(tree_util.flatten_with_paths(tapi_m.init(seed=0,
                                                         device="cpu")))
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(base)[0]}
    assert sorted(mine) == sorted(ref)
    for path, leaf in ref.items():
        assert tuple(mine[path].shape) == leaf.shape, path
        if path.endswith("norm"):
            np.testing.assert_array_equal(mine[path].numpy(),
                                          np.asarray(leaf), err_msg=path)
    assert ("lm_head" in mine) == (arch == "llama_7b")
    assert any(p.endswith("post_ffn_norm") for p in mine) == (
        arch == "gemma2_9b")
