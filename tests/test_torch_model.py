"""The port's forward pass vs ``repro.models.transformer``: prefill and
decode logits under a mixed-expert overlay, on weights carried across by
``repro_torch.convert`` (smoke configs of qwen2.5-3b, llama-7b with its
untied head, gemma2-9b with sandwich norms, the (1 + scale) RMSNorm and a
local window that binds, qwen3-32b with per-head q/k RMSNorm, qwen1.5-110b
with QKV bias, and the MoE configs mixtral-8x7b (top-2, a window that
binds) and llama4-maverick (top-1, a shared expert, dense and MoE layers
alternating), which no overlay covers; f32), and the full configs'
sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from arch_cases import MOE_ARCHS, smoke_configs

from repro import api as rapi
from repro.configs import get_config
from repro.core.packing import stack_packed as j_stack
from repro.models import Runtime, build
from repro.models.delta import build_overlay as j_build_overlay
from repro.models.delta import plan_overlay as j_plan_overlay
from repro_torch import api as tapi
from repro_torch.configs import get_config as t_config
from repro_torch.convert import params_from_jax
from repro_torch.core.packing import stack_packed
from repro_torch.models import build as t_build
from repro_torch.models.delta import build_overlay, plan_overlay

RT = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")
TOL = dict(rtol=1e-5, atol=2e-5)   # f32, sums in other orders



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from torch's thread pool, and six
    test workers each spinning a pool of every core's threads slow each
    other several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_SETUPS: dict = {}
# per arch: prompt length and cache length of the logits test (gemma's
# prompt outruns its smoke window of 32, so the window binds in prefill
# and in decode)
LENGTHS = {"qwen2_5_3b": (11, 24), "llama_7b": (11, 24),
           "gemma2_9b": (40, 64), "qwen3_32b": (11, 24),
           "qwen1_5_110b": (11, 24), "mixtral_8x7b": (40, 64),
           "llama4_maverick_400b": (11, 24)}
# the reference inits q/k norms to ones and QKV biases to zeros; these
# archs' tests put seeded noise on them, so the branches carry values
NOISY_VECTORS = ("q_norm", "k_norm", "bq", "bk", "bv")
NOISY_ARCHS = ("qwen3_32b", "qwen1_5_110b")


def _setup(arch):
    if arch not in _SETUPS:
        _SETUPS[arch] = _build_setup(arch)
    return _SETUPS[arch]


@pytest.fixture(scope="module")
def setup():
    return _setup("qwen2_5_3b")


def _build_setup(arch):
    cfg, tcfg = smoke_configs(arch)
    api = build(cfg)
    base = api.init(jax.random.PRNGKey(0))
    if arch in NOISY_ARCHS:
        nrng = np.random.default_rng(3)
        base = jax.tree_util.tree_map_with_path(
            lambda path, l: (l + 0.3 * nrng.normal(size=l.shape)).astype(
                l.dtype) if path[-1].key in NOISY_VECTORS else l, base)
    rng = np.random.default_rng(1)
    taus = [jax.tree_util.tree_map(
        lambda l: (0.03 * rng.normal(size=l.shape)).astype(np.float32), base)
        for _ in range(2)]
    jex = [rapi.compress(jax.tree_util.tree_map(jnp.asarray, t), density=0.2)
           for t in taus]
    tex = [tapi.compress(params_from_jax(t, device="cpu"), density=0.2,
                         device="cpu")
           for t in taus]
    tbase = params_from_jax(jax.tree_util.tree_map(np.asarray, base),
                            device="cpu")
    # slot 0 is the BASE zero slot, as DeviceCache.stacked builds it; an
    # MoE config has no plan in either package (merge-on-swap only)
    jplan, tplan = j_plan_overlay(base, cfg), plan_overlay(tbase, tcfg)
    assert (jplan is None) == (tplan is None) == (arch in MOE_ARCHS)
    jov = tov = None
    if jplan is not None:
        jov = j_build_overlay(jplan, j_stack([{}] + [e.packed for e in jex]))
        tov = build_overlay(tplan,
                            stack_packed([{}] + [e.packed for e in tex]))
    return cfg, api, base, jov, t_build(tcfg), tbase, tov


@pytest.mark.parametrize("arch,overlay", [
    pytest.param("qwen2_5_3b", True, id="True"),
    pytest.param("qwen2_5_3b", False, id="False"),
    pytest.param("llama_7b", True, id="llama_7b-True"),
    pytest.param("llama_7b", False, id="llama_7b-False"),
    pytest.param("gemma2_9b", True, id="gemma2_9b-True"),
    pytest.param("gemma2_9b", False, id="gemma2_9b-False"),
    pytest.param("qwen3_32b", True, id="qwen3_32b-True"),
    pytest.param("qwen3_32b", False, id="qwen3_32b-False"),
    pytest.param("qwen1_5_110b", True, id="qwen1_5_110b-True"),
    pytest.param("qwen1_5_110b", False, id="qwen1_5_110b-False"),
    pytest.param("mixtral_8x7b", False, id="mixtral_8x7b-False"),
    pytest.param("llama4_maverick_400b", False,
                 id="llama4_maverick_400b-False")])
def test_prefill_and_decode_logits_match_reference(arch, overlay):
    cfg, api, base, jov, tapi_m, tbase, tov = _setup(arch)
    T, cache_len = LENGTHS[arch]
    rng = np.random.default_rng(2)
    toks = rng.integers(1, cfg.vocab, (3, T)).astype(np.int32)
    start = np.asarray([0, 4, 2], np.int32)          # left-padded rows
    eid = np.asarray([1, 0, 2], np.int32)
    if overlay and arch == "qwen3_32b":     # the q/k-norm deltas carry
        attn = tov["blocks"]["block0"]["attn"]
        assert all(float(attn[n].values[1:].abs().sum()) > 0
                   for n in ("q_norm", "k_norm"))
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


ALL_ARCHS = ["qwen2_5_3b", "llama_7b", "gemma2_9b", "qwen3_32b",
             "qwen1_5_110b", "mixtral_8x7b", "llama4_maverick_400b"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_full_configs_equal_reference(arch):
    """The port's copies of the configs: the same fields and the same
    parameter count as the reference's."""
    tcfg, jcfg = t_config(arch), get_config(arch)
    assert tcfg.param_count() == jcfg.param_count()
    assert repr(tcfg) == repr(jcfg)


@pytest.mark.parametrize("arch", ["llama_7b", "gemma2_9b", "qwen3_32b",
                                  "qwen1_5_110b", "mixtral_8x7b",
                                  "llama4_maverick_400b"])
def test_init_has_reference_leaves(arch):
    """The port's init makes the reference's parameter tree: the same
    paths, shapes, dtypes and norm fills (zeros under gemma's (1 + scale)
    norm, ones for qwen3's q/k norms); the untied head where the config
    has one, the sandwich norms for gemma, the MoE's f32 router, expert
    stacks and llama4's shared expert."""
    from repro_torch import tree as tree_util
    cfg, _, base, _, tapi_m, _, _ = _setup(arch)
    mine = dict(tree_util.flatten_with_paths(tapi_m.init(seed=0,
                                                         device="cpu")))
    ref = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(base)[0]}
    if arch in NOISY_ARCHS:       # the test's noise, not the init
        ref = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
               for path, leaf in jax.tree_util.tree_flatten_with_path(
                   build(cfg).init(jax.random.PRNGKey(0)))[0]}
    assert sorted(mine) == sorted(ref)
    for path, leaf in ref.items():
        assert tuple(mine[path].shape) == leaf.shape, path
        assert str(mine[path].dtype).split(".")[-1] == str(leaf.dtype), path
        if path.endswith("norm"):
            np.testing.assert_array_equal(mine[path].numpy(),
                                          np.asarray(leaf), err_msg=path)
    assert ("lm_head" in mine) == (not cfg.tie_embeddings)
    assert any(p.endswith("q_norm") for p in mine) == (arch == "qwen3_32b")
    assert any(p.endswith("/router") for p in mine) == (arch in MOE_ARCHS)
    assert any(p.endswith("/wg_s") for p in mine) == (
        arch == "llama4_maverick_400b")
    assert any(p.endswith("post_ffn_norm") for p in mine) == (
        arch == "gemma2_9b")


@pytest.mark.parametrize("arch,lo,hi", [
    ("qwen2_5_3b", 2.8e9, 3.3e9), ("llama_7b", 6.3e9, 7.2e9),
    ("gemma2_9b", 8.8e9, 9.8e9), ("qwen3_32b", 31e9, 34e9),
    ("qwen1_5_110b", 105e9, 115e9), ("mixtral_8x7b", 45e9, 48e9),
    ("llama4_maverick_400b", 390e9, 410e9)])
def test_param_counts_match_public_sizes(arch, lo, hi):
    """The bounds the reference holds (``tests/test_arch_smoke.py``)."""
    assert lo <= t_config(arch).param_count() <= hi


def test_aliases_resolve_to_the_reference_archs():
    from repro.configs.registry import ARCHS as J_ARCHS
    from repro.configs.registry import _ALIASES as J_ALIASES
    from repro_torch.configs.registry import ARCHS, _ALIASES
    assert set(ARCHS) <= set(J_ARCHS)
    for alias, name in J_ALIASES.items():
        if name in ARCHS:
            assert _ALIASES[alias] == name
            assert repr(t_config(alias)) == repr(get_config(alias))


@pytest.mark.parametrize("kind", ["mamba", "rwkv"])
def test_other_families_are_refused_naming_item_12(kind):
    """Recurrent blocks, once refused naming ROADMAP queue 1, item 12, now
    run: the smoke config of the family holding ``kind`` blocks (jamba's
    mamba, rwkv6) initialises with them, and its prefill and a decode step
    give finite logits and carry the block's recurrent state in the
    cache (``tests/test_torch_families.py`` holds them to the
    reference)."""
    from repro_torch import tree as tree_util
    from repro_torch.configs import get_smoke_config as t_smoke
    arch = "jamba_1_5_large_398b" if kind == "mamba" else "rwkv6_3b"
    cfg = t_smoke(arch, n_units=1)
    assert any(b.kind == kind for b in cfg.pattern)
    model = t_build(cfg)
    params = model.init(seed=0, device="cpu")
    assert any(f"/{kind}/" in p
               for p, _ in tree_util.flatten_with_paths(params))
    toks = torch.arange(1, 9).reshape(1, 8)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, 16)
        assert torch.isfinite(logits).all()
        state = "h" if kind == "mamba" else "S"
        name = next(n for n, layer in cache["layers"].items()
                    if state in layer)
        before = cache["layers"][name][state].clone()
        assert before.abs().sum() > 0
        logits, cache = model.decode_step(params, toks[:, -1:], cache)
    assert torch.isfinite(logits).all()
    assert not torch.equal(cache["layers"][name][state], before)
