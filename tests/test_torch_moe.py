"""The port's MoE FFN (``repro_torch.models.ffn``) against the reference's
GShard dispatch (``repro.models.ffn``): outputs and the Switch aux loss at
top-2 and top-1, with and without a shared expert, in f32 and bf16; the
routing (gate indices, queue positions, capacity keeps) bitwise, with
planted ties and capacity overflow; the group-size rule; the refused
overlay; ``loss_and_logits`` with its aux term; and the reference's
merge-on-swap fallback on the port's engine.  Smoke widths (d_model 64,
4 experts of d_ff 128), on one torch thread."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from arch_cases import smoke_configs

from repro.data.pipeline import make_batch_for as j_batch
from repro.models import Runtime, build
from repro.models.ffn import ffn_apply as j_ffn_apply
from repro.models.transformer import init_ffn as j_init_ffn
from repro_torch import api as tapi
from repro_torch import tree as tree_util
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import make_batch_for as t_batch
from repro_torch.models import build as t_build
from repro_torch.models.ffn import ffn_apply, moe_route, top_k_first
from repro_torch.serve import Request

RT = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")
F32 = dict(rtol=1e-5, atol=2e-5)      # f32, sums in other orders
# bf16 products: the packages round the expert products to bf16 at
# other points (about one bf16 ulp, 2**-8 relative, per product)
BF16 = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from torch's thread pool, and six
    test workers each spinning a pool of every core's threads slow each
    other several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ffn_cfgs(top_k: int, shared: bool):
    """(reference, port) MoE FFN configs at smoke width: mixtral's
    (top-2) or llama4's MoE layer (top-1, a shared expert), with the
    shared expert switched on or off."""
    arch = "mixtral_8x7b" if top_k == 2 else "llama4_maverick_400b"
    out = []
    for cfg in smoke_configs(arch):
        f = cfg.pattern[-1].ffn
        out.append(dataclasses.replace(f, moe=dataclasses.replace(
            f.moe, shared_expert_dff=128 if shared else None)))
    return out


def _ffn_params(jf, dtype, seed=0):
    p = j_init_ffn(jax.random.PRNGKey(seed), 64, jf, dtype)
    return p, params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                              device="cpu")


def _run_both(jf, tf, jp, tp, x):
    """Both packages' FFN on f32 x -> (out, aux, port out, port aux)."""
    jout, jaux = j_ffn_apply(jnp.asarray(x), jp, jf)
    tout, taux = ffn_apply(torch.from_numpy(x), tp, tf)
    return np.asarray(jout), float(jaux), tout.numpy(), float(taux)


def j_route(x, router, mo):
    """The reference's routing, line for line from ``repro.models.ffn.
    moe_ffn`` (which does not return it): gate values and indices, queue
    positions and keeps for x [G, S, D]."""
    G, S, _ = x.shape
    E, K = mo.n_experts, mo.top_k
    C = max(1, int(np.ceil(K * S / E * mo.capacity_factor)))
    logits = jnp.einsum("gsd,de->gse", x, router, optimize=True)
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, K)
    gate_vals = gate_vals / jnp.maximum(
        jnp.sum(gate_vals, axis=-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(G, S * K, E)
    rank = (jnp.cumsum(flat, axis=1) - flat).reshape(G, S, K, E)
    pos_in_expert = jnp.sum(rank * onehot, axis=-1)
    return (np.asarray(probs), np.asarray(gate_vals), np.asarray(gate_idx),
            np.asarray(pos_in_expert), np.asarray(pos_in_expert < C), C)


def t_route(x, router, mo):
    """The port's routing, in :func:`j_route`'s layout."""
    probs, gv, gi, _, pos, C = moe_route(torch.from_numpy(np.asarray(x)),
                                         router, mo)
    return (probs.numpy(), gv.numpy(), gi.numpy(), pos.numpy(),
            (pos < C).numpy(), C)


@pytest.mark.parametrize("top_k,shared", [(2, False), (2, True), (1, True),
                                          (1, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_reference(top_k, shared, dtype):
    """Outputs within F32 (or BF16) and the aux loss within 1e-6 relative,
    on a prompt (T 40, one group per row) and a decode step (T 1)."""
    jf, tf = _ffn_cfgs(top_k, shared)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp, tp = _ffn_params(jf, jdt)
    rng = np.random.default_rng(top_k + 2 * shared)
    tol = F32 if dtype == "float32" else BF16
    for T in (40, 1):
        x = rng.normal(size=(3, T, 64)).astype(np.float32)
        x = np.array(jnp.asarray(x, jdt).astype(jnp.float32))    # on grid
        jx = jnp.asarray(x, jdt)
        jout, jaux = j_ffn_apply(jx, jp, jf)
        tout, taux = ffn_apply(torch.from_numpy(x).to(
            getattr(torch, dtype)), tp, tf)
        assert tout.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(tout.to(torch.float32).numpy(),
                                   np.asarray(jout, np.float32), **tol)
        assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("top_k", [2, 1])
def test_routing_is_bitwise_the_reference(top_k):
    """Random router: gate indices, queue positions and keeps bitwise;
    probabilities and renormalised gates within 1e-6."""
    jf, tf = _ffn_cfgs(top_k, False)
    jp, tp = _ffn_params(jf, jnp.float32, seed=5)
    x = np.random.default_rng(7).normal(size=(3, 64, 64)).astype(np.float32)
    want = j_route(jnp.asarray(x), jp["router"], jf.moe)
    got = t_route(x, tp["router"], tf.moe)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-7)
    for i in (2, 3, 4):
        np.testing.assert_array_equal(got[i], want[i])
    assert got[5] == want[5] == max(1, int(np.ceil(top_k * 64 / 4 * 1.25)))


@pytest.mark.parametrize("top_k", [2, 1])
def test_planted_tie_and_capacity_overflow(top_k):
    """Experts 1 and 2 get identical router columns that dominate, so every
    token ties between them: the lower index comes first (top-1 takes
    expert 1), as ``lax.top_k`` orders ties.  With S 64 the queues
    overflow their capacity (C 40 at top-2, 20 at top-1): the later
    tokens are dropped to the residual, at the same positions in both
    packages, and the outputs agree."""
    jf, tf = _ffn_cfgs(top_k, False)
    jp, tp = _ffn_params(jf, jnp.float32, seed=9)
    router = np.asarray(jp["router"]).copy()
    router[:, 1] = router[:, 2] = 0.5 + np.abs(router[:, 0])
    x = np.abs(np.random.default_rng(11).normal(size=(2, 64, 64))
               ).astype(np.float32)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    want = j_route(jnp.asarray(x), jp["router"], jf.moe)
    got = t_route(x, tp["router"], tf.moe)
    assert np.array_equal(got[0][..., 1], got[0][..., 2])      # a tie
    assert np.array_equal(want[0][..., 1], want[0][..., 2])
    for i in (2, 3, 4):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_array_equal(got[2][..., 0], 1)
    if top_k == 2:
        np.testing.assert_array_equal(got[2][..., 1], 2)
    C = want[5]
    assert C == (40 if top_k == 2 else 20)
    assert not got[4][:, C:].any() and got[4][:, :C].all()    # overflow
    jout, jaux, tout, taux = _run_both(jf, tf, jp, tp, x)
    np.testing.assert_allclose(tout, jout, **F32)
    np.testing.assert_array_equal(tout[:, C:], 0.0)   # dropped: no FFN
    assert taux == pytest.approx(jaux, rel=1e-6)


def test_top_k_first_orders_ties_by_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                          [0.4, 0.1, 0.4, 0.1]])
    vals, idx = top_k_first(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("B,T", [(1, 6144), (2, 4096)])
def test_group_size_rule(B, T):
    """T a multiple of 2048 (not of 4096) groups tokens by 2048, a
    multiple of 4096 by 4096: G 3 and 2 groups, capacity from S."""
    jf, tf = _ffn_cfgs(2, False)
    jp, tp = _ffn_params(jf, jnp.float32, seed=13)
    x = np.random.default_rng(B).normal(size=(B, T, 64)).astype(np.float32)
    jout, jaux, tout, taux = _run_both(jf, tf, jp, tp, x)
    np.testing.assert_allclose(tout, jout, **F32)
    assert taux == pytest.approx(jaux, rel=1e-6)


def test_overlay_on_an_moe_ffn_is_refused():
    _, tf = _ffn_cfgs(2, False)
    _, tp = _ffn_params(_ffn_cfgs(2, False)[0], jnp.float32)
    with pytest.raises(ValueError, match="merge-on-swap"):
        ffn_apply(torch.zeros(1, 2, 64), tp, tf, dp={"wg_e": object()},
                  eid=torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "llama4_maverick_400b"])
def test_loss_and_logits_with_aux_match_reference(arch):
    """f32: the aux loss summed over blocks and units within 1e-6
    relative, the loss (cross entropy + 0.01 aux) within 1e-5, logits
    within 2e-5; ``remat_policy="unit"`` gives the same forward."""
    cfg, tcfg = smoke_configs(arch)
    api = build(cfg)
    params = api.init(jax.random.PRNGKey(0))
    b = j_batch(cfg, 0, 32, 4, 1)
    loss, (logits, aux) = api.loss_and_logits(params, b, RT)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    tb = t_batch(tcfg, 0, 32, 4, 1, device="cpu")
    tloss, (tlogits, taux) = t_build(tcfg).loss_and_logits(tparams, tb)
    assert float(aux) > 0
    assert float(taux) == pytest.approx(float(aux), rel=1e-6)
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)
    np.testing.assert_allclose(tlogits.detach().numpy(),
                               np.asarray(logits, np.float32), atol=2e-5,
                               rtol=0)
    rl, raux = t_build(tcfg, remat_policy="unit").forward(tparams, tb)
    assert torch.equal(rl, tlogits) and torch.equal(raux, taux)


def test_unsupported_family_falls_back_to_merge():
    """The reference's ``tests/test_serving.py`` case on the port's engine:
    a family the overlay cannot express (MoE) serves via merge-on-swap
    even under mixed scheduling, one merge per distinct expert."""
    _, cfg = smoke_configs("mixtral_8x7b", n_units=1)
    model = t_build(cfg)
    base = model.init(seed=0, device="cpu")
    reg = tapi.registry(device="cpu")
    for i in range(2):
        g = torch.Generator().manual_seed(100 + i)
        ft = tree_util.tree_map(
            lambda l: (l.float() + 0.02 * torch.randn(l.shape, generator=g)
                       ).to(l.dtype), base)
        reg.add(tapi.compress(base, ft, name=f"expert{i}", density=0.2,
                              device="cpu"))
    eng = tapi.serve(model, base, reg, max_batch=4, cache_len=48)
    assert eng._plan is None
    assert eng.cfg.scheduling == "mixed"
    rng = np.random.default_rng(4)
    reqs = [Request(uid=i, expert=f"expert{i % 2}",
                    prompt=rng.integers(1, cfg.vocab, 8), max_new_tokens=2)
            for i in range(4)]
    eng.run(reqs)
    for r in reqs:
        assert len(r.out_tokens) == 2
    assert eng.swap_summary()["n_swaps"] == 2
    assert eng.swap_summary()["n_waves"] == 0
