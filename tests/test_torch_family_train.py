"""Training the model families outside the overlay in the port, against
the JAX package at smoke size (f32, 1 unit, the reference's weights and
the reference's batches from ``make_batch_for``, stub frames and mm
embeddings included): one AdamW step of rwkv6-3b, jamba-1.5-large,
seamless-m4t-medium, internvl2-1b and mixtral-8x7b (autograd through the
chunked rwkv and mamba scans, the encoder and the MoE with its aux loss);
mixtral's loss, aux and router gradients; and ``remat_policy="unit"``
through the chunked scans, which changes no bit."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.data.pipeline import make_batch_for as j_batch
from repro.models import Runtime, build
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.models import build as t_build
from repro_torch.models import mamba as t_mamba
from repro_torch.models import rwkv as t_rwkv
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.train_step import value_and_grad

RT = Runtime(attn_chunk_q=16, attn_chunk_k=16, mamba_chunk=8, rwkv_chunk=8,
             remat_policy="none")
ARCHS = ("rwkv6_3b", "jamba_1_5_large_398b", "seamless_m4t_medium",
         "internvl2_1b", "mixtral_8x7b")
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _chunks_of_8(monkeypatch):
    """The reference runs its scans at ``RT``'s chunk of 8; so does the
    port (several chunks over the 24 to 32 positions)."""
    monkeypatch.setattr(t_mamba, "CHUNK", 8)
    monkeypatch.setattr(t_rwkv, "CHUNK", 8)


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _setup(arch):
    cfg = get_smoke_config(arch, n_units=1)
    api = build(cfg)
    params = jax.jit(api.init)(jax.random.PRNGKey(0))
    batch = j_batch(cfg, 0, 32, 4, 1)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return cfg, api, params, t_build(t_smoke(arch, n_units=1)), batch, tb


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_matches_reference(arch):
    """One f32 AdamW step (constant lr 1e-3, clip at global norm 1) from
    the same state, held leaf by leaf.  The loss and the gradient's global
    norm within 1e-5 relative.  After one step ``mu`` is 0.1 times the
    clipped gradient and ``nu`` 0.05 times its square, so each leaf's
    ``mu`` within 1e-5 of the leaf's largest |mu| (``nu`` within 2e-5)
    holds every leaf's gradient to the reference's.  Each weight then
    moves by lr times (m/c1) / (sqrt(v/c2) + eps), about the sign of its
    gradient, plus the decay: every weight within 8 ulps of max(|w|, lr)
    of the reference's, plus lr times the difference of the two packages'
    steps as their own moments give them.  That difference is only large
    where a gradient lies within its tolerance of zero and steps the other
    way; where the reference's |gradient| is clearly above zero (1e-3 of
    the leaf's largest, and 1e3 eps after the clip) the 8 ulps alone."""
    cfg, api, params, tapi_m, batch, tb = _setup(arch)
    jt = JTrainConfig(optimizer="adamw", peak_lr=LR, schedule="constant")
    state = j_init_state(params, jt, False)
    new, m = jax.jit(j_make_step(api, RT, jt))(state, batch)
    tt = TrainConfig(optimizer="adamw", peak_lr=LR, schedule="constant")
    tnew, tm = make_train_step(tapi_m, tt)(_to_torch(state), tb)
    assert float(tm["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(m["grad_norm"]),
                                                   rel=1e-5)
    assert int(tnew["step"]) == 1
    eps, c1, c2 = jt.adamw.eps, 1 - jt.adamw.b1, 1 - jt.adamw.b2
    strict = 0
    for (path, a), b, p0, ma, mb, va, vb in zip(
            jax.tree_util.tree_flatten_with_path(new["params"])[0],
            tree_util.leaves(tnew["params"]),
            jax.tree_util.tree_leaves(params),
            jax.tree_util.tree_leaves(new["opt"]["mu"]),
            tree_util.leaves(tnew["opt"]["mu"]),
            jax.tree_util.tree_leaves(new["opt"]["nu"]),
            tree_util.leaves(tnew["opt"]["nu"])):
        name = jax.tree_util.keystr(path)
        ma, mb, va, vb = _np(ma), mb.numpy(), _np(va), vb.numpy()
        mscale = float(np.abs(ma).max()) or 1.0
        np.testing.assert_allclose(mb, ma, atol=1e-5 * mscale, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(vb, va, rtol=0, err_msg=name,
                                   atol=2e-5 * (float(va.max()) or 1.0))
        a, b, p0 = _np(a), b.float().numpy(), _np(p0)
        step_a, step_b = ((m64 / c1) / (np.sqrt(v64 / c2) + eps)
                          for m64, v64 in ((ma.astype(np.float64), va),
                                           (mb.astype(np.float64), vb)))
        ulps = 8 * np.spacing(np.maximum(np.abs(p0), np.float32(LR)))
        d = np.abs(a.astype(np.float64) - b)
        assert (d <= ulps + LR * np.abs(step_a - step_b)).all(), name
        clear = (np.abs(ma) >= 1e-3 * mscale) & (np.abs(ma) / c1 >= 1e3 * eps)
        assert (d[clear] <= ulps[clear]).all(), name
        strict += int(clear.sum())
    assert strict > sum(x.size for x in jax.tree_util.tree_leaves(params)) / 2


def test_moe_loss_aux_and_router_gradients_match_reference():
    """mixtral-8x7b: the loss (aux included) and the aux within 1e-5
    relative; every gradient, the routers' (which the aux loss reaches)
    among them, within 1e-5 of its leaf's largest |gradient|."""
    cfg, api, params, tapi_m, batch, tb = _setup("mixtral_8x7b")
    (loss, (_, aux)), grads = jax.jit(jax.value_and_grad(
        lambda p: api.loss_and_logits(p, batch, RT), has_aux=True))(params)
    tparams = _to_torch(params)
    with torch.no_grad():
        tloss, (_, taux) = tapi_m.loss_and_logits(tparams, tb)
    assert float(taux) > 0
    assert float(taux) == pytest.approx(float(aux), rel=1e-5)
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)
    _, tgrads = value_and_grad(lambda p, bb: tapi_m.loss_and_logits(p, bb)[0],
                               tparams, tb)
    routers = 0
    for (path, g), tg in zip(
            jax.tree_util.tree_flatten_with_path(grads)[0],
            tree_util.leaves(tgrads)):
        scale = float(np.abs(_np(g)).max()) or 1.0
        np.testing.assert_allclose(tg.numpy(), _np(g), atol=1e-5 * scale,
                                   rtol=0, err_msg=str(path))
        routers += path[-1].key == "router"
    assert routers == 1


@pytest.mark.parametrize("arch", ["rwkv6_3b", "jamba_1_5_large_398b",
                                  "seamless_m4t_medium"])
def test_remat_unit_holds_through_the_chunked_scans(arch):
    """Recomputing each unit in the backward (with the scans' own
    per-chunk checkpoints nested inside) gives bitwise the gradients of
    keeping every activation (CPU)."""
    cfg = t_smoke(arch, n_units=2)
    params = t_build(cfg).init(seed=0, device="cpu")
    j = j_batch(get_smoke_config(arch, n_units=2), 0, 32, 2, 1)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in j.items()}
    out = []
    for policy in ("none", "unit"):
        tapi_m = t_build(cfg, remat_policy=policy)
        out.append(value_and_grad(
            lambda p, bb: tapi_m.loss_and_logits(p, bb)[0],  # noqa: B023
            params, tb))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_util.leaves(out[0][1]), tree_util.leaves(out[1][1])):
        assert torch.equal(a, b)
