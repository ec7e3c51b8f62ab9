"""The port's training path against the JAX package: ``cross_entropy``
and ``loss_and_logits``, one AdamW and one Adafactor step in bf16 and 5
steps of ``train_loop`` in f32 from a state carried across, the
optimizers on identical gradients, the schedules, microbatch
accumulation, a falling loss, failure recovery bit for bit (port against
port), and train-state checkpoints read across the packages.  Each test
states its tolerance; the smoke config is qwen2.5-3b's (f32 unless a
test says bf16)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs import get_smoke_config
from repro.data.pipeline import make_batch_for as j_batch
from repro.models import Runtime, build
from repro.models.model import cross_entropy as j_cross_entropy
from repro.optim import adafactor as j_adafactor
from repro.optim import adamw as j_adamw
from repro.optim import schedules as j_schedules
from repro.train import LoopConfig as JLoopConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro.train import train_loop as j_train_loop
from repro_torch import tree as tree_util
from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import make_batch_for as t_batch
from repro_torch.distributed.fault import FailureInjector
from repro_torch.models import build as t_build
from repro_torch.models.model import cross_entropy
from repro_torch.optim import adafactor, adamw, schedules
from repro_torch.train import (LoopConfig, TrainConfig, init_train_state,
                               make_train_step, train_loop)
from repro_torch.train.train_step import _microbatch_grads, value_and_grad

RT = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")
QUIET = dict(log=lambda *a: None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Smoke-size tensors gain nothing from torch's thread pool, and six
    test workers each spinning a pool of every core's threads slow each
    other several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _to_torch(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                           device="cpu")


def _setup(dtype="float32", arch="qwen2_5_3b", n_units=2):
    cfg = dataclasses.replace(get_smoke_config(arch, n_units=n_units),
                              dtype=dtype)
    tcfg = dataclasses.replace(t_smoke(arch, n_units=n_units), dtype=dtype)
    api = build(cfg)
    return cfg, api, tcfg, t_build(tcfg), api.init(jax.random.PRNGKey(0))


def _pair(tree_j, tree_t):
    return list(zip(jax.tree_util.tree_leaves(tree_j),
                    tree_util.leaves(tree_t)))


def test_cross_entropy_matches_reference():
    """f32 logits with masked targets: within 1e-6 relative."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (3, 7, 501)).astype(np.float32)
    targets = rng.integers(0, 501, (3, 7)).astype(np.int32)
    targets[0, :3] = -1
    want = float(j_cross_entropy(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(targets)))
    assert got == pytest.approx(want, rel=1e-6)
    assert float(cross_entropy(torch.from_numpy(logits),
                               torch.full((3, 7), -1))) == 0.0


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "llama_7b", "gemma2_9b"])
def test_loss_logits_and_grads_match_reference(arch):
    """f32: loss within 1e-5 relative, logits within 2e-5, every gradient
    within 1e-5 of its leaf's largest |gradient| (the packages sum the
    attention and the products in other orders); the tied embedding's
    gradient holds both the lookup's and the head's share."""
    cfg, api, tcfg, tapi, params = _setup(arch=arch)
    b = j_batch(cfg, 0, 32, 4, 1)
    (loss, (logits, aux)), grads = jax.jit(jax.value_and_grad(
        lambda p: api.loss_and_logits(p, b, RT), has_aux=True))(params)
    tb = t_batch(tcfg, 0, 32, 4, 1, device="cpu")
    tloss, (tlogits, taux) = tapi.loss_and_logits(_to_torch(params), tb)
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)
    assert float(taux) == float(aux) == 0.0
    np.testing.assert_allclose(tlogits.detach().numpy(), _np(logits),
                               atol=2e-5, rtol=0)
    _, tgrads = value_and_grad(lambda p, bb: tapi.loss_and_logits(p, bb)[0],
                               _to_torch(params), tb)
    for g, tg in _pair(grads, tgrads):
        scale = float(np.abs(_np(g)).max()) or 1.0
        np.testing.assert_allclose(tg.numpy(), _np(g), atol=1e-5 * scale,
                                   rtol=0)


def test_eval_loss_matches_reference():
    """The held-out loss (steps 10_000+) of the same f32 weights: within
    1e-5 relative."""
    from repro.data.pipeline import eval_loss as j_eval_loss
    from repro_torch.data.pipeline import eval_loss
    cfg, api, tcfg, tapi, params = _setup()
    want = j_eval_loss(api, params, RT, cfg, 1, n_batches=2, seq_len=32,
                       global_batch=4)
    got = eval_loss(tapi, _to_torch(params), tcfg, 1, n_batches=2,
                    seq_len=32, global_batch=4)
    assert got == pytest.approx(want, rel=1e-5)


def test_remat_unit_gives_the_same_gradients():
    """Recomputing each unit in the backward changes no bit (CPU)."""
    _, _, tcfg, _, params = _setup()
    tb = t_batch(tcfg, 0, 32, 4, 1, device="cpu")
    out = []
    for policy in ("none", "unit"):
        tapi = t_build(tcfg, remat_policy=policy)
        out.append(value_and_grad(
            lambda p, bb: tapi.loss_and_logits(p, bb)[0],  # noqa: B023
            _to_torch(params), tb))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_util.leaves(out[0][1]), tree_util.leaves(out[1][1])):
        assert torch.equal(a, b)


_BF16_STEPS: dict = {}


def _bf16_step(opt):
    """One reference step in bf16 (constant lr 1e-2) from its initial
    state, made once per optimizer: (setup, state, new state, metrics)."""
    if opt not in _BF16_STEPS:
        setup = _setup("bfloat16")
        cfg, api, _, _, params = setup
        jt = JTrainConfig(optimizer=opt, peak_lr=1e-2, schedule="constant")
        state = j_init_state(params, jt, False)
        new, m = jax.jit(j_make_step(api, RT, jt))(state,
                                                   j_batch(cfg, 0, 32, 4, 1))
        _BF16_STEPS[opt] = (setup, state, new, m)
    return _BF16_STEPS[opt]


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_one_bf16_step_matches_reference(opt):
    """One step in bf16 from the same state (constant lr 1e-2).  The
    packages' bf16 gradients differ in their last bits, which can reverse
    the step of an element whose gradient is near zero, so: every weight
    within |step_ref| + |step_port| + 2 bf16 ulps of the reference's, and
    fewer than 1% of the weights further than one bf16 ulp + lr/4 from
    it; the loss within 1e-4 relative."""
    lr = 1e-2
    (cfg, api, tcfg, tapi, params), state, new, m = _bf16_step(opt)
    tt = TrainConfig(optimizer=opt, peak_lr=lr, schedule="constant")
    tnew, tm = make_train_step(tapi, tt)(_to_torch(state),
                                         t_batch(tcfg, 0, 32, 4, 1,
                                                 device="cpu"))
    assert float(tm["loss"]) == pytest.approx(float(m["loss"]), rel=1e-4)
    assert int(tnew["step"]) == 1 and int(tnew["opt"]["count"]) == 1
    n = far = 0
    for (a, b), p0 in zip(_pair(new["params"], tnew["params"]),
                          jax.tree_util.tree_leaves(params)):
        a, b, p0 = _np(a), b.float().numpy(), _np(p0)
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b))) * 2.0 ** 16
        d = np.abs(a - b)
        assert (d <= np.abs(a - p0) + np.abs(b - p0) + 2 * ulp).all()
        n, far = n + d.size, far + int((d > ulp + lr / 4).sum())
    assert far < 0.01 * n, (far, n)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_five_f32_steps_of_the_loop_match_reference(opt):
    """5 steps of ``train_loop`` in f32 from the reference's initial state
    (warmup-cosine lr, peak 1e-2, 2 warmup steps): losses within 1e-5
    relative, every weight within 0.05 * lr of the reference's (a step
    moves a weight by about lr; the gradients differ in their last bits),
    the optimizer's moments within 1e-4 of their leaf's largest."""
    lr = 1e-2
    cfg, api, tcfg, tapi, params = _setup()
    kw = dict(optimizer=opt, peak_lr=lr, warmup_steps=2, total_steps=5)
    jt, tt = JTrainConfig(**kw), TrainConfig(**kw)
    state = j_init_state(params, jt, False)
    lkw = dict(total_steps=5, seq_len=32, global_batch=4, task_id=1)
    tstate0 = _to_torch(state)
    jstate, jhist = j_train_loop(api, RT, jt, JLoopConfig(**lkw),
                                 jax.jit(j_make_step(api, RT, jt)),
                                 state=state, **QUIET)
    tstate, thist = train_loop(tapi, tt, LoopConfig(**lkw),
                               make_train_step(tapi, tt), state=tstate0,
                               **QUIET)
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    for a, b in _pair(jstate["params"], tstate["params"]):
        np.testing.assert_allclose(b.numpy(), _np(a), atol=0.05 * lr, rtol=0)
    for a, b in _pair(jstate["opt"], tstate["opt"]):
        scale = float(np.abs(_np(a)).max()) or 1.0
        np.testing.assert_allclose(b.float().numpy(), _np(a),
                                   atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizer_update_on_the_same_gradients(opt):
    """Both optimizers fed identical f32 gradients (bf16 params with a
    matrix, a vector and a factored 3-D leaf) for 3 updates: every weight
    within one bf16 ulp and the moments within 1e-6 relative (the
    reductions sum in other orders)."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(0, 1, (24, 40)), "b": rng.normal(0, 1, (40,)),
              "u": rng.normal(0, 1, (3, 8, 16))}
    params = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    jmod, tmod = (j_adamw, adamw) if opt == "adamw" else (j_adafactor,
                                                          adafactor)
    jcfg = (j_adamw.AdamWConfig(moment_dtype="bfloat16") if opt == "adamw"
            else j_adafactor.AdafactorConfig(weight_decay=0.1))
    tcfg = (adamw.AdamWConfig(moment_dtype="bfloat16") if opt == "adamw"
            else adafactor.AdafactorConfig(weight_decay=0.1))
    js, ts = jmod.init(params, jcfg), _to_torch(jmod.init(params, jcfg))
    jp, tp = params, _to_torch(params)
    for i in range(3):
        g = {k: jnp.asarray(rng.normal(0, 0.1 * (i + 1), v.shape),
                            jnp.float32) for k, v in params.items()}
        lr = jnp.float32(3e-2)
        jp, js, _ = jax.jit(jmod.update, static_argnums=4)(g, js, jp, lr,
                                                            jcfg)
        tp, ts, _ = tmod.update(_to_torch(g), ts, tp,
                                torch.tensor(3e-2), tcfg)
    for a, b in _pair(jp, tp):
        ulp = np.spacing(np.abs(_np(a))) * 2.0 ** 16
        assert (np.abs(b.float().numpy() - _np(a)) <= ulp).all()
    for a, b in _pair(js, ts):
        np.testing.assert_allclose(b.float().numpy(), _np(a), rtol=1e-6,
                                   atol=1e-30 if opt == "adafactor" else 0)


def test_schedules_match_reference():
    """warmup-cosine within 4 f32 ulps (XLA on the CPU contracts the
    cosine branch's products and sums into fmas, and the libraries' cos
    may round apart), constant bitwise, at every step of a run and past
    its end."""
    for s in range(0, 70):
        step = jnp.int32(s)
        want = float(j_schedules.warmup_cosine(step, peak_lr=3e-4,
                                               warmup_steps=10,
                                               total_steps=60))
        got = float(schedules.warmup_cosine(torch.tensor(s, dtype=torch.int32),
                                            peak_lr=3e-4, warmup_steps=10,
                                            total_steps=60))
        assert abs(got - want) <= 4 * np.spacing(np.float32(want))
        assert float(schedules.constant(torch.tensor(s), peak_lr=3e-4)) == \
            float(j_schedules.constant(step, peak_lr=3e-4))


def test_microbatch_equals_fullbatch_grads():
    """The reference's own invariant on the port: 4 microbatches give the
    full batch's loss (1e-5 relative) and gradients (atol 1e-5, rtol
    1e-4)."""
    _, _, tcfg, tapi, params = _setup()
    tp = _to_torch(params)
    batch = t_batch(tcfg, 0, 32, 8, 0, device="cpu")
    l1, g1 = _microbatch_grads(tapi, tp, batch, 1)
    l4, g4 = _microbatch_grads(tapi, tp, batch, 4)
    assert float(l1) == pytest.approx(float(l4), rel=1e-5)
    for a, b in zip(tree_util.leaves(g1), tree_util.leaves(g4)):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(a.float().numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)


def _loop_setup(opt="adamw"):
    tcfg = t_smoke("qwen2_5_3b")
    tapi = t_build(tcfg)
    tt = TrainConfig(peak_lr=1e-2, warmup_steps=5, total_steps=60,
                     optimizer=opt,
                     adamw=adamw.AdamWConfig(weight_decay=0.0))
    return tapi, tt, make_train_step(tapi, tt)


def test_loss_decreases():
    """The reference's test on the port: 30 AdamW steps drop the mean loss
    of the last 5 by more than 0.5 below the first 5's."""
    tapi, tt, step_fn = _loop_setup()
    lcfg = LoopConfig(total_steps=30, seq_len=32, global_batch=8,
                      log_every=1000)
    _, hist = train_loop(tapi, tt, lcfg, step_fn, device="cpu", **QUIET)
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.5, (first, last)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_failure_recovery_bit_exact(tmp_path, opt):
    """Run A uninterrupted; run B crashes at steps 7 and 13 and restarts
    from its checkpoints (every 5 steps).  Final parameters and optimizer
    state bit-identical."""
    tapi, tt, step_fn = _loop_setup(opt)
    kw = dict(total_steps=20, seq_len=32, global_batch=8, ckpt_every=5,
              log_every=1000)
    sa, _ = train_loop(tapi, tt, LoopConfig(ckpt_dir=str(tmp_path / "a"),
                                            **kw), step_fn, device="cpu",
                       **QUIET)
    logs = []
    sb, hb = train_loop(tapi, tt, LoopConfig(ckpt_dir=str(tmp_path / "b"),
                                             **kw), step_fn,
                        injector=FailureInjector(fail_at_steps=(7, 13)),
                        device="cpu", log=logs.append)
    assert sum("restored to step" in m for m in logs) == 2
    assert len(hb) == 20 + 2 + 3          # steps 5, 6 and 10-12 replayed
    for a, b in zip(tree_util.leaves(sa), tree_util.leaves(sb)):
        assert torch.equal(a, b)
    # a relaunch over the finished run's directory resumes at its end
    sc, hc = train_loop(tapi, tt, LoopConfig(ckpt_dir=str(tmp_path / "b"),
                                             **kw), step_fn, device="cpu",
                        **QUIET)
    assert hc == [] and int(sc["step"]) == 20


def test_nonfinite_loss_raises():
    tapi, tt, _ = _loop_setup()

    def bad_step(state, batch):
        return state, {"loss": torch.tensor(float("nan"))}
    with pytest.raises(RuntimeError, match="non-finite loss at step 0"):
        train_loop(tapi, tt, LoopConfig(total_steps=2), bad_step,
                   device="cpu", **QUIET)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_train_state_checkpoint_crosses_packages(tmp_path, opt, writer):
    """A bf16 train state after one reference step, saved by one package
    and restored by the other: every leaf bitwise, bf16 leaves read
    without ml_dtypes on the port's side."""
    (_, _, _, tapi, _), _, state, _ = _bf16_step(opt)
    tstate = _to_torch(state)
    if writer == "reference":
        jckpt.save(state, str(tmp_path), 1)
        like = init_train_state(tapi.init(device="cpu"),
                                TrainConfig(optimizer=opt))
        got = tckpt.restore(like, str(tmp_path), device="cpu")
        for a, b in zip(tree_util.leaves(tstate), tree_util.leaves(got)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        tckpt.save(tstate, str(tmp_path), 1)
        got = jckpt.restore(state, str(tmp_path))
        for a, b in _pair(got, tstate):
            assert np.asarray(a).dtype.name == str(b.dtype).split(".")[-1]
            np.testing.assert_array_equal(_np(a), b.float().numpy())


def test_pod_mesh_step_names_its_item():
    """The multi-pod step runs one rank a pod (tests/test_torch_multipod.py
    holds it over gloo); a "data" axis inside the pod gives the step
    inside a pod (ROADMAP item 13; tests/test_torch_within_pod.py holds
    it), which reads the mesh's groups only when it runs."""
    class PodMesh:
        mesh_dim_names = ("pod", "data")
        shape = (2, 2)
    _, tt, _ = _loop_setup()
    step = make_train_step(t_build(t_smoke("qwen2_5_3b")), tt,
                           mesh=PodMesh())
    assert step.__module__ == "repro_torch.train.within_pod"

    class OnePerPod:
        mesh_dim_names = ("pod", "data")
        shape = (2, 1)
    # compression off: the plain step, as in the reference
    make_train_step(t_build(t_smoke("qwen2_5_3b")), dataclasses.replace(
        tt, grad_compression=dataclasses.replace(tt.grad_compression,
                                                 enabled=False)),
        mesh=OnePerPod())
