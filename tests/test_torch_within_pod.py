"""The port's train step inside a pod on gloo ranks, each a child process
on one torch thread: meshes (pod, data, model) = (1, 2, 1), (2, 2, 1),
(1, 1, 2), (1, 2, 2), (2, 1, 2) and (1, 1, 4), every rank holding its
blocks of the train state (``shard_train_state``) and taking its share
of each of its pod's microbatches (``local_rows``).

* Meshes without a "model" axis are bitwise their one-process oracle
  (``within_pod.within_pod_in_one_process``): every rank's blocks of the
  parameters, optimizer slots and error feedback, and the losses, after 3
  steps (AdamW and Adafactor on (1, 2, 1); on (2, 2, 1) the compressed
  cross-pod exchange with the Gaussian and the exact threshold; mixtral
  in bf16 with masked targets on both).
* The loss over data ranks is the reference's logical loss: f32 mixtral
  and qwen2.5 on (1, 2, 1) and (2, 2, 1), ``microbatches`` 2, half of
  data rank 0's targets at -1, on parameters carried across from the
  reference's init (``convert.params_from_jax``): every parameter within
  ``PARAM_TOL`` and every loss within ``LOSS_TOL`` of ``plain_step``
  after 3 steps (on (2, 2, 1) with dense pods, against the mesh-free
  step over the pods' microbatches in order), and the first step's loss
  within ``REF_LOSS_TOL`` of the reference's own ``loss_and_logits``
  (JAX, CPU) averaged over the logical microbatches.
* "model" meshes run f32 copies and are held to the mesh-free
  ``plain_step`` after 3 AdamW steps: every parameter within
  ``PARAM_TOL`` and every loss within ``LOSS_TOL`` (sums over "model" and
  the data ranks reorder the f32 accumulation).  They cover the
  tensor-parallel family with tied (qwen2.5) and untied (llama) heads,
  softcaps and sandwich norms (gemma2), q/k norms (qwen3), query heads
  cut while the KV heads are not ((1, 1, 4)), and rwkv6 with its channel
  mix cut on d_ff and its time mix whole on every model rank (held to
  the mesh-free step in the mesh's order of the channel mix's sum, and
  at ``LOW_LR`` to the whole-sum step, see there;
  ``test_torch_within_pod_families.py`` holds the other families); and
  the MoE family with masked targets:
  mixtral's experts cut on d_ff ((1, 1, 2), (1, 2, 2)) and on E
  (``expert_parallel=True``, (1, 1, 2)), llama4 with its experts cut on
  E, its shared expert on d_ff, a dense block between and attention
  uncut (``head_tp=False``; (1, 2, 2), (1, 1, 4)).  Each MoE rank holds
  its expert blocks at their placed shapes, and the routing of its
  first microbatch's forward (top-k indices and slot positions) equals
  the mesh-free routing of its rows bitwise.
* (2, 1, 2) runs the reference's scenario (``tests/test_distributed.py::
  test_compressed_multipod_train_step``: 12 steps of
  ``make_batch_for(cfg, s, 32, 8)``, compression on) with finite losses
  falling.
* The statistics across blocks are held to the logical leaf's, whose
  code is held to the reference elsewhere: f32 copies of (1, 2, 1) with
  Adafactor, and of (2, 2, 1) and (2, 1, 2) with the compressed exchange
  (exact threshold), against one process updating whole leaves with the
  mesh's gradients (``train_step._apply_optimizer``,
  ``train_step.pods_in_one_process``; every parameter
  within ``PARAM_TOL``, every pod's error feedback within ``EF_TOL`` of
  its largest |value|, so a sign that differs fails); and, with ranks as
  threads, the compression's threshold (exact: bitwise), signs, scale
  and error, the pods' compressed mean, Adafactor's factored moments and
  update RMS and AdamW's global norm, each on blocks against the
  function on the assembled leaf, within ``STAT_TOL`` relative.
* A global batch or a microbatch that does not divide over the data
  ranks raises."""

import contextlib
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.core import gradient_compression as gc
from repro_torch.distributed.collectives import ordered_sum
from repro_torch.distributed.sharding import assemble, train_state_shardings
from repro_torch.models import build
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.train import train_step as ts
from repro_torch.train import within_pod as wp

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
STEPS = 3
GLOBAL_BATCH, SEQ = 8, 8
PARAM_TOL = 1e-4     # f32, after 3 steps at peak lr 5e-3
LOSS_TOL = 1e-5
REF_LOSS_TOL = 1e-5  # f32, the first step's loss against the reference's
EF_TOL = 1e-5        # of a leaf's largest |error feedback|, f32
STAT_TOL = 1e-5      # relative, f32 sums taken block by block
NORM_TOL = 1e-5      # relative, f32: AdamW's global gradient norm (pre-clip)
ZERO_GRAD = 1e-5     # of a leaf's largest |gradient|: zero to f32 rounding
AXES = ("pod", "data", "model")

# case options: "masked" (half of data rank 0's targets at -1), "jax"
# (parameters from the reference's init), "ep" (``expert_parallel=True``),
# "dense" (pods averaged without compression), "route" (the ranks record
# the routing of their first microbatch's forward), "steps" (the ranks
# keep their state after every step), "low_lr" (peak lr ``LOW_LR``),
# "cm_order" (the mesh-free step sums rwkv's channel mix in the mesh's
# "model" parts, :func:`channel_mix_in_parts`)
MASKED_REF = ("masked", "jax")
# rwkv6's smoke step is ill-conditioned: the mesh-free step with only its
# channel mix's d_ff sum in the two ordered parts of (1, 2, 2)'s "model"
# ranks parts from the whole-sum step by 4.2e-4 after 3 steps at peak lr
# 5e-3 and by 5.8e-7 at ``LOW_LR``, while rwkv6 on (1, 1, 2) stays within
# 2.8e-6 of the step in its own order (the witness is
# test_rwkv_channel_mix_order_alone_parts_the_mesh_free_steps; running
# test_torch_within_pod_families.py prints the readings).  So "cm_order"
# holds a mesh to the mesh-free step whose channel mix sums in the
# mesh's order, and a case at ``LOW_LR`` holds it to the whole-sum step.
LOW_LR = 5e-4

# mesh -> cases: (name, arch, dtype, optimizer, exact threshold[, options])
MESHES = {
    (1, 2, 1): [("adamw", "qwen2_5_3b", "bfloat16", "adamw", False),
                ("adafactor", "qwen2_5_3b", "bfloat16", "adafactor", False),
                ("adafactor32", "qwen2_5_3b", "float32", "adafactor",
                 False, ("steps",)),
                ("mixtral", "mixtral_8x7b", "bfloat16", "adamw", False,
                 ("masked",)),
                ("mixtral32m", "mixtral_8x7b", "float32", "adamw", False,
                 MASKED_REF),
                ("qwen32m", "qwen2_5_3b", "float32", "adamw", False,
                 MASKED_REF)],
    (2, 2, 1): [("gauss", "qwen2_5_3b", "bfloat16", "adamw", False),
                ("exact", "qwen2_5_3b", "bfloat16", "adamw", True),
                ("exact32", "qwen2_5_3b", "float32", "adamw", True),
                ("mixtral", "mixtral_8x7b", "bfloat16", "adamw", False,
                 ("masked",)),
                ("mixtral32m", "mixtral_8x7b", "float32", "adamw", False,
                 MASKED_REF + ("dense",)),
                ("qwen32m", "qwen2_5_3b", "float32", "adamw", False,
                 MASKED_REF + ("dense",))],
    (1, 1, 2): [("gemma", "gemma2_9b", "float32", "adamw", False),
                ("qwen3", "qwen3_32b", "float32", "adamw", False),
                ("mixtral", "mixtral_8x7b", "float32", "adamw", False,
                 ("masked", "route")),
                ("mixtral_ep", "mixtral_8x7b", "float32", "adamw", False,
                 ("masked", "route", "ep"))],
    (1, 2, 2): [("llama", "llama_7b", "float32", "adamw", False),
                ("rwkv", "rwkv6_3b", "float32", "adamw", False,
                 ("cm_order",)),
                ("rwkv_low", "rwkv6_3b", "float32", "adamw", False,
                 ("low_lr",)),
                ("mixtral", "mixtral_8x7b", "float32", "adamw", False,
                 ("masked", "route")),
                ("llama4", "llama4_maverick_400b", "float32", "adamw", False,
                 ("masked", "route"))],
    (1, 1, 4): [("qcut", "qwen2_5_3b", "float32", "adamw", False),
                ("llama4", "llama4_maverick_400b", "float32", "adamw", False,
                 ("masked", "route"))],
    (2, 1, 2): [("scenario", "qwen2_5_3b", "float32", "adamw", False),
                ("exact32", "qwen2_5_3b", "float32", "adamw", True)],
}


def opts(case) -> tuple:
    return case[5] if len(case) > 5 else ()


# the (shape, name) pairs of the masked f32 data meshes and of the MoE
# model meshes, each a test of its own
MASKED_DATA = [(sh, c[0]) for sh in ((1, 2, 1), (2, 2, 1))
               for c in MESHES[sh] if "jax" in opts(c)]
MOE_MODEL = [(sh, c[0]) for sh in ((1, 1, 2), (1, 2, 2), (1, 1, 4))
             for c in MESHES[sh] if "route" in opts(c)]
PARAMS_DIR = None    # a child's: where the parent left the carried params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config_of(arch, dtype, ep=False):
    cfg = dataclasses.replace(get_smoke_config(arch, n_units=2), dtype=dtype)
    if ep:
        cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(
            cfg.sharding, expert_parallel=True))
    return cfg


@functools.lru_cache(maxsize=None)
def reference_params(arch, dtype):
    """The reference's init (``jax.random.PRNGKey(0)``) of the smoke
    config, carried across by the port's converter."""
    import jax
    from repro.configs import get_smoke_config as j_smoke
    from repro.models import build as j_build
    from repro_torch.convert import params_from_jax
    cfg = dataclasses.replace(j_smoke(arch, n_units=2), dtype=dtype)
    p = j_build(cfg).init(jax.random.PRNGKey(0))
    return params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                           device="cpu")


def _params_file(where, arch, dtype) -> str:
    return os.path.join(where, f"{arch}_{dtype}.pt")


def model_and_params(arch, dtype, options=()):
    api = build(config_of(arch, dtype, "ep" in options))
    if "jax" not in options:
        return api, api.init(seed=0, device="cpu")
    if PARAMS_DIR is not None:
        return api, torch.load(_params_file(PARAMS_DIR, arch, dtype))
    return api, tree_util.tree_map(lambda t: t.clone(),
                                   reference_params(arch, dtype))


def peak_lr_of(case) -> float:
    return LOW_LR if "low_lr" in opts(case) else 5e-3


def tcfg_of(optimizer, exact, ef_dtype="bfloat16", compress=True,
            microbatches=2, peak_lr=5e-3):
    return ts.TrainConfig(
        microbatches=microbatches, peak_lr=peak_lr, warmup_steps=2,
        total_steps=50, optimizer=optimizer, ef_dtype=ef_dtype,
        grad_compression=gc.GradCompressionConfig(
            enabled=compress, density=0.3, exact_threshold=exact))


def masked_rows(shape, n_micro=2) -> list:
    """The rows data rank 0 of pod 0 takes on a mesh of ``shape`` as the
    reference cuts the batch: its contiguous share of each of the pod's
    contiguous microbatches."""
    b = GLOBAL_BATCH // shape[0] // n_micro
    return [i * b + j for i in range(n_micro) for j in range(b // shape[1])]


def batch_of(cfg, step, scenario=False, masked_shape=None):
    """The step's global batch; with ``masked_shape`` half of the targets
    of the rows data rank 0 of pod 0 takes on that mesh are -1."""
    if scenario:
        from repro_torch.data.pipeline import make_batch_for
        return make_batch_for(cfg, step, 32, 8, device="cpu")
    rng = np.random.default_rng(100 + step)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab,
                                        (GLOBAL_BATCH, SEQ + 1)))
    targets = toks[:, 1:].clone()
    if masked_shape is not None:
        for r in masked_rows(masked_shape):
            targets[r, torch.as_tensor(rng.permutation(SEQ)[:SEQ // 2])] = -1
    return {"tokens": toks[:, :-1], "targets": targets}


def case_batch(case, shape, step):
    """The global batch a case's mesh ``shape`` trains on at ``step``."""
    api_cfg = config_of(case[1], case[2])
    return batch_of(api_cfg, step, case[0] == "scenario",
                    shape if "masked" in opts(case) else None)


def initial_state(case, shape):
    name, arch, dtype, opt, exact = case[:5]
    api, params = model_and_params(arch, dtype, opts(case))
    # the f32 copies held to the logical step keep their error in f32
    tcfg = tcfg_of(opt, exact, "float32" if name.endswith("32")
                   else "bfloat16", compress="dense" not in opts(case),
                   peak_lr=peak_lr_of(case))
    return api, tcfg, ts.init_train_state(params, tcfg,
                                          multi_pod=shape[0] > 1)


def n_steps(case):
    return 12 if case[0] == "scenario" else STEPS


CHILD = r"""
import json, sys, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[5])
import test_torch_within_pod as t
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ffn
from repro_torch.train import train_step as ts
from repro_torch.train import within_pod as wp
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
shape = tuple(json.loads(sys.argv[6]))
t.PARAMS_DIR = sys.argv[7]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
mesh = make_production_mesh(shape=shape, device="cpu")
res = {}
route = ffn.moe_route
for case in t.MESHES[shape]:
    api, tcfg, state = t.initial_state(case, shape)
    local = wp.shard_train_state(state, api.cfg, mesh)
    step = ts.make_train_step(api, tcfg, mesh=mesh)
    losses, norms, routes, states = [], [], [], []

    def record(*a):
        r = route(*a)
        routes.append((r[2].clone(), r[4].clone(), r[5]))
        return r

    for s in range(t.n_steps(case)):
        ffn.moe_route = record if s == 0 and "route" in t.opts(case) \
            else route
        local, m = step(local, t.case_batch(case, shape, s))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]) if "grad_norm" in m else None)
        if "steps" in t.opts(case):
            states.append(local)
    ffn.moe_route = route
    res[case[0]] = {"state": local, "loss": losses, "grad_norm": norms,
                    "routes": routes, "states": states}
if shape == (1, 2, 1):
    for key, n in (("odd", 7), ("odd_micro", 6)):
        try:
            step(local, {k: v[:n] for k, v in t.batch_of(api.cfg, 0).items()})
            res[key] = None
        except ValueError as e:
            res[key] = str(e)
torch.save(res, out)
dist.destroy_process_group()
"""


_RUNS: dict = {}


def _run(shape, tmp_path) -> list:
    """Every case of ``MESHES[shape]`` on its gloo ranks (once per
    module: the tests of one mesh share its run)."""
    if shape not in _RUNS:
        _RUNS[shape] = _spawn(shape, tmp_path)
    return _RUNS[shape]


def _spawn(shape, tmp_path) -> list:
    from mesh_cases import free_port
    n = int(np.prod(shape))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    here = os.path.dirname(os.path.abspath(__file__))
    for case in MESHES[shape]:      # the carried parameters, for the ranks
        if "jax" in opts(case):
            torch.save(reference_params(case[1], case[2]),
                       _params_file(tmp_path, case[1], case[2]))
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(n)]
    kids = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(n), str(port), outs[r],
         here, str(list(shape)), str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    try:
        for p in kids:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in kids:
            if p.poll() is None:
                p.kill()
    return [torch.load(o) for o in outs]


def _coords(shape):
    return wp._coords(dict(zip(AXES, shape)))


def _oracle(case, shape):
    """The case's steps in one process -> ({coords: blocks}, losses)."""
    api, tcfg, state = initial_state(case, shape)
    mesh = wp.AxisSizes(dict(zip(AXES, shape)))
    states = {c: wp.shard_train_state(state, api.cfg, mesh,
                                      dict(zip(AXES, c)))
              for c in _coords(shape)}
    losses = []
    for s in range(n_steps(case)):
        res = wp.within_pod_in_one_process(api, tcfg, shape, states,
                                           case_batch(case, shape, s))
        states = {c: r[0] for c, r in res.items()}
        losses.append(float(res[(0, 0, 0)][1]["loss"]))
    return states, losses


def _case(shape, name):
    return next(c for c in MESHES[shape] if c[0] == name)


@contextlib.contextmanager
def channel_mix_in_parts(M):
    """rwkv's channel mix with its d_ff product in the M contiguous parts
    of a mesh's "model" ranks (``cm_Wk``'s columns, ``cm_Wv``'s rows),
    the parts' products summed in rank order in f32 as ``model_sum``
    sums them: one process in the mesh's order of that sum."""
    whole = rwkv_mod.rwkv_channel_mix

    def in_parts(x, p, state=None, tp=None):
        assert tp is None
        dx = rwkv_mod._shift(x, state) - x
        xk = x + dx * p["cm_mu_k"]
        xr = x + dx * p["cm_mu_r"]
        n = p["cm_Wk"].shape[-1] // M
        parts = []
        for m in range(M):
            cut = slice(m * n, (m + 1) * n)
            kk = torch.square(torch.relu(rwkv_mod._mm(
                xk, p["cm_Wk"][:, cut]).to(torch.float32)))
            parts.append(rwkv_mod._mm(kk.to(x.dtype), p["cm_Wv"][cut]))
        vv = ordered_sum(torch.stack(parts)).to(x.dtype)
        rr = torch.sigmoid(rwkv_mod._mm(xr, p["cm_Wr"]).to(torch.float32))
        return (rr * vv.to(torch.float32)).to(x.dtype), x[:, -1:]

    rwkv_mod.rwkv_channel_mix = in_parts
    try:
        yield
    finally:
        rwkv_mod.rwkv_channel_mix = whole


def _plain(case, shape=(1, 1, 1)):
    """The mesh-free step on the batches of the case's mesh ``shape``:
    over the pods' microbatches in order (the microbatches times the
    pods), which a mesh with dense pods averages alike; with "cm_order",
    rwkv's channel mix summed in the mesh's "model" parts."""
    api, tcfg, state = initial_state(case, (1, 1, 1))
    tcfg = dataclasses.replace(tcfg, microbatches=tcfg.microbatches
                               * shape[0])
    step = ts.make_train_step(api, tcfg)
    losses, norms = [], []
    with (channel_mix_in_parts(shape[2]) if "cm_order" in opts(case)
          else contextlib.nullcontext()):
        for s in range(n_steps(case)):
            state, m = step(state, case_batch(case, shape, s))
            losses.append(float(m["loss"]))
            norms.append(float(m.get("grad_norm", float("nan"))))
    return api, state, losses, norms


@pytest.mark.parametrize("shape", [(1, 2, 1), (2, 2, 1)])
def test_data_meshes_are_bitwise_the_one_process_oracle(shape, tmp_path):
    got = _run(shape, tmp_path)
    for case in MESHES[shape]:
        states, losses = _oracle(case, shape)
        for r, c in enumerate(_coords(shape)):
            a = dict(tree_util.flatten_with_paths(got[r][case[0]]["state"]))
            b = dict(tree_util.flatten_with_paths(states[c]))
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, (case[0], c, k)
                assert torch.equal(a[k], b[k]), (case[0], c, k)
            assert got[r][case[0]]["loss"] == losses, case[0]
        if "ef" in states[(0, 0, 0)]:   # each pod keeps its own
            ef = [dict(tree_util.flatten_with_paths(states[(p, 0, 0)]["ef"]))
                  for p in range(2)]
            assert not all(torch.equal(ef[0][k], ef[1][k]) for k in ef[0])
    if shape == (1, 2, 1):
        assert got[0]["odd"] == ("a global batch of 7 rows does not divide "
                                 "over 2 data ranks")


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2), (1, 1, 4)])
def test_model_meshes_are_within_tolerance_of_plain_step(shape, tmp_path):
    """The dense and recurrent cases (each MoE case is a test of its own,
    :func:`test_moe_meshes_are_within_tolerance_of_plain_step`)."""
    got = _run(shape, tmp_path)
    for case in MESHES[shape]:
        if (shape, case[0]) not in MOE_MODEL:
            _within_plain_step(got, case, shape)


def _within_plain_step(got, case, shape, norms=False):
    """Every rank's losses within LOSS_TOL and the assembled parameters
    within PARAM_TOL of the mesh-free step's; with ``norms``, every
    step's global gradient norm before the clip within NORM_TOL of the
    mesh-free step's, which ties the gradients' scale to it (AdamW's
    update is the same for any uniform factor of the gradients)."""
    sizes = dict(zip(AXES, shape))
    api, want, losses, want_norms = _plain(case, shape)
    for r in range(len(got)):
        np.testing.assert_allclose(got[r][case[0]]["loss"], losses,
                                   atol=LOSS_TOL, rtol=0)
        if norms:
            np.testing.assert_allclose(got[r][case[0]]["grad_norm"],
                                       want_norms, rtol=NORM_TOL, atol=0)
    specs = dict(tree_util.flatten_with_paths(train_state_shardings(
        want, api.cfg, wp.AxisSizes(sizes))))
    blocks = {c: dict(tree_util.flatten_with_paths(got[r][case[0]][
        "state"])) for r, c in enumerate(_coords(shape))}
    flat = dict(tree_util.flatten_with_paths(want))
    for path, spec in specs.items():
        full = assemble({c: b[path] for c, b in blocks.items()}, spec,
                        sizes)
        assert full.shape == flat[path].shape, path
        if path.startswith("params/"):
            err = float((full - flat[path]).abs().max())
            assert err <= PARAM_TOL, (case[0], path, err)


def _params_apart(a, b) -> float:
    fa = dict(tree_util.flatten_with_paths(a["params"]))
    return max(_max_err(w, dict(tree_util.flatten_with_paths(
        b["params"]))[p]) for p, w in fa.items())


def test_rwkv_channel_mix_order_alone_parts_the_mesh_free_steps():
    """The witness for the rwkv cases' references on (1, 2, 2): in one
    process, the step whose channel mix sums its d_ff product in the
    mesh's two ordered parts parts from the whole-sum step by more than
    PARAM_TOL after 3 steps at peak lr 5e-3, though their losses agree
    within LOSS_TOL and their first two gradient norms within NORM_TOL,
    and stays within PARAM_TOL of it at ``LOW_LR``; the mesh is held to
    the first at 5e-3 ("cm_order") and to the second at ``LOW_LR``."""
    shape = (1, 2, 2)
    for lr, apart in (((), True), (("low_lr",), False)):
        whole, parts = (_plain(("w", "rwkv6_3b", "float32", "adamw", False,
                                lr + o), shape)
                        for o in ((), ("cm_order",)))
        np.testing.assert_allclose(parts[2], whole[2], atol=LOSS_TOL,
                                   rtol=0)
        np.testing.assert_allclose(parts[3][:2], whole[3][:2],
                                   rtol=NORM_TOL, atol=0)
        err = _params_apart(parts[1], whole[1])
        assert (err > PARAM_TOL) == apart, (lr, err)


@pytest.mark.parametrize("shape,name", MASKED_DATA)
def test_masked_data_meshes_match_plain_step(shape, name, tmp_path):
    """The loss over data ranks is the logical loss: with half of data
    rank 0's targets at -1 and 2 microbatches, every parameter within
    PARAM_TOL and every loss within LOSS_TOL of the mesh-free step after
    3 steps (mixtral's aux with f_e and p_e over the microbatch's
    tokens on every data rank), and every step's gradient norm within
    NORM_TOL."""
    _within_plain_step(_run(shape, tmp_path), _case(shape, name), shape,
                       norms=True)


def _reference_loss(case, shape) -> float:
    """The reference's ``loss_and_logits`` (JAX, CPU) of the first step's
    logical microbatches on the carried parameters, averaged (per pod,
    then over the pods, as the reference's ``lax.pmean`` does)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as j_smoke
    from repro.models import Runtime
    from repro.models import build as j_build
    cfg = dataclasses.replace(j_smoke(case[1], n_units=2), dtype=case[2])
    api = j_build(cfg)
    params = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), reference_params(case[1], case[2]))
    rt = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")
    batch = {k: v.numpy() for k, v in case_batch(case, shape, 0).items()}
    n = shape[0] * 2                     # the pods' microbatches in order
    rows = GLOBAL_BATCH // n
    losses = [float(api.loss_and_logits(params, {
        k: jnp.asarray(v[i * rows:(i + 1) * rows]) for k, v in
        batch.items()}, rt)[0]) for i in range(n)]
    return float(np.mean(losses))


@pytest.mark.parametrize("shape,name", MASKED_DATA)
def test_masked_data_meshes_first_loss_is_the_references(shape, name,
                                                         tmp_path):
    """The first step's loss (before any update) within REF_LOSS_TOL of
    the reference's own loss of the logical microbatches."""
    got = _run(shape, tmp_path)
    want = _reference_loss(_case(shape, name), shape)
    for r in got:
        assert abs(r[name]["loss"][0] - want) <= REF_LOSS_TOL, (
            r[name]["loss"][0], want)


@pytest.mark.parametrize("shape,name", MOE_MODEL)
def test_moe_meshes_are_within_tolerance_of_plain_step(shape, name,
                                                       tmp_path):
    """The MoE family on "model": experts cut on d_ff (mixtral), on E
    (llama4; mixtral with ``expert_parallel=True``), masked targets; the
    gradient norms too."""
    _within_plain_step(_run(shape, tmp_path), _case(shape, name), shape,
                       norms=True)


@pytest.mark.parametrize("shape,name", MOE_MODEL)
def test_moe_ranks_hold_their_expert_blocks(shape, name, tmp_path):
    """Each rank's resident expert leaves and their AdamW slots have the
    placed shapes: 1 / M of the experts (cut on E) or of their d_ff."""
    from repro_torch.distributed.sharding import local_shard
    got = _run(shape, tmp_path)
    case = _case(shape, name)
    api, tcfg, _ = initial_state(case, (1, 1, 1))
    sizes = wp.AxisSizes(dict(zip(AXES, shape)))
    meta = ts.init_train_state(api.init(device="meta"), tcfg)
    specs = dict(tree_util.flatten_with_paths(train_state_shardings(
        meta, api.cfg, sizes)))
    whole = dict(tree_util.flatten_with_paths(meta))
    ep = api.cfg.sharding.expert_parallel
    n = 0
    for r, c in zip(got, _coords(shape)):
        mine = dict(tree_util.flatten_with_paths(r[name]["state"]))
        for path, leaf in mine.items():
            last = path.split("/")[-1]
            if last not in ("wg_e", "wu_e", "wo_e"):
                continue
            want = local_shard(whole[path], specs[path], sizes,
                               dict(zip(AXES, c)))
            assert leaf.shape == want.shape, (c, path, leaf.shape)
            cut = 1 if ep else (2 if last == "wo_e" else 3)
            assert leaf.shape[cut] * shape[2] == whole[path].shape[cut]
            n += 1
    # three expert leaves of each MoE block in the parameters, mu and nu
    assert n == len(got) * 9 * sum(b.ffn is not None and b.ffn.moe
                                   is not None for b in api.cfg.pattern)


@pytest.mark.parametrize("shape,name", MOE_MODEL)
def test_moe_routing_is_the_mesh_free_routing(shape, name, tmp_path):
    """Every rank routes its rows of the first microbatch over all E: the
    top-k indices and slot positions of each MoE block's first forward,
    and its capacity, bitwise the mesh-free forward's on those rows."""
    got = _run(shape, tmp_path)
    case = _case(shape, name)
    api, tcfg, state = initial_state(case, (1, 1, 1))
    batch = case_batch(case, shape, 0)
    b = GLOBAL_BATCH // tcfg.microbatches
    from repro_torch.models import ffn
    route, want = ffn.moe_route, []

    def record(*a):
        r = route(*a)
        want.append((r[2], r[4], r[5]))
        return r

    ffn.moe_route = record
    try:
        with torch.no_grad():
            api.loss_and_logits(state["params"], {
                k: v[:b] for k, v in batch.items()})
    finally:
        ffn.moe_route = route
    n_moe = sum(blk.ffn is not None and blk.ffn.moe is not None
                for blk in api.cfg.pattern) * api.cfg.n_units
    assert len(want) == n_moe
    rows = b // shape[1]
    for r, c in zip(got, _coords(shape)):
        mine = r[name]["routes"][:n_moe]
        lo = c[1] * rows
        for (gi, pos, cap), (wgi, wpos, wcap) in zip(mine, want):
            assert cap == wcap
            assert torch.equal(gi, wgi[lo:lo + rows]), (c, "top-k")
            assert torch.equal(pos, wpos[lo:lo + rows]), (c, "slots")


def test_reference_scenario_on_pods_and_model_losses_fall(tmp_path):
    got = _run((2, 1, 2), tmp_path)
    for res in got:
        losses = res["scenario"]["loss"]
        assert len(losses) == 12 and np.isfinite(losses).all()
        assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
        assert losses == got[0]["scenario"]["loss"]


def test_a_batch_that_does_not_divide_raises_in_the_oracle():
    case = MESHES[(1, 2, 1)][0]
    api, tcfg, state = initial_state(case, (1, 2, 1))
    mesh = wp.AxisSizes({"pod": 1, "data": 2, "model": 1})
    states = {c: wp.shard_train_state(state, api.cfg, mesh,
                                      dict(zip(AXES, c)))
              for c in _coords((1, 2, 1))}
    odd = {k: v[:7] for k, v in batch_of(api.cfg, 0).items()}
    with pytest.raises(ValueError, match="does not divide over 2 data"):
        wp.within_pod_in_one_process(api, tcfg, (1, 2, 1), states, odd)


@pytest.mark.parametrize("run", [None, "data"])
def test_an_moe_leaf_cut_on_e_raises_outside_tensor_parallelism(run):
    """An MoE block holding fewer experts than the config (a block cut on
    E, as a tensor-parallel rank holds it) raises without a
    tensor-parallel run, where it would drop the tokens routed to the
    experts it lacks."""
    from repro_torch.models import ffn
    api = build(config_of("mixtral_8x7b", "float32"))
    unit = tree_util.tree_map(lambda t: t[0], api.init(
        seed=0, device="cpu")["blocks"]["block0"]["ffn"])
    half = api.cfg.pattern[0].ffn.moe.n_experts // 2
    cut = dict(unit, **{k: unit[k][:half] for k in ("wg_e", "wu_e",
                                                      "wo_e")})
    x = torch.randn(2, 8, api.cfg.d_model)
    one = wp._OneRank() if run else None     # sums over "data", no "model"
    with torch.no_grad():
        ffn.moe_ffn(x, unit, api.cfg.pattern[0].ffn, run=one)
        with pytest.raises(ValueError, match=f"holds {half} of the "
                           "config's"):
            ffn.moe_ffn(x, cut, api.cfg.pattern[0].ffn, run=one)


@pytest.mark.parametrize("where", ["mesh", "oracle"])
def test_a_microbatch_that_does_not_divide_raises(where, tmp_path):
    """6 rows on (1, 2, 1) in 2 microbatches: a microbatch of 3 rows does
    not divide over the 2 data ranks, on the gloo ranks and in the
    oracle."""
    want = "a microbatch of 3 rows does not divide over 2 data ranks"
    if where == "mesh":
        assert _run((1, 2, 1), tmp_path)[0]["odd_micro"] == want
        return
    case = MESHES[(1, 2, 1)][0]
    api, tcfg, state = initial_state(case, (1, 2, 1))
    mesh = wp.AxisSizes({"pod": 1, "data": 2, "model": 1})
    states = {c: wp.shard_train_state(state, api.cfg, mesh,
                                      dict(zip(AXES, c)))
              for c in _coords((1, 2, 1))}
    odd = {k: v[:6] for k, v in batch_of(api.cfg, 0).items()}
    with pytest.raises(ValueError, match=want):
        wp.within_pod_in_one_process(api, tcfg, (1, 2, 1), states, odd)


# ---------------------------------------------------------------------------
# The statistics across blocks against the logical leaf's
# ---------------------------------------------------------------------------


def _assembled_params(got, shape, api, state_key="params"):
    """The logical tree of every rank's blocks of ``state_key``."""
    sizes = dict(zip(AXES, shape))
    specs = dict(tree_util.flatten_with_paths(wp.logical_specs(
        api.cfg, wp.AxisSizes(sizes))))
    blocks = {c: dict(tree_util.flatten_with_paths(g[state_key]))
              for c, g in got.items()}
    return {p: assemble({c: b[p] for c, b in blocks.items()}, specs[p],
                        sizes) for p in specs}


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


@pytest.mark.parametrize("shape,name", [((1, 2, 1), "adafactor32")])
def test_f32_adafactor_mesh_matches_the_logical_update(shape, name,
                                                       tmp_path):
    """Adafactor's factored moments and update RMS over "data" blocks,
    against one process updating the whole leaves with the same
    gradients (the data ranks' sum as the mesh takes it,
    ``within_pod.pod_grads``): each of the mesh's steps from the mesh's
    state before it (assembled), every parameter within PARAM_TOL and the
    loss within LOSS_TOL; and the 3 steps compounded from the initial
    state, every parameter element within PARAM_TOL but those whose
    reference gradient is zero to rounding (at most ZERO_GRAD of its
    leaf's largest |gradient| at some step).  Adafactor's g / sqrt(v)
    turns the rounding of such a gradient into an update of up to lr
    (qwen2.5's K bias in its slowest RoPE dims, whose gradient nearly
    cancels over the positions); an ulp of a block sum moves the next
    step's gradients, so only the compounded check needs the rule."""
    runs = _run(shape, tmp_path)
    api, tcfg, state0 = initial_state(_case(shape, name), shape)
    sizes = dict(zip(AXES, shape))
    specs = dict(tree_util.flatten_with_paths(train_state_shardings(
        state0, api.cfg, wp.AxisSizes(sizes))))

    def assembled(s):
        blocks = {c: dict(tree_util.flatten_with_paths(r[name]["states"][s]))
                  for r, c in zip(runs, _coords(shape))}
        return tree_util.unflatten_paths({
            p: assemble({c: b[p] for c, b in blocks.items()}, sp, sizes)
            for p, sp in specs.items()})

    state = state0
    for s in range(STEPS):
        if s:
            state = assembled(s - 1)
        grads, loss = wp.pod_grads(api, tcfg, state["params"],
                                   batch_of(api.cfg, s), 1, shape[1])
        want, _ = ts._apply_optimizer(state, grads[0], tcfg)
        assert abs(runs[0][name]["loss"][s] - float(ordered_sum(
            torch.stack(loss[0])))) <= LOSS_TOL, s
        full = dict(tree_util.flatten_with_paths(assembled(s)["params"]))
        for path, w in tree_util.flatten_with_paths(want["params"]):
            assert _max_err(full[path], w) <= PARAM_TOL, (s, path)
    state, keep = state0, {}
    for s in range(STEPS):
        grads, _ = wp.pod_grads(api, tcfg, state["params"],
                                batch_of(api.cfg, s), 1, shape[1])
        for path, g in tree_util.flatten_with_paths(grads[0]):
            k = g.abs() > ZERO_GRAD * g.abs().max()
            keep[path] = k & keep.get(path, k)
        state, _ = ts._apply_optimizer(state, grads[0], tcfg)
    full = dict(tree_util.flatten_with_paths(
        assembled(STEPS - 1)["params"]))
    for path, w in tree_util.flatten_with_paths(state["params"]):
        assert keep[path].float().mean() >= 0.5, path   # a rule, not a leaf
        err = (full[path] - w).abs()[keep[path]]
        assert float(err.max()) <= PARAM_TOL, (path, float(err.max()))


@pytest.mark.parametrize("shape,name", [((2, 2, 1), "exact32"),
                                        ((2, 1, 2), "exact32")])
def test_f32_compressed_mesh_matches_pods_on_whole_leaves(shape, name,
                                                          tmp_path):
    """The compressed exchange with the logical leaf's exact threshold and
    scale over blocks: parameters within PARAM_TOL and each pod's error
    feedback within EF_TOL of its largest |value| of the plain multi-pod
    step on whole leaves (the pods' gradients the mean of their data
    ranks' as the mesh takes it)."""
    runs = _run(shape, tmp_path)
    api, tcfg, state = initial_state(_case(shape, name), shape)
    efs = [state["ef"]] * shape[0]
    losses = []
    for s in range(STEPS):
        state, efs, loss, _ = ts.pods_in_one_process(
            api, tcfg, state, efs, batch_of(api.cfg, s), data=shape[1])
        losses.append(float(loss))
    np.testing.assert_allclose(runs[0][name]["loss"], losses, atol=LOSS_TOL,
                               rtol=0)
    got = {c: r[name]["state"] for r, c in zip(runs, _coords(shape))}
    full = _assembled_params(got, shape, api)
    for path, w in tree_util.flatten_with_paths(state["params"]):
        assert _max_err(full[path], w) <= PARAM_TOL, (path,)
    for pod in range(shape[0]):
        mine = {c: g for c, g in got.items() if c[0] == pod}
        ef = _assembled_params({(0,) + c[1:]: g for c, g in mine.items()},
                               (1,) + shape[1:], api, "ef")
        for path, w in tree_util.flatten_with_paths(efs[pod]):
            tol = EF_TOL * float(w.abs().max())
            assert _max_err(ef[path], w) <= tol, (pod, path)


# (sizes, logical shape, placement): cut on two dims, on a stacked 3-d
# leaf, over four data ranks, over a tuple of axes on one dim
BLOCK_CASES = [
    ((1, 2, 2), (8, 12), ("data", "model")),
    ((1, 2, 2), (3, 8, 12), (None, "model", "data")),
    ((1, 4, 1), (16, 4), ("data", None)),
    ((1, 2, 2), (12, 6), (("data", "model"), None)),
]


def _rand(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                           * np.float32(scale))


def _cut(t, spec, sizes, coords):
    from repro_torch.distributed.sharding import local_shard
    return local_shard(t, spec, wp.AxisSizes(sizes), coords)


def _close(a, b, what):
    err = _max_err(a, b)
    assert err <= STAT_TOL * max(float(b.abs().max()), 1e-30), (what, err)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "gauss"])
@pytest.mark.parametrize("shape,leaf,spec", BLOCK_CASES)
def test_block_compression_uses_the_logical_leaf(shape, leaf, spec, exact):
    """Each rank's :func:`compress_block_for_allgather` of its block
    against :func:`compress_leaf_for_allgather` of the whole leaf: the
    threshold (bitwise when exact), every sign (where |g| is not within
    STAT_TOL of a Gaussian threshold), the scale and the error."""
    sizes = dict(zip(AXES, shape))
    cfg = gc.GradCompressionConfig(density=0.1, exact_threshold=exact)
    g, e = _rand(1, leaf, 1e-2), _rand(2, leaf, 1e-3)
    g32 = g + e
    pos, neg, scale, err = gc.compress_leaf_for_allgather(g, e, cfg)
    thr = gc._threshold(g32, cfg)
    signs = gc._unpack_planes(pos, neg, leaf[-1])

    def rank(coords, shards):
        gb, eb = (_cut(t, spec, sizes, coords) for t in (g, e))
        n = g.numel()
        t = gc._sharded_threshold(gb + eb, cfg, shards, spec, n)
        p, q, sc, er = gc.compress_block_for_allgather(gb, eb, cfg, shards,
                                                       spec)
        return {"thr": t, "scale": sc, "err": er,
                "signs": gc._unpack_planes(p, q, gb.shape[-1])}

    res = wp.in_threads(sizes, rank)
    for r in res.values():
        if exact:
            assert torch.equal(r["thr"], thr)
        else:
            _close(r["thr"], thr, "threshold")
        _close(r["scale"], scale, "scale")
    got = {k: assemble({c: r[k] for c, r in res.items()}, spec, sizes)
           for k in ("signs", "err")}
    clear = (g32.abs() - thr).abs() > STAT_TOL * float(thr)
    assert torch.equal(got["signs"][clear], signs[clear])
    assert clear.float().mean() > 0.99
    _close(got["err"], err, "error")


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "gauss"])
def test_pods_compressed_mean_on_blocks_matches_whole_leaves(exact):
    """:func:`compressed_cross_pod_mean_sharded` on (2, 2, 2), each pod
    its own gradient and error: the mean and every pod's new error,
    assembled, against each pod's leaf compressed whole and the
    reconstructions summed in pod order."""
    shape, leaf, spec = (2, 2, 2), (8, 12), ("data", "model")
    sizes = dict(zip(AXES, shape))
    cfg = gc.GradCompressionConfig(density=0.1, exact_threshold=exact)
    gs = [_rand(10 + p, leaf, 1e-2) for p in range(2)]
    es = [_rand(20 + p, leaf, 1e-3) for p in range(2)]
    acc, errs = torch.zeros(leaf), []
    for g, e in zip(gs, es):
        pos, neg, scale, err = gc.compress_leaf_for_allgather(g, e, cfg)
        acc = acc + gc._unpack_planes(pos, neg, leaf[-1]) * scale
        errs.append(err)
    mean = acc / 2

    def rank(coords, shards):
        g, e = (_cut(t[coords["pod"]], spec, sizes, coords)
                for t in (gs, es))
        m, er = gc.compressed_cross_pod_mean_sharded(
            {"w": g}, {"w": e}, cfg, shards, {"w": spec})
        return {"mean": m["w"], "err": er["w"]}

    res = wp.in_threads(sizes, rank)
    for pod in range(2):
        mine = {(0,) + c[1:]: r for c, r in res.items() if c[0] == pod}
        one = dict(sizes, pod=1)
        _close(assemble({c: r["mean"] for c, r in mine.items()}, spec, one),
               mean, "mean")
        _close(assemble({c: r["err"] for c, r in mine.items()}, spec, one),
               errs[pod], "error")


OPT_TREE = {"a": ((8, 12), ("data", "model")),
            "b": ((3, 8, 12), (None, "model", "data")),
            "c": ((16,), (None,)),
            "d": ((12, 6), ("data", None))}


def _opt_specs(opt_state, specs) -> dict:
    """{path: placement} of an optimizer state's leaves from their
    parameters' (the rule of ``train_state_shardings``: ``mu``, ``nu``
    and ``v`` as the parameter, ``vr`` without its last dim, ``vc``
    without the one before)."""
    out = {}
    for q in dict(tree_util.flatten_with_paths(opt_state)):
        parts = q.split("/")
        sp = specs.get(parts[1]) if len(parts) > 1 else None
        if parts[-1] == "count":
            out[q] = ()
        elif parts[-1] == "vr":
            out[q] = sp[:-1]
        elif parts[-1] == "vc":
            out[q] = sp[:-2] + sp[-1:]
        else:
            out[q] = sp
    return out


@pytest.mark.parametrize("optimizer", ["adafactor", "adamw"])
@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 4, 1)])
def test_sharded_optimizer_matches_the_logical_update(optimizer, shape):
    """Two updates of each rank's blocks (Adafactor's factored means and
    update RMS, AdamW's global norm summed over the blocks) against the
    update of the logical leaves: parameters and every slot within
    STAT_TOL of their largest |value|, AdamW's norm likewise."""
    from repro_torch.optim import adafactor, adamw
    sizes = dict(zip(AXES, shape))
    mod = adafactor if optimizer == "adafactor" else adamw
    cfg = (adafactor.AdafactorConfig() if optimizer == "adafactor"
           else adamw.AdamWConfig())
    params = {k: _rand(i, sh) for i, (k, (sh, _)) in
              enumerate(OPT_TREE.items())}
    specs = {k: sp for k, (_, sp) in OPT_TREE.items()}
    grads = [{k: _rand(50 + 10 * s + i, sh, 1e-1 * (s + 1)) for i, (k, (sh,
              _)) in enumerate(OPT_TREE.items())} for s in range(2)]
    lr = torch.tensor(1e-2)
    state, want, norms = mod.init(params, cfg), params, []
    for g in grads:
        want, state, met = mod.update(g, state, want, lr, cfg)
        norms.append(met.get("grad_norm"))
    full_specs = _opt_specs(state, specs)

    def rank(coords, shards):
        def cut(tree):
            return {k: _cut(v, specs[k], sizes, coords)
                    for k, v in tree.items()}
        p = cut(params)
        st = mod.init(params, cfg)
        st = tree_util.unflatten_paths({
            q: _cut(v, full_specs[q], sizes, coords)
            for q, v in tree_util.flatten_with_paths(st)})
        got = []
        for g in grads:
            p, st, met = mod.update(cut(g), st, p, lr, cfg,
                                    shards=shards, specs=specs)
            got.append(met.get("grad_norm"))
        return {"params": p, "opt": st, "norms": got}

    res = wp.in_threads(sizes, rank)
    for k, w in want.items():
        _close(assemble({c: r["params"][k] for c, r in res.items()},
                        specs[k], sizes), w, k)
    for q, w in tree_util.flatten_with_paths(state):
        got = assemble({c: dict(tree_util.flatten_with_paths(r["opt"]))[q]
                        for c, r in res.items()}, full_specs[q], sizes)
        if w.is_floating_point():
            _close(got, w, q)
        else:
            assert torch.equal(got, w), q
    if optimizer == "adamw":
        for r in res.values():
            for a, b in zip(r["norms"], norms):
                _close(a, b, "grad_norm")

