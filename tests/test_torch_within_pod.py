"""The port's train step inside a pod on gloo ranks, each a child process
on one torch thread: meshes (pod, data, model) = (1, 2, 1), (2, 2, 1),
(1, 1, 2), (1, 2, 2), (2, 1, 2) and (1, 1, 4), every rank holding its
blocks of the train state (``shard_train_state``) and taking its rows of
the global batch.

* Meshes without a "model" axis are bitwise their one-process oracle
  (``within_pod.within_pod_in_one_process``): every rank's blocks of the
  parameters, optimizer slots and error feedback, and the losses, after 3
  steps (AdamW and Adafactor on (1, 2, 1); on (2, 2, 1) the compressed
  cross-pod exchange with the Gaussian and the exact threshold).
* "model" meshes run f32 copies and are held to the mesh-free
  ``plain_step`` after 3 AdamW steps: every parameter within
  ``PARAM_TOL`` and every loss within ``LOSS_TOL`` (sums over "model" and
  the data ranks reorder the f32 accumulation).  They cover the
  tensor-parallel family with tied (qwen2.5) and untied (llama) heads,
  softcaps and sandwich norms (gemma2), q/k norms (qwen3), query heads
  cut while the KV heads are not ((1, 1, 4)), and a family that gathers
  its leaves whole (rwkv6).
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
* A global batch that does not divide over the data ranks raises."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.core import gradient_compression as gc
from repro_torch.distributed.sharding import assemble, train_state_shardings
from repro_torch.models import build
from repro_torch.train import train_step as ts
from repro_torch.train import within_pod as wp

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
STEPS = 3
GLOBAL_BATCH, SEQ = 8, 8
PARAM_TOL = 1e-4     # f32, after 3 steps at peak lr 5e-3
LOSS_TOL = 1e-5
EF_TOL = 1e-5        # of a leaf's largest |error feedback|, f32
STAT_TOL = 1e-5      # relative, f32 sums taken block by block
AXES = ("pod", "data", "model")

# mesh -> cases: (name, arch, dtype, optimizer, exact threshold)
MESHES = {
    (1, 2, 1): [("adamw", "qwen2_5_3b", "bfloat16", "adamw", False),
                ("adafactor", "qwen2_5_3b", "bfloat16", "adafactor", False),
                ("adafactor32", "qwen2_5_3b", "float32", "adafactor",
                 False)],
    (2, 2, 1): [("gauss", "qwen2_5_3b", "bfloat16", "adamw", False),
                ("exact", "qwen2_5_3b", "bfloat16", "adamw", True),
                ("exact32", "qwen2_5_3b", "float32", "adamw", True)],
    (1, 1, 2): [("gemma", "gemma2_9b", "float32", "adamw", False),
                ("qwen3", "qwen3_32b", "float32", "adamw", False)],
    (1, 2, 2): [("llama", "llama_7b", "float32", "adamw", False),
                ("rwkv", "rwkv6_3b", "float32", "adamw", False)],
    (1, 1, 4): [("qcut", "qwen2_5_3b", "float32", "adamw", False)],
    (2, 1, 2): [("scenario", "qwen2_5_3b", "float32", "adamw", False),
                ("exact32", "qwen2_5_3b", "float32", "adamw", True)],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model_and_params(arch, dtype):
    cfg = dataclasses.replace(get_smoke_config(arch, n_units=2), dtype=dtype)
    api = build(cfg)
    return api, api.init(seed=0, device="cpu")


def tcfg_of(optimizer, exact, ef_dtype="bfloat16"):
    return ts.TrainConfig(
        microbatches=2, peak_lr=5e-3, warmup_steps=2, total_steps=50,
        optimizer=optimizer, ef_dtype=ef_dtype,
        grad_compression=gc.GradCompressionConfig(
            enabled=True, density=0.3, exact_threshold=exact))


def batch_of(cfg, step, scenario=False):
    if scenario:
        from repro_torch.data.pipeline import make_batch_for
        return make_batch_for(cfg, step, 32, 8, device="cpu")
    rng = np.random.default_rng(100 + step)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab,
                                        (GLOBAL_BATCH, SEQ + 1)))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def initial_state(case, shape):
    name, arch, dtype, opt, exact = case
    api, params = model_and_params(arch, dtype)
    # the f32 copies held to the logical step keep their error in f32
    tcfg = tcfg_of(opt, exact, "float32" if name.endswith("32")
                   else "bfloat16")
    return api, tcfg, ts.init_train_state(params, tcfg,
                                          multi_pod=shape[0] > 1)


def n_steps(case):
    return 12 if case[0] == "scenario" else STEPS


CHILD = r"""
import json, sys, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[5])
import test_torch_within_pod as t
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import train_step as ts
from repro_torch.train import within_pod as wp
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
shape = tuple(json.loads(sys.argv[6]))
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
mesh = make_production_mesh(shape=shape, device="cpu")
res = {}
for case in t.MESHES[shape]:
    api, tcfg, state = t.initial_state(case, shape)
    local = wp.shard_train_state(state, api.cfg, mesh)
    step = ts.make_train_step(api, tcfg, mesh=mesh)
    losses = []
    for s in range(t.n_steps(case)):
        local, m = step(local, t.batch_of(api.cfg, s, case[0] == "scenario"))
        losses.append(float(m["loss"]))
    res[case[0]] = {"state": local, "loss": losses}
if shape == (1, 2, 1):
    try:
        step(local, {k: v[:7] for k, v in t.batch_of(api.cfg, 0).items()})
        res["odd"] = None
    except ValueError as e:
        res["odd"] = str(e)
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
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(n)]
    kids = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(n), str(port), outs[r],
         here, str(list(shape))], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]
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
                                           batch_of(api.cfg, s))
        states = {c: r[0] for c, r in res.items()}
        losses.append(float(res[(0, 0, 0)][1]["loss"]))
    return states, losses


def _case(shape, name):
    return next(c for c in MESHES[shape] if c[0] == name)


def _plain(case):
    api, tcfg, state = initial_state(case, (1, 1, 1))
    step = ts.make_train_step(api, tcfg)
    losses = []
    for s in range(n_steps(case)):
        state, m = step(state, batch_of(api.cfg, s))
        losses.append(float(m["loss"]))
    return api, state, losses


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
        if shape[0] > 1:    # each pod keeps its own error feedback
            ef = [dict(tree_util.flatten_with_paths(states[(p, 0, 0)]["ef"]))
                  for p in range(2)]
            assert not all(torch.equal(ef[0][k], ef[1][k]) for k in ef[0])
    if shape == (1, 2, 1):
        assert got[0]["odd"] == ("a global batch of 7 rows does not divide "
                                 "over 2 data ranks")


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2), (1, 1, 4)])
def test_model_meshes_are_within_tolerance_of_plain_step(shape, tmp_path):
    got = _run(shape, tmp_path)
    sizes = dict(zip(AXES, shape))
    for case in MESHES[shape]:
        api, want, losses = _plain(case)
        for r in range(len(got)):
            np.testing.assert_allclose(got[r][case[0]]["loss"], losses,
                                       atol=LOSS_TOL, rtol=0)
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
    """Adafactor's factored moments and update RMS over "data" blocks: the
    mesh's parameters within PARAM_TOL of one process updating the whole
    leaves with the same gradients (the data ranks' mean as the mesh
    takes it, ``within_pod.pod_grads``).  The mesh-free ``plain_step``
    takes its gradients over the whole batch
    at once, and Adafactor's g / sqrt(v) turns their rounding into
    updates that differ by up to lr where a gradient is near zero."""
    runs = _run(shape, tmp_path)
    api, tcfg, state = initial_state(_case(shape, name), shape)
    losses = []
    for s in range(STEPS):
        grads, loss = wp.pod_grads(api, tcfg, state["params"],
                                   batch_of(api.cfg, s), 1, shape[1])
        state, _ = ts._apply_optimizer(state, grads[0], tcfg)
        losses.append(float(ts.pod_mean(loss[0])))
    np.testing.assert_allclose(runs[0][name]["loss"], losses, atol=LOSS_TOL,
                               rtol=0)
    got = {c: r[name]["state"] for r, c in zip(runs, _coords(shape))}
    full = _assembled_params(got, shape, api)
    for path, w in tree_util.flatten_with_paths(state["params"]):
        assert _max_err(full[path], w) <= PARAM_TOL, (path,)


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

