"""The port's compressed multi-pod train step on gloo ranks, one rank a
pod: 3 AdamW steps on 2 and on 4 pods, each rank taking its slice of the
global batch.  Parameters, every pod's error feedback, the gradient
planes each pod gathered and the loss must be bitwise a one-process
oracle (``train_step.pods_in_one_process``) that computes each pod's
gradients on its slice in turn and runs the same compression and
rank-order mean.  A global batch that does not divide over the pods
raises.  Meshes with a "data" or "model" axis above 1 ((1, 2, 1),
(2, 1, 2), (1, 1, 2)) run the step inside a pod on the rank's blocks of
the state (``tests/test_torch_within_pod.py`` holds it to its oracle and
to the mesh-free step)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_util
from repro_torch.configs import get_smoke_config
from repro_torch.core import gradient_compression as gc
from repro_torch.models import build
from repro_torch.train import train_step as ts

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
STEPS = 3
GLOBAL_BATCH, SEQ = 8, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcfg():
    return ts.TrainConfig(
        microbatches=2, peak_lr=5e-3, warmup_steps=2, total_steps=50,
        grad_compression=gc.GradCompressionConfig(enabled=True, density=0.3))


def _batch(step: int) -> dict:
    rng = np.random.default_rng(100 + step)
    toks = torch.as_tensor(rng.integers(1, 512, (GLOBAL_BATCH, SEQ + 1)))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


CHILD = r"""
import json, sys, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[5])
import test_torch_multipod as t
from repro_torch.core import gradient_compression as gc
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import train_step as ts
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
rows = int(sys.argv[6])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
if len(sys.argv) > 7:       # a mesh inside a pod: one step on the blocks
    from repro_torch.train import within_pod as wp
    shape = tuple(json.loads(sys.argv[7]))
    mesh = make_production_mesh(shape=shape, device="cpu")
    api, params = t.model_and_params()
    tcfg = t._tcfg()
    state = wp.shard_train_state(
        ts.init_train_state(params, tcfg, multi_pod=shape[0] > 1), api.cfg,
        mesh)
    state, m = ts.make_train_step(api, tcfg, mesh=mesh)(state, t._batch(0))
    torch.save({"state": state, "loss": float(m["loss"])}, out)
    dist.destroy_process_group()
    sys.exit(0)
planes = []
inner = gc.compress_leaf_for_allgather
def record(g, e, cfg):
    out_ = inner(g, e, cfg)
    planes.append([x.clone() for x in out_[:3]])
    return out_
gc.compress_leaf_for_allgather = record
api, params = t.model_and_params()
tcfg = t._tcfg()
state = ts.init_train_state(params, tcfg, multi_pod=True)
step = ts.make_train_step(api, tcfg, mesh=make_production_mesh(
    multi_pod=True, device="cpu"))
if rows != t.GLOBAL_BATCH:
    try:
        step(state, {k: v[:rows] for k, v in t._batch(0).items()})
        msg = None
    except ValueError as e:
        msg = str(e)
    with open(out, "w") as f:
        json.dump({"error": msg}, f)
    dist.destroy_process_group()
    sys.exit(0)
losses = []
for s in range(t.STEPS):
    state, m = step(state, t._batch(s))
    losses.append(m["loss"])
torch.save({"params": state["params"], "ef": state["ef"], "loss": losses,
            "planes": planes}, out)
dist.destroy_process_group()
"""


def model_and_params():
    api = build(get_smoke_config("qwen2_5_3b", n_units=1))
    return api, api.init(seed=0, device="cpu")


def _oracle(n_pods: int) -> dict:
    """The multi-pod step's one-process version over the same steps."""
    api, params = model_and_params()
    tcfg = _tcfg()
    state = ts.init_train_state(params, tcfg, multi_pod=True)
    efs = [state["ef"]] * n_pods
    losses, planes = [], [[] for _ in range(n_pods)]
    for s in range(STEPS):
        state, efs, loss, step_planes = ts.pods_in_one_process(
            api, tcfg, state, efs, _batch(s))
        losses.append(loss)
        for p in range(n_pods):
            planes[p].extend(step_planes[p])
    return {"params": state["params"], "ef": efs, "loss": losses,
            "planes": planes}


def _equal_trees(a, b):
    fa, fb = (dict(tree_util.flatten_with_paths(t)) for t in (a, b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k], fb[k]), k


def _run_pods(n_pods: int, tmp_path, rows: int = GLOBAL_BATCH,
              shape=None) -> list:
    """Run ``CHILD`` on ``n_pods`` gloo ranks (a mesh ``shape`` of as
    many ranks when given) -> their output files."""
    from mesh_cases import free_port
    port = free_port()
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    here = os.path.dirname(os.path.abspath(__file__))
    outs = [str(tmp_path / f"pod{r}.out") for r in range(n_pods)]
    kids = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(n_pods), str(port),
         outs[r], here, str(rows)] + ([json.dumps(list(shape))] if shape
                                      else []), env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n_pods)]
    try:
        for p in kids:
            _, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in kids:
            if p.poll() is None:
                p.kill()
    return outs


@pytest.mark.parametrize("n_pods", [2, 4])
def test_compressed_multipod_step_is_bitwise_the_oracle(n_pods, tmp_path):
    outs = _run_pods(n_pods, tmp_path)
    want = _oracle(n_pods)
    for r in range(n_pods):
        got = torch.load(outs[r])
        _equal_trees(got["params"], want["params"])
        _equal_trees(got["ef"], want["ef"][r])
        assert [float(x) for x in got["loss"]] == \
            [float(x) for x in want["loss"]]
        assert len(got["planes"]) == len(want["planes"][r])
        for g, w in zip(got["planes"], want["planes"][r]):
            for x, y in zip(g, w):
                assert torch.equal(x, y)
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_util.leaves(want["ef"][0]), tree_util.leaves(want["ef"][1])))


def test_a_batch_that_does_not_divide_over_the_pods_raises(tmp_path):
    """7 rows on 2 pods: every rank refuses the step rather than drop a
    row; the one-process version refuses it alike."""
    for out in _run_pods(2, tmp_path, rows=GLOBAL_BATCH - 1):
        with open(out) as f:
            assert json.load(f)["error"] == (
                "a global batch of 7 rows does not divide over 2 pods")
    api, params = model_and_params()
    state = ts.init_train_state(params, _tcfg(), multi_pod=True)
    odd = {k: v[:GLOBAL_BATCH - 1] for k, v in _batch(0).items()}
    with pytest.raises(ValueError, match="does not divide over 2 pods"):
        ts.pods_in_one_process(api, _tcfg(), state, [state["ef"]] * 2, odd)


@pytest.mark.parametrize("shape", [(1, 2, 1), (2, 1, 2), (1, 1, 2)])
def test_inner_pod_axes_run_the_step_on_the_blocks(shape, tmp_path):
    """One step on each mesh: every rank reports the same finite loss
    and holds its blocks of the state as ``train_state_shardings``
    places them."""
    from repro_torch.train import within_pod as wp
    n = int(np.prod(shape))
    outs = _run_pods(n, tmp_path, shape=shape)
    api, params = model_and_params()
    state = ts.init_train_state(params, _tcfg(), multi_pod=shape[0] > 1)
    sizes = wp.AxisSizes(dict(zip(("pod", "data", "model"), shape)))
    coords = wp._coords(sizes.shape)
    got = [torch.load(o) for o in outs]
    assert np.isfinite(got[0]["loss"])
    for r, res in enumerate(got):
        assert res["loss"] == got[0]["loss"]
        want = wp.shard_train_state(state, api.cfg, sizes,
                                    dict(zip(sizes.shape, coords[r])))
        for (p, a), (_, b) in zip(
                tree_util.flatten_with_paths(res["state"]),
                tree_util.flatten_with_paths(want)):
            assert a.shape == b.shape and a.dtype == b.dtype, p
            assert torch.isfinite(a.float()).all(), p


def test_pod_mean_sums_in_rank_order():
    vals = [torch.tensor(1e8), torch.tensor(1.0), torch.tensor(-1e8)]
    assert float(ts.pod_mean(vals)) == float((vals[0] + vals[1] + vals[2])
                                             / 3)
