"""Tensor parallelism inside a pod for the families beyond decoder-only
attention: rwkv6's channel mix, internvl2 (a vision frontend, attention
uncut, the FFN cut on d_ff), jamba (mamba blocks cut on d_inner, an
attention block, MoE blocks cut on E) and seamless (the encoder, and
the decoder's cross-attention cut on heads).

* Gloo ranks, each a child process on one torch thread, f32 smoke
  configs at 2 units: rwkv6 and seamless on (1, 1, 2), internvl2 and
  seamless on (1, 2, 2), jamba on (1, 1, 2), (1, 2, 2) and (1, 1, 4)
  (its 2 KV heads do not divide 4).  After 3 AdamW steps every
  parameter within ``PARAM_TOL``, every loss within ``LOSS_TOL`` and
  every gradient norm within ``NORM_TOL`` of the mesh-free
  ``plain_step`` (rwkv6's with its channel mix summed in the mesh's
  order, ``test_torch_within_pod.LOW_LR`` says why; three cases exempt
  the elements whose gradient is zero to rounding, see "zero_grad");
  every rank holds each leaf at its placed shape (a
  mamba ``in_proj`` [D / D_data, 2 Din / M]); jamba's and seamless's
  first losses within ``REF_LOSS_TOL`` of the reference's own
  ``loss_and_logits`` (JAX, CPU) on parameters carried across from its
  init.
* One mamba mixer at M = 2 and 4 with ranks as threads
  (``within_pod.ThreadComm``) against the whole mixer: the output and
  every leaf's gradient within ``BLOCK_TOL`` relative.  It names the
  two traps: a rank's regrouped ``in_proj`` is x_in's and z's column
  slice m, and the sum after ``x_proj`` sums its gradient too (an
  identity backward there gives gradients beyond the tolerance).
* On (1, 1, 2) and (1, 2, 2), every one of the eleven registered
  configs runs its forward and backward with every leaf at its placed
  "model" cut: no leaf is gathered over "model"."""

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_within_pod as base
from repro_torch import tree as tree_util
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.distributed.collectives import ordered_sum
from repro_torch.distributed.sharding import (assemble, local_shard,
                                              param_shardings,
                                              train_state_shardings)
from repro_torch.models import build
from repro_torch.models import mamba as mamba_mod
from repro_torch.train import train_step as ts
from repro_torch.train import within_pod as wp

AXES = base.AXES
STEPS = base.STEPS
BLOCK_TOL = 1e-5     # relative, f32: one mixer's output and gradients
FRONT_TOKENS = 8     # a smoke frontend's frames or patches

# mesh -> cases: (name, arch, dtype, optimizer, exact[, options]), as in
# ``test_torch_within_pod.MESHES``; "jax" carries the reference's init,
# "zero_grad" exempts from the parameter check the elements whose
# mesh-free gradient is zero to rounding (see
# :func:`test_families_on_model_meshes_match_plain_step`)
MESHES = {
    (1, 1, 2): [("rwkv", "rwkv6_3b", "float32", "adamw", False,
                 ("cm_order",)),
                ("jamba", "jamba_1_5_large_398b", "float32", "adamw", False,
                 ("jax", "zero_grad")),
                ("seamless", "seamless_m4t_medium", "float32", "adamw",
                 False, ("jax", "zero_grad"))],
    (1, 2, 2): [("internvl2", "internvl2_1b", "float32", "adamw", False),
                ("jamba", "jamba_1_5_large_398b", "float32", "adamw", False,
                 ("jax", "zero_grad")),
                ("seamless", "seamless_m4t_medium", "float32", "adamw",
                 False, ("jax",))],
    (1, 1, 4): [("jamba", "jamba_1_5_large_398b", "float32", "adamw",
                 False)],
}
CASES = [(sh, c[0]) for sh, cs in MESHES.items() for c in cs]
REF_CASES = [(sh, c[0]) for sh, c0 in MESHES.items() for c in c0
             if "jax" in base.opts(c)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch_of(cfg, step):
    """The step's global batch: ``test_torch_within_pod``'s tokens and
    targets, with a frontend's frames (enc-dec) or patch embeddings
    (vision) of the same rows."""
    out = base.batch_of(cfg, step)
    if cfg.frontend is not None:
        rng = np.random.default_rng(300 + step)
        emb = torch.as_tensor(rng.standard_normal(
            (base.GLOBAL_BATCH, FRONT_TOKENS, cfg.frontend.embed_dim)
        ).astype(np.float32))
        out["frames" if cfg.enc_n_units else "mm_embeds"] = emb
    return out


def initial_state(case):
    api, params = base.model_and_params(case[1], case[2], base.opts(case))
    tcfg = base.tcfg_of(case[3], case[4], "float32",
                        peak_lr=base.peak_lr_of(case))
    return api, tcfg, ts.init_train_state(params, tcfg)


CHILD = r"""
import json, sys, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[5])
import test_torch_within_pod as b
import test_torch_within_pod_families as t
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import train_step as ts
from repro_torch.train import within_pod as wp
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
shape = tuple(json.loads(sys.argv[6]))
b.PARAMS_DIR = sys.argv[7]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
mesh = make_production_mesh(shape=shape, device="cpu")
res = {}
for case in t.MESHES[shape]:
    api, tcfg, state = t.initial_state(case)
    local = wp.shard_train_state(state, api.cfg, mesh)
    step = ts.make_train_step(api, tcfg, mesh=mesh)
    losses, norms = [], []
    for s in range(b.STEPS):
        local, m = step(local, t.batch_of(api.cfg, s))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    res[case[0]] = {"state": local, "loss": losses, "grad_norm": norms}
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
    env = dict(os.environ, PYTHONPATH=base.SRC, OMP_NUM_THREADS="1")
    here = os.path.dirname(os.path.abspath(__file__))
    for case in MESHES[shape]:      # the carried parameters, for the ranks
        if "jax" in base.opts(case):
            torch.save(base.reference_params(case[1], case[2]),
                       base._params_file(tmp_path, case[1], case[2]))
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(n)]
    kids = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(n), str(port), outs[r],
         here, json.dumps(list(shape)), str(tmp_path)], env=env,
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


def _case(shape, name):
    return next(c for c in MESHES[shape] if c[0] == name)


@functools.lru_cache(maxsize=None)
def _plain(case, M):
    """The mesh-free step's final state, losses and gradient norms, and
    each parameter's elements whose gradient is zero to rounding at some
    step (not 0, at most ZERO_GRAD of its leaf's largest |gradient|);
    with "cm_order", rwkv's channel mix summed in the M parts of "model"
    (``test_torch_within_pod.channel_mix_in_parts``)."""
    api, tcfg, state = initial_state(case)
    step = ts.make_train_step(api, tcfg)
    losses, norms, tiny = [], [], {}
    with contextlib.ExitStack() as stack:
        if "cm_order" in base.opts(case):
            stack.enter_context(base.channel_mix_in_parts(M))
        for s in range(STEPS):
            batch = batch_of(api.cfg, s)
            _, grads = ts._microbatch_grads(api, state["params"], batch,
                                            tcfg.microbatches)
            for path, g in tree_util.flatten_with_paths(grads):
                t = (g != 0) & (g.abs() <= base.ZERO_GRAD * g.abs().max())
                tiny[path] = t | tiny.get(path, t)
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return api, state, losses, norms, tiny


def _param_errors(got, shape, name) -> dict:
    """{parameter: (largest |difference| of the held elements, elements
    exempt, largest |difference| of those, elements)} of the ranks'
    assembled parameters against the mesh-free step's.  A "zero_grad"
    case exempts the elements whose mesh-free gradient is zero to
    rounding at some step; every other case holds every element."""
    sizes = dict(zip(AXES, shape))
    case = _case(shape, name)
    api, want, _, _, tiny = _plain(case, shape[2])
    specs = dict(tree_util.flatten_with_paths(train_state_shardings(
        want, api.cfg, wp.AxisSizes(sizes))))
    blocks = {c: dict(tree_util.flatten_with_paths(r[name]["state"]))
              for r, c in zip(got, base._coords(shape))}
    flat = dict(tree_util.flatten_with_paths(want))
    out = {}
    for path, spec in specs.items():
        if not path.startswith("params/"):
            continue
        diff = (assemble({c: b[path] for c, b in blocks.items()}, spec,
                         sizes) - flat[path]).abs()
        free = (tiny[path[len("params/"):]] if "zero_grad" in
                base.opts(case) else torch.zeros_like(diff, dtype=bool))
        out[path] = (float(diff[~free].max()), int(free.sum()),
                     float(diff[free].max()) if free.any() else 0.0,
                     diff.numel())
    return out


@pytest.mark.parametrize("shape,name", CASES)
def test_families_on_model_meshes_match_plain_step(shape, name, tmp_path):
    """Every rank's losses within LOSS_TOL and gradient norms within
    NORM_TOL of the mesh-free step's, and the assembled parameters
    within PARAM_TOL of its parameters after 3 AdamW steps.  A
    "zero_grad" case (jamba on (1, 1, 2) and (1, 2, 2), seamless on
    (1, 1, 2): an element of the embedding parts from the mesh-free step
    by up to 9e-4; ``python tests/test_torch_within_pod_families.py``
    prints the readings of every case) exempts the elements whose
    mesh-free gradient is zero to rounding at some step (the rule of
    ``test_torch_within_pod``'s Adafactor check: AdamW's m / sqrt(v)
    turns such a gradient's rounding into an update of up to lr); they
    are under half of every leaf, and a gradient of exactly 0 (a token
    no batch holds) is held."""
    got = _run(shape, tmp_path)
    _, _, losses, norms, _ = _plain(_case(shape, name), shape[2])
    for r in got:
        np.testing.assert_allclose(r[name]["loss"], losses,
                                   atol=base.LOSS_TOL, rtol=0)
        np.testing.assert_allclose(r[name]["grad_norm"], norms,
                                   rtol=base.NORM_TOL, atol=0)
    for path, (err, n_free, _, n) in _param_errors(got, shape,
                                                   name).items():
        assert err <= base.PARAM_TOL, (name, path, err)
        assert 2 * n_free <= n, (name, path)     # a rule, not a leaf


@pytest.mark.parametrize("shape,name", CASES)
def test_family_ranks_hold_their_placed_blocks(shape, name, tmp_path):
    """Each rank's parameters and AdamW slots at their placed shapes;
    every leaf placed on "model" is cut M ways (a mamba ``in_proj`` is
    [D / D_data, 2 Din / M], rwkv's ``cm_Wk`` [D / D_data, d_ff / M])."""
    got = _run(shape, tmp_path)
    case = _case(shape, name)
    api, tcfg, _ = initial_state(case)
    sizes = wp.AxisSizes(dict(zip(AXES, shape)))
    meta = ts.init_train_state(api.init(device="meta"), tcfg)
    specs = dict(tree_util.flatten_with_paths(train_state_shardings(
        meta, api.cfg, sizes)))
    whole = dict(tree_util.flatten_with_paths(meta))
    cut = 0
    for r, c in zip(got, base._coords(shape)):
        for path, leaf in tree_util.flatten_with_paths(r[name]["state"]):
            want = local_shard(whole[path], specs[path], sizes,
                               dict(zip(AXES, c)))
            assert leaf.shape == want.shape, (c, path, leaf.shape)
            if "model" in specs[path]:
                dim = specs[path].index("model")
                assert leaf.shape[dim] * shape[2] == whole[path].shape[dim]
                cut += 1
            if path.endswith("mamba/in_proj"):
                D, two_din = whole[path].shape[1:]
                assert tuple(leaf.shape[1:]) == (D // shape[1],
                                                 two_din // shape[2])
    assert cut > 0


def _reference_loss(case) -> float:
    """The reference's ``loss_and_logits`` (JAX, CPU) of the first step's
    two microbatches on the carried parameters, averaged."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config as j_smoke
    from repro.models import Runtime
    from repro.models import build as j_build
    cfg = dataclasses.replace(j_smoke(case[1], n_units=2), dtype=case[2])
    api = j_build(cfg)
    params = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()),
        base.reference_params(case[1], case[2]))
    rt = Runtime(attn_chunk_q=16, attn_chunk_k=16, remat_policy="none")
    batch = {k: v.numpy() for k, v in batch_of(
        base.config_of(case[1], case[2]), 0).items()}
    rows = base.GLOBAL_BATCH // 2
    return float(np.mean([float(api.loss_and_logits(params, {
        k: jnp.asarray(v[i * rows:(i + 1) * rows])
        for k, v in batch.items()}, rt)[0]) for i in range(2)]))


@pytest.mark.parametrize("shape,name", REF_CASES)
def test_family_first_loss_is_the_references(shape, name, tmp_path):
    """The first step's loss (before any update) within REF_LOSS_TOL of
    the reference's own loss of the logical microbatches."""
    got = _run(shape, tmp_path)
    want = _reference_loss(_case(shape, name))
    for r in got:
        assert abs(r[name]["loss"][0] - want) <= base.REF_LOSS_TOL, (
            r[name]["loss"][0], want)


# ---------------------------------------------------------------------------
# One mamba mixer, ranks as threads
# ---------------------------------------------------------------------------


class _NoFAfterG(wp.TensorParallel):
    """Tensor parallelism with no f on what its g returned: the sum
    after mamba's ``x_proj`` with an identity backward (the trap)."""

    def reduce(self, out):
        self.summed = super().reduce(out)
        return self.summed

    def enter(self, h):
        return h if h is getattr(self, "summed", None) else super().enter(h)


class _ThreadRun:
    """The hooks one model rank's mamba mixer asks of a training mesh's
    ``run``, over :class:`within_pod.ThreadComm`; ``identity_x_proj``
    leaves the sum after ``x_proj`` with an identity backward (the
    trap)."""

    def __init__(self, comm, identity_x_proj=False):
        self.comm, self.coords = comm, comm.coords
        self.n_model = comm.sizes["model"]
        self.tp = (_NoFAfterG if identity_x_proj else wp.TensorParallel)(
            self)

    def model_sum(self, x):
        return ordered_sum(self.comm.gather(x, ("model",)))

    def model_all_to_all(self, send, to, frm):
        return self.comm.all_to_all(send, to, frm, "model")


def _mixer(M_units=1):
    cfg = get_smoke_config("jamba_1_5_large_398b", n_units=M_units)
    b = cfg.pattern[1]
    params = build(cfg).init(seed=3, device="cpu")
    p = tree_util.tree_map(lambda t: t[0], params["blocks"]["block1"]
                           ["mamba"])
    return cfg, b.mamba, p


def _mixer_grads(p, x, cot, mcfg, tp=None, regroup=None):
    """(out, {leaf: grad}) of one mixer forward over ``x`` with the
    cotangent ``cot``; ``regroup`` maps the placed ``in_proj`` to the
    one the rank runs."""
    req = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    with torch.enable_grad():
        used = dict(req)
        if regroup is not None:
            used["in_proj"] = regroup(req["in_proj"])
        out, _ = mamba_mod.mamba_forward(x, used, mcfg, tp=tp)
        leaves = [k for k in req if k != "norm"]
        grads = torch.autograd.grad((out * cot).sum(),
                                    [req[k] for k in leaves])
    return out.detach(), dict(zip(leaves, grads)), used["in_proj"].detach()


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.parametrize("M", [2, 4])
def test_mamba_mixer_on_model_threads_matches_the_whole_mixer(M):
    cfg, mcfg, p = _mixer()
    D = cfg.d_model
    Din = mcfg.expand * D
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((2, 72, D)).astype(np.float32))
    cot = torch.as_tensor(rng.standard_normal((2, 72, D)).astype(
        np.float32))
    want_out, want_g, _ = _mixer_grads(p, x, cot, mcfg)
    sizes = {"pod": 1, "data": 1, "model": M}
    specs = {k: param_shardings({"blocks": {"block1": {"mamba": {
        k: v[None]}}}}, cfg, wp.AxisSizes(sizes))["blocks"]["block1"][
        "mamba"][k][1:] for k, v in p.items()}

    def rank(coords, shards, trap=False):
        run = _ThreadRun(shards.comm, identity_x_proj=trap)
        mine = {k: local_shard(v, specs[k], wp.AxisSizes(sizes), coords)
                for k, v in p.items()}
        out, g, used = _mixer_grads(mine, x, cot, mcfg, tp=run.tp,
                                    regroup=lambda t: wp._Regroup.apply(
                                        t, run))
        return {"out": out, "grads": g, "used": used}

    res = wp.in_threads(sizes, rank)
    q = Din // M
    for c, r in res.items():
        m = c[2]
        assert _rel(r["out"], want_out) <= BLOCK_TOL, (m, "output")
        # trap 1: the regrouped in_proj is x_in's and z's slice m
        assert torch.equal(r["used"], torch.cat([
            p["in_proj"][:, m * q:(m + 1) * q],
            p["in_proj"][:, Din + m * q:Din + (m + 1) * q]], dim=1)), m
    for k, w in want_g.items():
        full = assemble({c: r["grads"][k] for c, r in res.items()},
                        specs[k], sizes)
        assert _rel(full, w) <= BLOCK_TOL, (M, k, _rel(full, w))
    # trap 2: an identity backward after x_proj leaves each rank only its
    # own part of that sum's gradient
    bad = wp.in_threads(sizes, functools.partial(rank, trap=True))
    full = assemble({c: r["grads"]["in_proj"] for c, r in bad.items()},
                    specs["in_proj"], sizes)
    assert _rel(full, want_g["in_proj"]) > 100 * BLOCK_TOL


# ---------------------------------------------------------------------------
# Every registered config: no leaf gathered over "model"
# ---------------------------------------------------------------------------


class _StubMesh:
    """A mesh's axis sizes and this rank's coordinates (rank 0 of
    each), with no process group."""

    def __init__(self, sizes):
        self.shape = dict(sizes)

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


class _StubRun(wp.PodRun):
    """:class:`within_pod.PodRun` of model rank 0 whose collectives
    keep only the shapes (a sum is the rank's part, a gather repeats
    it), so one process runs a rank's forward and backward at its
    placed shapes; every leaf gather is recorded."""

    def __init__(self, cfg, mesh, specs, record):
        super().__init__(cfg, mesh, specs)
        self.record = record
        self._lookup = lambda table, tokens: table[tokens % table.shape[0]]

    def model_gather(self, x):
        return x[None].expand((self.n_model,) + tuple(x.shape))

    def model_sum(self, x):
        return x.clone()

    def model_all_to_all(self, send, to, frm):
        return send

    def data_total(self, t):
        return t

    def reduce_grad(self, g, cuts, partial):
        for dim, axis in cuts:
            g = g.narrow(dim, 0, g.shape[dim] // self.sizes[axis])
        return g.contiguous()


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_no_leaf_is_gathered_over_model(arch, shape, monkeypatch):
    cfg = get_smoke_config(arch, n_units=1)
    api = build(cfg)
    sizes = dict(zip(AXES, shape))
    mesh = _StubMesh(sizes)
    params = api.init(seed=0, device="cpu")
    specs = param_shardings(params, cfg, mesh)
    record = []

    def gather_dim(t, dim, run, axis):
        record.append(axis)
        return torch.cat([t] * run.sizes[axis], dim=dim).contiguous()

    monkeypatch.setattr(wp, "_gather_dim", gather_dim)
    run = _StubRun(cfg, mesh, specs, record)
    assert run.tp is not None
    local = tree_util.tree_map(
        lambda t, s: local_shard(t, s, mesh, {a: 0 for a in AXES}),
        params, specs)
    flat = dict(tree_util.flatten_with_paths(specs))
    cut = [p for p, s in flat.items() if "model" in s]
    assert cut, arch
    batch = {k: v[:2] for k, v in batch_of(cfg, 0).items()}
    loss, grads = ts.value_and_grad(
        lambda q, mb: api.loss_and_logits(q, mb, run=run)[0], local, batch)
    assert torch.isfinite(loss)
    assert "model" not in record and (shape[1] == 1 or "data" in record)
    for p, g in tree_util.flatten_with_paths(grads):
        assert g.shape == dict(tree_util.flatten_with_paths(local))[
            p].shape, p


if __name__ == "__main__":
    # every mesh case's parameter readings (the largest difference held,
    # and the elements exempt and their largest difference), then the
    # rwkv witness; PYTHONPATH=src python tests/<this file>
    import pathlib
    import tempfile
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as where:
        for shape, cases in MESHES.items():
            got = _spawn(shape, pathlib.Path(where))
            for case in cases:
                errs = _param_errors(got, shape, case[0]).values()
                print(shape, case[0], "held %.3e" % max(e[0] for e in errs),
                      "exempt %d of %d, largest %.3e" % (
                          sum(e[1] for e in errs), sum(e[3] for e in errs),
                          max(e[2] for e in errs)))
    # the rwkv witness (``test_torch_within_pod``'s): the mesh-free step
    # with its channel mix in (1, 2, 2)'s two parts against the whole-sum
    for lr in ((), ("low_lr",)):
        whole, parts = (base._plain(("w", "rwkv6_3b", "float32", "adamw",
                                     False, lr + o), (1, 2, 2))
                        for o in ((), ("cm_order",)))
        print("rwkv6 channel mix in 2 parts, peak lr %g: apart %.3e" % (
            base.peak_lr_of(("w",) * 5 + (lr,)),
            base._params_apart(parts[1], whole[1])))
