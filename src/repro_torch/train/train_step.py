"""Train step: microbatch gradient accumulation through autograd and a
pluggable optimizer (AdamW / Adafactor); port of
``repro/train/train_step.py``.

The reference takes ``jax.grad`` of its jnp forward; no Pallas kernel
runs on its training path, so the port takes autograd through its own
forward (cuBLAS products on the card).  On the card the step runs under
``torch.use_deterministic_algorithms(True)`` (with
``CUBLAS_WORKSPACE_CONFIG`` set): the gradients of the embedding lookup
and of the loss's gather would otherwise accumulate with atomics, and a
restarted run must replay its steps bit for bit.

A training mesh (``make_train_step(mesh=)``, axes ("pod", "data",
"model")) runs SPMD by process, one rank a process holding its blocks of
the state (:mod:`repro_torch.train.within_pod`): each rank takes its rows
of the global batch, "data" is FSDP, "model" tensor parallelism for the
dense family, and the gradients cross pods as packed ternary planes with
error feedback, each rank compressing its block with the logical leaf's
threshold and scale.  On a mesh of pods alone, one rank a pod, that is
:func:`repro_torch.core.gradient_compression.compressed_cross_pod_mean`
leaf for leaf; :func:`pods_in_one_process` is its plain version on
whole leaves.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable

import torch

from repro_torch import tree as tree_util
from repro_torch.core.gradient_compression import (
    GradCompressionConfig, _unpack_planes, compress_leaf_for_allgather)
from repro_torch.models.common import _DTYPES
from repro_torch.optim import adafactor, adamw, schedules

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    optimizer: str = "adamw"            # adamw | adafactor
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "warmup_cosine"
    adamw: adamw.AdamWConfig = adamw.AdamWConfig()
    adafactor: adafactor.AdafactorConfig = adafactor.AdafactorConfig()
    grad_compression: GradCompressionConfig = GradCompressionConfig(
        enabled=True, density=0.05)
    ef_dtype: str = "bfloat16"


def init_train_state(params: PyTree, tcfg: TrainConfig,
                     multi_pod: bool = False) -> dict:
    if tcfg.optimizer == "adamw":
        opt = adamw.init(params, tcfg.adamw)
    else:
        opt = adafactor.init(params, tcfg.adafactor)
    dev = tree_util.leaves(params)[0].device
    state = {"params": params, "opt": opt,
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if multi_pod and tcfg.grad_compression.enabled:
        state["ef"] = tree_util.tree_map(
            lambda p: torch.zeros(p.shape, dtype=_DTYPES[tcfg.ef_dtype],
                                  device=p.device), params)
    return state


def _lr(step, tcfg: TrainConfig):
    fn = getattr(schedules, tcfg.schedule)
    return fn(step, peak_lr=tcfg.peak_lr, warmup_steps=tcfg.warmup_steps,
              total_steps=tcfg.total_steps)


@contextlib.contextmanager
def deterministic(device):
    """``torch.use_deterministic_algorithms(True)`` on a CUDA device (the
    previous mode restored after); nothing on the CPU, whose kernels
    accumulate in a fixed order."""
    if torch.device(device).type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=prev_warn)


def value_and_grad(loss_fn: Callable, params: PyTree, *args):
    """(loss, grads) of ``loss_fn(params, *args)`` (a 0-d tensor) by
    autograd; grads mirror ``params`` (zeros for an unused leaf)."""
    req = tree_util.tree_map(lambda p: p.detach().requires_grad_(True),
                             params)
    leaves = tree_util.leaves(req)
    with torch.enable_grad():
        loss = loss_fn(req, *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_util.unflatten_like(req, grads)


def _microbatch_grads(api, params, batch, n_micro: int, run=None):
    """Accumulated (mean) grads + loss over n_micro sequential
    microbatches (the sums in f32).  ``run``: a training mesh's
    (:class:`repro_torch.train.within_pod.PodRun`); ``params`` are then
    this rank's blocks, and so are the gradients."""

    def loss_fn(p, mb):
        if run is None:
            return api.loss_and_logits(p, mb)[0]
        return api.loss_and_logits(p, mb, run=run)[0]

    if n_micro == 1:
        return value_and_grad(loss_fn, params, batch)

    micro = tree_util.tree_map(
        lambda x: x.reshape((n_micro, x.shape[0] // n_micro)
                            + tuple(x.shape[1:])), batch)
    acc = tree_util.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    lsum = torch.zeros((), dtype=torch.float32,
                       device=tree_util.leaves(params)[0].device)
    for i in range(n_micro):
        mb = tree_util.tree_map(lambda x: x[i], micro)  # noqa: B023
        l, g = value_and_grad(loss_fn, params, mb)
        acc = tree_util.tree_map(lambda a, b: a + b.to(torch.float32), acc, g)
        lsum = lsum + l
    inv = 1.0 / n_micro
    grads = tree_util.tree_map(lambda g: g * inv, acc)
    return lsum * inv, grads


def _apply_optimizer(state, grads, tcfg: TrainConfig, shards=None,
                     specs=None):
    lr = _lr(state["step"], tcfg)
    if tcfg.optimizer == "adamw":
        new_params, new_opt, metrics = adamw.update(
            grads, state["opt"], state["params"], lr, tcfg.adamw,
            shards=shards, specs=specs)
    else:
        new_params, new_opt, metrics = adafactor.update(
            grads, state["opt"], state["params"], lr, tcfg.adafactor,
            shards=shards, specs=specs)
    out = dict(state)
    out["params"] = new_params
    out["opt"] = new_opt
    out["step"] = state["step"] + 1
    metrics["lr"] = lr
    return out, metrics


def pod_mean(values: list) -> torch.Tensor:
    """The mean of the pods' values, summed in rank order."""
    acc = values[0]
    for v in values[1:]:
        acc = acc + v
    return acc / len(values)


def pods_in_one_process(api, tcfg: TrainConfig, state: dict, efs: list,
                        batch: PyTree, data: int = 1) -> tuple:
    """The compressed multi-pod step of ``len(efs)`` pods in one process on
    whole leaves, the plain version the mesh's step is held to: each pod's
    gradients on its slice (the rank-order mean of its ``data`` data
    ranks' gradients on their rows, as the mesh computes them,
    :func:`repro_torch.train.within_pod.pod_grads`), every leaf
    compressed with the pod's error state as
    :func:`compressed_cross_pod_mean` does (the logical leaf's threshold
    and scale) and the reconstructions summed in pod order, one update
    of the logical state.  -> (new state, new error states, mean loss
    over the pods' data ranks, planes), ``planes[p]`` pod ``p``'s (pos,
    neg, scale) per leaf in the order the step compresses them."""
    from repro_torch.train.within_pod import pod_grads
    n_pods = len(efs)
    dev = tree_util.leaves(state["params"])[0].device
    planes = [[] for _ in range(n_pods)]

    def leaf(*ge):
        gs, es = ge[:n_pods], ge[n_pods:]
        g0 = gs[0]
        n_last = g0.shape[-1] if g0.ndim else 1
        acc = torch.zeros(g0.shape if g0.ndim else (1,), dtype=torch.float32,
                          device=g0.device)
        errs = []
        for p, (g, e) in enumerate(zip(gs, es)):
            pos, neg, scale, err = compress_leaf_for_allgather(
                g if g.ndim else g.reshape(1), e if e.ndim else e.reshape(1),
                tcfg.grad_compression)
            planes[p].append((pos, neg, scale))
            errs.append(err.to(e.dtype).reshape(e.shape))
            acc = acc + _unpack_planes(pos, neg, n_last) * scale
        return (acc / n_pods).reshape(g0.shape).to(g0.dtype), errs

    grads, losses = pod_grads(api, tcfg, state["params"], batch, n_pods,
                              data)
    with deterministic(dev):
        out = tree_util.tree_map(leaf, *grads, *efs)
        new_state, _ = _apply_optimizer(
            state, tree_util.tree_map(lambda o: o[0], out), tcfg)
    errs = tree_util.tree_map(lambda o: o[1], out)
    new_efs = [tree_util.tree_map(lambda es, p=p: es[p], errs)
               for p in range(n_pods)]
    return (new_state, new_efs, pod_mean([x for pod in losses for x in pod]),
            planes)


def make_train_step(api, tcfg: TrainConfig, mesh=None) -> Callable:
    """-> step_fn(state, batch) -> (new_state, metrics).

    ``batch`` leaves have the global batch at dim 0 and lie on the
    parameters' device.  Without a ``mesh`` the step runs on one device.
    A training ``mesh`` (:func:`repro_torch.launch.mesh.
    make_production_mesh`: ("pod", "data", "model")) gives the step of
    one of its ranks (:func:`repro_torch.train.within_pod.
    make_within_pod_step`): every rank calls it with the same global
    batch and its blocks of the state
    (:func:`repro_torch.train.within_pod.shard_train_state`; on a mesh of
    pods alone, the whole state).  A multi-pod state
    (``init_train_state(multi_pod=True)``, its ``"ef"`` the rank's error
    feedback) with compression enabled exchanges the gradients across
    pods compressed."""
    if mesh is not None:
        from repro_torch.train.within_pod import make_within_pod_step
        return make_within_pod_step(api, tcfg, mesh)

    def plain_step(state, batch):
        dev = tree_util.leaves(state["params"])[0].device
        with deterministic(dev):
            loss, grads = _microbatch_grads(api, state["params"], batch,
                                            tcfg.microbatches)
            new_state, metrics = _apply_optimizer(state, grads, tcfg)
        metrics["loss"] = loss
        return new_state, metrics

    return plain_step
