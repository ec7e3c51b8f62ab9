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

The multi-pod step, whose gradients cross pods as packed ternary planes
(:mod:`repro_torch.core.gradient_compression`), comes with serving and
training across several GPUs (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Callable

import torch

from repro_torch import tree as tree_util
from repro_torch.core.gradient_compression import GradCompressionConfig
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


def _microbatch_grads(api, params, batch, n_micro: int):
    """Accumulated (mean) grads + loss over n_micro sequential
    microbatches (the sums in f32)."""

    def loss_fn(p, mb):
        loss, _ = api.loss_and_logits(p, mb)
        return loss

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


def _apply_optimizer(state, grads, tcfg: TrainConfig):
    lr = _lr(state["step"], tcfg)
    if tcfg.optimizer == "adamw":
        new_params, new_opt, metrics = adamw.update(
            grads, state["opt"], state["params"], lr, tcfg.adamw)
    else:
        new_params, new_opt, metrics = adafactor.update(
            grads, state["opt"], state["params"], lr, tcfg.adafactor)
    out = dict(state)
    out["params"] = new_params
    out["opt"] = new_opt
    out["step"] = state["step"] + 1
    metrics["lr"] = lr
    return out, metrics


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None
                 else getattr(mesh, "axis_names", ()))


def make_train_step(api, tcfg: TrainConfig, mesh=None) -> Callable:
    """-> step_fn(state, batch) -> (new_state, metrics).

    ``batch`` leaves have the global batch at dim 0 and lie on the
    parameters' device.  A ``mesh`` with a ``"pod"`` axis and compression
    enabled asks for the compressed multi-pod step, which is not ported
    yet."""
    if (mesh is not None and "pod" in _axis_names(mesh)
            and tcfg.grad_compression.enabled):
        raise NotImplementedError(
            "the compressed multi-pod train step comes with training "
            "across several GPUs (ROADMAP queue 1, item 10)")

    def plain_step(state, batch):
        dev = tree_util.leaves(state["params"])[0].device
        with deterministic(dev):
            loss, grads = _microbatch_grads(api, state["params"], batch,
                                            tcfg.microbatches)
            new_state, metrics = _apply_optimizer(state, grads, tcfg)
        metrics["loss"] = loss
        return new_state, metrics

    return plain_step
