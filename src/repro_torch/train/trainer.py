"""Training loop with checkpoint/restart fault tolerance and straggler
monitoring (port of ``repro/train/trainer.py``).  The loop is
restart-idempotent: state lives in (checkpoint, step) only, and the data
pipeline is a pure function of the step, so a restored run replays the
identical token stream."""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

from repro_torch import tree as tree_util
from repro_torch.checkpoint import manager as ckpt
from repro_torch.data.pipeline import make_batch_for
from repro_torch.distributed.fault import (FailureInjector, SimulatedFailure,
                                           StragglerMonitor)
from repro_torch.train.train_step import TrainConfig, init_train_state


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    seq_len: int = 64
    global_batch: int = 8
    task_id: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 20
    log_every: int = 10
    max_restarts: int = 5


def train_loop(api, tcfg: TrainConfig, lcfg: LoopConfig, step_fn: Callable,
               injector: Optional[FailureInjector] = None, state=None,
               log: Callable = print, device="cuda") -> tuple[dict, list]:
    """Runs (or resumes) training.  Returns (final_state, history).

    Without ``state`` the parameters are ``api.init(seed=0)`` on
    ``device``; otherwise the state's own device is used.  On
    :class:`SimulatedFailure` the loop restores the latest checkpoint and
    replays from its step, as a relaunched job would.  A step's time is
    taken once its loss is on the host (the card runs asynchronously).
    """
    cfg = api.cfg

    def fresh_state(dev):
        params = api.init(seed=0, device=dev)
        return init_train_state(params, tcfg, multi_pod=False)

    if state is None:
        state = fresh_state(device)
    dev = tree_util.leaves(state["params"])[0].device

    start = 0
    if lcfg.ckpt_dir:
        last = ckpt.latest_step(lcfg.ckpt_dir)
        if last is not None:
            state = ckpt.restore(state, lcfg.ckpt_dir, last, device=dev)
            start = int(last)
            log(f"[trainer] resumed from step {start}")

    history: list = []
    monitor = StragglerMonitor()
    restarts = 0
    step = start
    while step < lcfg.total_steps:
        try:
            batch = make_batch_for(cfg, step, lcfg.seq_len,
                                   lcfg.global_batch, lcfg.task_id,
                                   device=dev)
            if injector is not None:
                injector.check(step)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            monitor.observe(step, dt)
            if not math.isfinite(loss):
                raise RuntimeError(f"non-finite loss at step {step}")
            history.append({"step": step, "loss": loss, "sec": dt})
            if step % lcfg.log_every == 0:
                log(f"[trainer] step {step:5d} loss {loss:.4f} "
                    f"({dt*1e3:.0f} ms) straggler={monitor.recommendation()}")
            step += 1
            if lcfg.ckpt_dir and step % lcfg.ckpt_every == 0:
                ckpt.save(state, lcfg.ckpt_dir, step)
        except SimulatedFailure as e:
            restarts += 1
            if restarts > lcfg.max_restarts or not lcfg.ckpt_dir:
                raise
            last = ckpt.latest_step(lcfg.ckpt_dir)
            if last is None:  # no checkpoint yet -> cold restart
                state = fresh_state(dev)
                step = 0
            else:
                state = ckpt.restore(state, lcfg.ckpt_dir, last, device=dev)
                step = int(last)
            log(f"[trainer] {e}; restored to step {step} "
                f"(restart {restarts}/{lcfg.max_restarts})")
    if lcfg.ckpt_dir:
        ckpt.save(state, lcfg.ckpt_dir, step)
    return state, history
