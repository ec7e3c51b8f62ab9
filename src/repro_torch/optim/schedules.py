"""LR schedules (port of ``repro/optim/schedules.py``): a 0-d int step
tensor -> a 0-d f32 learning rate on the step's device, computed in f32
as the reference computes it."""

from __future__ import annotations

import math

import torch


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = _f32(peak_lr, s) * s / _f32(max(warmup_steps, 1), s)
    prog = torch.clamp((s - _f32(warmup_steps, s))
                       / _f32(max(total_steps - warmup_steps, 1), s),
                       0.0, 1.0)
    cos = _f32(peak_lr, s) * (_f32(final_frac, s) + _f32(
        (1 - final_frac) * 0.5, s) * (1.0 + torch.cos(_f32(math.pi, s)
                                                      * prog)))
    return torch.where(s < warmup_steps, warm, cos)


def constant(step: torch.Tensor, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(step, peak_lr, dtype=torch.float32)
