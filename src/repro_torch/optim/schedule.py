"""LR schedules: functions of the step (an int or a tensor) that return an
f32 scalar tensor on the CPU, with the reference's arithmetic
(``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).cpu()


def constant_schedule(lr: float):
    return lambda step: _f32(lr)


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup from 0 to ``peak`` over ``warmup`` steps, then a
    cosine from ``peak`` down to ``floor * peak`` at ``total``."""
    def fn(step):
        step = _f32(step)
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return fn


def paper_step_schedule(base: float, drops: tuple, steps_per_epoch: int):
    """The paper's x0.1-at-epoch schedule, expressed per optimizer step."""
    def fn(step):
        epoch = torch.as_tensor(step) // max(steps_per_epoch, 1)
        out = _f32(base)
        for e in drops:
            out = torch.where(epoch >= e, out * 0.1, out)
        return out

    return fn
