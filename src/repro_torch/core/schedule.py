"""Learning-rate schedules (port of ``repro/core/schedule.py``).

A schedule maps the integer step to a learning rate.  The arithmetic runs
in numpy float32 on the host, matching the reference's float32 device
math.  The knee-point scheduler (paper §8.13) reads the loss, so its state
is 0-d float32 tensors on the loss's device, updated with the reference's
order of operations (no host read)."""
from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]
_f32 = np.float32


def constant(lr: float) -> Schedule:
    value = float(_f32(lr))
    return lambda step: value


def warmup_linear(peak: float, warmup: int, total: int,
                  floor: float = 0.0) -> Schedule:
    def f(step):
        s = _f32(step)
        wu = _f32(peak) * s / _f32(max(warmup, 1))
        frac = np.clip((s - _f32(warmup)) / _f32(max(total - warmup, 1)),
                       _f32(0), _f32(1))
        dec = _f32(peak) + _f32(floor - peak) * frac
        return float(wu if s < warmup else dec)
    return f


def warmup_cosine(peak: float, warmup: int, total: int,
                  floor: float = 0.0) -> Schedule:
    def f(step):
        s = _f32(step)
        wu = _f32(peak) * s / _f32(max(warmup, 1))
        frac = np.clip((s - _f32(warmup)) / _f32(max(total - warmup, 1)),
                       _f32(0), _f32(1))
        dec = _f32(floor) + _f32(peak - floor) * _f32(0.5) * (
            _f32(1) + np.cos(_f32(math.pi) * frac))
        return float(wu if s < warmup else dec)
    return f


def wsd(peak: float, warmup: int, stable: int, decay: int,
        floor_frac: float = 0.1) -> Schedule:
    """Warmup-Stable-Decay (MiniCPM): linear warmup, constant plateau,
    cosine decay to ``floor_frac * peak``."""
    floor = peak * floor_frac

    def f(step):
        s = _f32(step)
        wu = _f32(peak) * s / _f32(max(warmup, 1))
        frac = np.clip((s - _f32(warmup + stable)) / _f32(max(decay, 1)),
                       _f32(0), _f32(1))
        dec = _f32(floor) + _f32(peak - floor) * _f32(0.5) * (
            _f32(1) + np.cos(_f32(math.pi) * frac))
        if s < warmup:
            return float(wu)
        return float(_f32(peak)) if s < warmup + stable else float(dec)
    return f


def step_decay(base: float, boundaries: Sequence[int],
               factor: float = 0.5) -> Schedule:
    """Multiply by ``factor`` at each boundary the step has reached."""
    bs = list(boundaries)

    def f(step):
        n = sum(step >= b for b in bs)
        return float(_f32(base) * _f32(factor) ** _f32(n))
    return f


# ----------------------------------------------------------------------- #
# Knee-point scheduler (paper §8.13)
# ----------------------------------------------------------------------- #
def kneepoint_init(base_lr: float, device=None) -> Dict[str, torch.Tensor]:
    def full(v):
        return torch.full((), v, dtype=torch.float32, device=device)
    return {"lr": full(base_lr),
            "ema_rate": full(0.0),           # EMA of the per-step drop
            "loss_prev": full(math.inf),
            "loss_at_lr": full(math.inf),    # the loss when lr was set
            "steps_at_lr": full(0.0)}


def kneepoint_update(state: Dict[str, torch.Tensor], loss: torch.Tensor, *,
                     beta: float = 0.1, ema: float = 0.95,
                     decay_factor: float = 0.5,
                     min_steps: int = 20) -> Dict[str, torch.Tensor]:
    """Knee-point: decay when the EMA'd loss-decrease rate falls below
    ``beta`` x the average decrease since the current LR was set."""
    loss = loss.float()
    zero = torch.zeros((), dtype=torch.float32, device=loss.device)
    first = torch.isinf(state["loss_prev"])
    drop = torch.where(first, zero, state["loss_prev"] - loss)
    ema_rate = torch.where(first, zero,
                           ema * state["ema_rate"] + (1 - ema) * drop)
    steps = state["steps_at_lr"] + 1.0
    loss_at = torch.where(torch.isinf(state["loss_at_lr"]), loss,
                          state["loss_at_lr"])
    avg_since = (loss_at - loss) / torch.clamp(steps, min=1.0)
    knee = (steps > min_steps) & (ema_rate
                                  < beta * torch.clamp(avg_since, min=0.0))
    return {"lr": torch.where(knee, state["lr"] * decay_factor,
                              state["lr"]),
            "ema_rate": torch.where(knee, zero, ema_rate),
            "loss_prev": loss,
            "loss_at_lr": torch.where(knee, loss, loss_at),
            "steps_at_lr": torch.where(knee, zero, steps)}
