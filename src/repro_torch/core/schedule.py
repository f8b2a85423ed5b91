"""Learning-rate schedules (port of ``repro/core/schedule.py``).

A schedule maps the integer step to a learning rate.  The arithmetic runs
in numpy float32 on the host, matching the reference's float32 device
math; the knee-point scheduler needs the loss and arrives with MKOR-H."""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

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
