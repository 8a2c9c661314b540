"""Learning-rate schedules (port of ``repro.optim.schedules``): functions
of the integer step that return a Python float."""

from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: float(lr)


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        return lr * min(1.0, int(step) / max(1, warmup_steps))
    return f


def cosine_with_warmup(lr: float, warmup_steps: int, total_steps: int,
                       final_frac: float = 0.1):
    def f(step):
        s = int(step)
        if s < warmup_steps:
            return lr * min(1.0, s / max(1, warmup_steps))
        t = min(max((s - warmup_steps) / max(1, total_steps - warmup_steps),
                    0.0), 1.0)
        return lr * (final_frac
                     + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t)))
    return f
