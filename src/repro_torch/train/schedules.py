"""LR schedules (paper Appendix C/D: warmup = 0.03·total, cosine decay).

Counterpart of ``repro.train.schedules``.  The schedules return host floats:
the learning rate is call-time data of the step, written into a device
scalar by a fill, so a schedule never waits for the device.
"""
from __future__ import annotations

import math


def warmup_cosine(base_lr: float, total_steps: int,
                  warmup_frac: float = 0.03, min_ratio: float = 0.1):
    warmup = max(int(total_steps * warmup_frac), 1)

    def lr(step) -> float:
        step = float(step)
        if step < warmup:
            return base_lr * step / warmup
        t = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0), 1.0)
        return base_lr * (min_ratio + (1 - min_ratio) * 0.5 *
                          (1 + math.cos(math.pi * t)))

    return lr


def constant(base_lr: float):
    def lr(step) -> float:
        return float(base_lr)

    return lr
