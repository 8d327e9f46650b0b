"""Learning-rate schedule, counterpart of accunet_tpu/train/schedules.py:17-44.

cosine_warm_restarts reproduces the reference's CosineAnnealingWarmRestarts
stepped once per *epoch* (T_0=10, T_mult=1, eta_min=1e-5 in the reference
harness). It is a plain function step -> lr; the engine sets the optimizer's
lr from it before every step.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_warm_restarts(
    base_lr: float,
    t_0: int = 10,
    t_mult: int = 1,
    eta_min: float = 1e-5,
    steps_per_epoch: int = 1,
) -> Callable[[int], float]:
    """Returns schedule(step) -> lr. `steps_per_epoch` converts optimizer
    steps to the reference's epoch-granular schedule."""

    def schedule(step: int) -> float:
        epoch = int(step) // steps_per_epoch
        if t_mult == 1:
            frac = (epoch % t_0) / t_0
        else:
            # epoch lies in cycle k where sum_{i<k} t_0*t_mult^i <= epoch
            k = math.floor(math.log(epoch * (t_mult - 1) / t_0 + 1) / math.log(t_mult))
            start = t_0 * (t_mult ** k - 1) / (t_mult - 1)
            frac = (epoch - start) / (t_0 * t_mult ** k)
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * frac)) / 2

    return schedule
