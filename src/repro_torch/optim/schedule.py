"""Learning-rate schedules as plain functions of the host step.

Port of src/repro/optim/schedule.py.  The reference traces its schedule
in fp32; here the step is a Python int on the host and the arithmetic is
numpy fp32, in the reference's order, so both give the same rates.  The
round engine calls no schedule, as in the reference: a caller passes
``lr(step)`` as a step's learning rate.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

KINDS = ("constant", "cosine", "linear")


def make_schedule(kind: str, base_lr: float, *, warmup_steps: int = 0,
                  total_steps: int = 0, min_ratio: float = 0.1
                  ) -> Callable[[int], float]:
    """Returns lr(step) with a linear warmup over warmup_steps, then
    {constant | cosine | linear} decay to min_ratio x base_lr at
    total_steps (constant when total_steps is 0)."""
    if kind not in KINDS:
        raise ValueError(kind)

    def lr(step) -> float:
        s = np.float32(step)
        warm = (np.minimum(np.float32(1.0),
                           (s + 1) / np.float32(max(warmup_steps, 1)))
                if warmup_steps else 1.0)
        decay = 1.0
        if kind != "constant" and total_steps:
            frac = np.clip((s - warmup_steps)
                           / np.float32(max(total_steps - warmup_steps, 1)),
                           np.float32(0.0), np.float32(1.0))
            if kind == "cosine":
                decay = min_ratio + (1 - min_ratio) * 0.5 * \
                    (1 + np.cos(np.float32(np.pi) * frac))
            else:
                decay = 1.0 - (1 - min_ratio) * frac
        return float(base_lr * warm * decay)

    return lr
