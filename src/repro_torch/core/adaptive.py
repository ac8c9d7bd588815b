"""Adaptive layer allocation (paper C3): the accuracy-only controller.

A numpy copy of ``update_weights`` and ``adjust_cuts`` from
src/repro/core/adaptive.py (the port imports nothing of the JAX package);
tests/test_torch_host.py pins both bitwise to the original.  The
phase-time co-controller (``co_adjust``) comes with its own slice.

Weight rule (paper §III-C): w_i = 1 + gamma * (acc_i - acc_avg), clipped
positive.  Cut rule: clients above the fleet-average accuracy take MORE
layers; clients below shed layers, two buckets at once if they are also
straggler-slow.  Movement is restricted to the config's cut buckets.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.config import SplitConfig


def update_weights(accs: Sequence[float], gamma: float) -> np.ndarray:
    accs = np.asarray(accs, np.float64)
    avg = accs.mean()
    w = 1.0 + gamma * (accs - avg)
    return np.clip(w, 0.05, None)


def _straggler_mask(round_times, active_mask) -> np.ndarray:
    """Clients slower than 1.5x the median of ACTIVE clients' times."""
    rt = np.asarray(round_times, np.float64)
    sel = np.asarray(active_mask, bool)
    if not sel.any():
        return np.zeros(rt.shape, bool)
    return sel & (rt > 1.5 * float(np.median(rt[sel])))


def adjust_cuts(cuts: Sequence[int], accs: Sequence[float],
                split: SplitConfig, num_layers: int, *,
                dead_band: float = 0.002,
                round_times: Optional[Sequence[float]] = None,
                active: Optional[Sequence[float]] = None
                ) -> np.ndarray:
    """One accuracy-rule adjustment step.  Returns the new cut array.

    If round_times are given, a client that is BOTH below-average
    accuracy and slow moves down two buckets; the slow threshold's median
    is over `active` clients only (all clients when None)."""
    cuts = np.asarray(cuts, int)
    accs = np.asarray(accs, np.float64)
    buckets = np.asarray(split.buckets(num_layers), int)
    act = (np.ones(len(cuts), bool) if active is None
           else np.asarray(active, np.float64) > 0)
    avg = accs.mean()
    new = cuts.copy()
    slow = None
    if round_times is not None:
        slow = _straggler_mask(round_times, act)
    for i, c in enumerate(cuts):
        pos = int(np.argmin(np.abs(buckets - c)))
        if accs[i] > avg + dead_band:
            pos = min(pos + 1, len(buckets) - 1)
        elif accs[i] < avg - dead_band:
            step = 2 if (slow is not None and slow[i]) else 1
            pos = max(pos - step, 0)
        new[i] = buckets[pos]
    return new
