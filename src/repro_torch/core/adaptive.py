"""Adaptive layer allocation (paper C3) and the co-controller.

A numpy copy of ``update_weights``, ``adjust_cuts`` and ``co_adjust``
from src/repro/core/adaptive.py (the port imports nothing of the JAX
package); tests/test_torch_host.py and tests/test_torch_co_controller.py
pin them bitwise to the original.

Weight rule (paper §III-C): w_i = 1 + gamma * (acc_i - acc_avg), clipped
positive.  Cut rule: clients above the fleet-average accuracy take MORE
layers; clients below shed layers, two buckets at once if they are also
straggler-slow.  Movement is restricted to the config's cut buckets.

Co-controller (``co_adjust``): per client, the (cut bucket, rank-at-cut
bucket, smashed compressor) triple with the least predicted round time,
gated by the same accuracy dead-band: below the band a forced
quality-recovery move (cut down, rank up one bucket, compression one
step weaker); inside it the argmin over the held cut; above it the cut
may also grow.  A move must beat the current triple's time by min_gain.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

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


def co_adjust(cuts: Sequence[int], rank_cut: Sequence[int],
              comp_idx: Sequence[int], accs: Sequence[float],
              split: SplitConfig, num_layers: int, *,
              rank_buckets: Sequence[int], num_compressors: int,
              price: Callable,
              active: Optional[Sequence[float]] = None,
              dead_band: float = 0.002, min_gain: float = 0.05,
              round_times: Optional[Sequence[float]] = None,
              topk_frac: Optional[Sequence[float]] = None,
              frac_bounds: Tuple[float, float] = (0.01, 1.0)
              ) -> Tuple[np.ndarray, ...]:
    """One co-controller step over (cut, rank-at-cut, compressor).

    price(cuts, rank_cut, comp_idx) -> (N,) predicted per-client round
    makespan for a full candidate assignment.  Each client's prediction
    depends only on its own triple, so the controller prices each
    candidate triple once for the whole fleet and lets every client read
    its own column — |offsets| x |rank_buckets| x num_compressors calls,
    independent of N.

    Returns (cuts', rank_cut', comp_idx', predicted) where `predicted`
    is each client's predicted makespan under its NEW assignment.
    Inactive clients keep their triple unchanged (their prediction is
    the stay-put price).  See the module docstring for the dead-band /
    min_gain policy.

    topk_frac (optional, (N,) per-client topk keep fraction) adds the
    CONTINUOUS fourth knob: `price` must then accept a fourth
    per-client frac argument and the return grows to (cuts', rank_cut',
    comp_idx', topk_frac', predicted).  The fraction obeys the same
    accuracy gating as the discrete knobs — below the dead-band the
    fraction is forcibly DOUBLED (quality recovery: keep more signal,
    clipped to frac_bounds); inside the band it holds; above the band a
    halved fraction competes against the kept one under the same
    min_gain hysteresis, after the triple has settled.  A client whose
    chosen compressor is not topk prices identically at any fraction,
    so the hysteresis pins its fraction in place."""
    cuts = np.asarray(cuts, int)
    rank_cut = np.asarray(rank_cut, int)
    comp_idx = np.asarray(comp_idx, int)
    accs = np.asarray(accs, np.float64)
    n = len(cuts)
    act = (np.ones(n, bool) if active is None
           else np.asarray(active, np.float64) > 0)
    buckets = np.asarray(split.buckets(num_layers), int)
    rbuckets = np.asarray(sorted({int(r) for r in rank_buckets}), int)
    if len(rbuckets) == 0:
        raise ValueError("co_adjust needs at least one rank bucket")
    if num_compressors < 1:
        raise ValueError("co_adjust needs at least one compressor bucket")
    frac = (None if topk_frac is None
            else np.asarray(topk_frac, np.float64))
    _price = (price if frac is None
              else lambda c, rk, ci: price(c, rk, ci, frac))
    avg = accs[act].mean() if act.any() else accs.mean()
    slow = (np.zeros(n, bool) if round_times is None
            else _straggler_mask(round_times, act))

    pos = np.array([int(np.argmin(np.abs(buckets - c))) for c in cuts])
    rpos = np.array([int(np.argmin(np.abs(rbuckets - r)))
                     for r in rank_cut])

    offsets = (-2, -1, 0, 1)
    times = {}
    for dc in offsets:
        cand_cuts = buckets[np.clip(pos + dc, 0, len(buckets) - 1)]
        for ri in range(len(rbuckets)):
            for ci in range(num_compressors):
                times[(dc, ri, ci)] = np.asarray(
                    _price(cand_cuts, np.full(n, rbuckets[ri], int),
                           np.full(n, ci, int)), np.float64)

    new_cuts = cuts.copy()
    new_rank = rank_cut.copy()
    new_comp = comp_idx.copy()
    below = np.zeros(n, bool)
    above = np.zeros(n, bool)
    predicted = np.array([times[(0, rpos[i], comp_idx[i])][i]
                          for i in range(n)])
    for i in range(n):
        if not act[i]:
            continue
        t_cur = times[(0, rpos[i], comp_idx[i])][i]
        if accs[i] < avg - dead_band:
            below[i] = True
            # forced quality recovery: never an argmin — shed layers,
            # raise rank one bucket, weaken compression one step
            dc = -2 if slow[i] else -1
            cp = max(pos[i] + dc, 0)
            ri = min(rpos[i] + 1, len(rbuckets) - 1)
            ci = max(comp_idx[i] - 1, 0)
            new_cuts[i] = buckets[cp]
            new_rank[i] = rbuckets[ri]
            new_comp[i] = ci
            predicted[i] = times[(cp - pos[i], ri, ci)][i] \
                if cp - pos[i] in offsets else t_cur
            continue
        above[i] = accs[i] > avg + dead_band
        dcs = (0, 1) if above[i] else (0,)
        # score: time first, then prefer staying put, a held cut, higher
        # rank, weaker compression — the quality-preserving tie-breaks
        best = None
        for dc in dcs:
            if np.clip(pos[i] + dc, 0, len(buckets) - 1) != pos[i] + dc:
                continue
            for ri in range(len(rbuckets)):
                for ci in range(num_compressors):
                    is_cur = (dc == 0 and ri == rpos[i]
                              and ci == comp_idx[i])
                    key = (times[(dc, ri, ci)][i], 0 if is_cur else 1,
                           abs(dc), -ri, ci)
                    if best is None or key < best[0]:
                        best = (key, dc, ri, ci)
        _, dc, ri, ci = best
        t_best = times[(dc, ri, ci)][i]
        if t_best > (1.0 - min_gain) * t_cur:
            predicted[i] = t_cur
            continue                     # hysteresis: not worth moving
        new_cuts[i] = buckets[pos[i] + dc]
        new_rank[i] = rbuckets[ri]
        new_comp[i] = ci
        predicted[i] = t_best
    if frac is None:
        return new_cuts, new_rank, new_comp, predicted

    # ---- continuous topk-fraction move (after the triple settles) ----
    lo, hi = float(frac_bounds[0]), float(frac_bounds[1])
    new_frac = frac.copy()
    # forced quality recovery: keep more signal (double, never argmin —
    # a larger fraction costs wire time by construction)
    new_frac[below] = np.clip(frac[below] * 2.0, lo, hi)
    t_keep = np.asarray(price(new_cuts, new_rank, new_comp, new_frac),
                        np.float64)
    cand = np.clip(new_frac * 0.5, lo, hi)
    t_half = np.asarray(price(new_cuts, new_rank, new_comp, cand),
                        np.float64)
    # only above-band clients may trade accuracy for time, and only past
    # the same hysteresis threshold the triple moves use
    move = above & (cand < new_frac) \
        & (t_half < (1.0 - min_gain) * t_keep)
    new_frac = np.where(move, cand, new_frac)
    predicted = np.where(act, np.where(move, t_half, t_keep), predicted)
    return new_cuts, new_rank, new_comp, new_frac, predicted
