"""How one run of the round engine is held to another: the checks that
the client-sharded engine's tests and chip_smoke.py's phase 16 share.

A run's result is its round state as numpy trees and its per-round
records (``SplitFTSystem.history``).  ``same_bits`` holds two results bit
for bit.  ``check_state`` and ``check_history`` hold a client-sharded
run to the unsharded one, where sums over clients are taken in another
order: every discrete leaf (a host-state key, or an integer or boolean
dtype) and every record of EXACT_RECORD_KEYS equal, each float leaf
within ``rtol`` and ``atol_of_max`` x max|leaf| (per top-level key when
``bounds`` names it), the losses of LOSS_KEYS within ``loss_rtol``.
Under AdamW an element's first steps are ~lr sign(g) whatever |g| is,
so where a gradient element is smaller than the sharded run's rounding
(or than the change that a flipped int8 code at the cut makes), the two
runs step it by lr in opposite directions: ``outliers`` lets at most a
given share of a leaf's elements lie outside the tolerance, for the
leaves it names by path ("client_adapters/dec/k/B") or by top-level
key.  Every failure raises ``Mismatch`` (an
AssertionError) naming each leaf or record that is out of bounds.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.bridge import HOST_STATE
from repro_torch.tree import tree_leaves_with_path

EXACT_RECORD_KEYS = ("round", "cuts", "active", "rank_cut",
                     "smashed_choice", "topk_frac", "step_budgets",
                     "round_steps", "buffer_fill", "staleness", "comm",
                     "comm_smashed", "smashed_ratio", "sim_time",
                     "sim_clock", "round_time_sim", "phase_times",
                     "predicted_time", "weights")
LOSS_KEYS = ("loss", "ce", "eval_ce")


class Mismatch(AssertionError):
    pass


def _exact(keys, x: np.ndarray) -> bool:
    return keys[0] in HOST_STATE or x.dtype.kind in "iub"


def same_bits(got, want, where: str = "") -> None:
    """got and want bit for bit: nested dicts, lists and tuples of arrays
    and scalars with the same keys, dtypes, shapes and bytes."""
    if isinstance(want, Mapping):
        if set(got) != set(want):
            raise Mismatch(f"{where}: keys {sorted(map(str, got))} vs "
                           f"{sorted(map(str, want))}")
        for k in want:
            same_bits(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise Mismatch(f"{where}: {len(got)} items vs {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            same_bits(a, b, f"{where}[{i}]")
    else:
        x, y = np.asarray(got), np.asarray(want)
        if (x.dtype != y.dtype or x.shape != y.shape
                or x.tobytes() != y.tobytes()):
            raise Mismatch(f"{where} differs")


def check_state(got, want, *, rtol: float, atol_of_max: float,
                bounds: Optional[Mapping[str, float]] = None,
                outliers: Optional[Mapping[str, float]] = None
                ) -> Dict[str, Tuple[float, float]]:
    """Hold state tree `got` to `want` (see the module docstring); a
    float leaf under a top-level key of `bounds` takes that key's
    atol_of_max, one that `outliers` names (its path, else its top-level
    key) may have that share of its elements outside the tolerance.  Returns per top-level key of a
    float leaf the largest |diff| / max|leaf| and the largest share of a
    leaf's elements outside the tolerance."""
    bounds, outliers = bounds or {}, outliers or {}
    g = dict(tree_leaves_with_path(got))
    gaps: Dict[str, Tuple[float, float]] = {}
    bad = []
    for keys, y in tree_leaves_with_path(want):
        path = "/".join(keys)
        x, y = np.asarray(g[keys]), np.asarray(y)
        if x.dtype != y.dtype or x.shape != y.shape:
            raise Mismatch(f"{path}: {x.dtype}{x.shape} vs "
                           f"{y.dtype}{y.shape}")
        if _exact(keys, y):
            if not np.array_equal(x, y):
                bad.append(f"{path} differs")
            continue
        if not y.size:
            continue
        scale = float(np.abs(y).max())
        share = float(np.abs(x.astype(np.float64) - y).max()) / max(
            scale, 1e-30)
        atol = bounds.get(keys[0], atol_of_max) * scale
        out = float(np.mean(~np.isclose(x, y, rtol=rtol, atol=atol)))
        was = gaps.get(keys[0], (0.0, 0.0))
        gaps[keys[0]] = (max(was[0], share), max(was[1], out))
        if out > outliers.get(path, outliers.get(keys[0], 0.0)):
            bad.append(f"{path} ({share:.3e} of max|leaf|, {out:.3e} of "
                       "its elements outside)")
    if bad:
        raise Mismatch(f"{len(bad)} leaves out of bounds: "
                       + "; ".join(bad))
    return gaps


def check_history(got: List[Dict[str, Any]], want: List[Dict[str, Any]],
                  *, loss_rtol: float) -> float:
    """Hold the per-round records `got` to `want`: the same keys, every
    EXACT_RECORD_KEYS record equal, the losses within loss_rtol.
    Returns the largest relative difference of a loss."""
    if len(got) != len(want):
        raise Mismatch(f"{len(got)} rounds vs {len(want)}")
    worst, bad = 0.0, []
    for a, b in zip(got, want):
        if a.keys() != b.keys():
            raise Mismatch(f"round {b.get('round')}: record keys "
                           f"{sorted(a)} vs {sorted(b)}")
        for k in EXACT_RECORD_KEYS:
            if k in b and not np.array_equal(np.asarray(a[k]),
                                             np.asarray(b[k])):
                bad.append(f"round {b['round']} {k}: {a[k]} vs {b[k]}")
        for k in LOSS_KEYS:
            if k not in b:
                continue
            x = np.asarray(a[k], np.float64)
            y = np.asarray(b[k], np.float64)
            worst = max(worst, float(np.max(np.abs(x - y)
                                            / np.maximum(np.abs(y),
                                                         1e-30))))
            if not np.allclose(x, y, rtol=loss_rtol, atol=0):
                bad.append(f"round {b['round']} {k}: {a[k]} vs {b[k]}")
    if bad:
        raise Mismatch(f"{len(bad)} records out of bounds: "
                       + "; ".join(bad))
    return worst
