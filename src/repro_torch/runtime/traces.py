"""Trace-driven heterogeneity: time-indexed per-client (speed,
bandwidth, availability) series for the simulated clock.

A numpy copy of src/repro/runtime/traces.py (the port imports nothing of the
JAX package); tests/test_torch_host_loop.py pins it bitwise against
the reference on seeded inputs.

The stationary SpeedModel draws one lognormal (speed, bandwidth) pair
per client and keeps it for the whole run — production fleets do not
look like that: phones charge overnight (diurnal availability and
speed), cell towers congest whole neighbourhoods at once (correlated
bandwidth), devices churn (Markov availability bursts) and throttle
under sustained compute (thermal ramps).  A `Trace` provider makes the
fleet *non-stationary*: `SpeedModel.phase_times` queries it at each
launch's simulated start time and multiplies the stationary draws by
the trace's per-client factors; availability gates who participates
(barrier schedulers intersect the active mask, the async loop defers a
launch to the client's next available instant).

Design rules (all load-bearing for tests/test_traces.py):

  * **Traces are pure functions of (pid, time).**  Every value is
    derived from hashed (pid, window, seed) RandomStates — the
    `population_speed_draws` pattern — never from call order.  Replay
    is deterministic, queries may arrive out of order (the
    co-controller prices the *next* window while the async queue is
    mid-window), series are keyed by pid so they survive cohort churn,
    and checkpoint resume is bitwise: recomputing a window after
    restore gives the bits a straight run saw.  The Markov availability
    chain is sequential by nature, so it advances a per-pid cursor
    (step, state, up-since) — an O(1) cache over the pure function; the
    cursor round-trips through checkpoint metadata (state_dict) so a
    resumed run does not pay an O(t/step) replay on first query.
  * **Time is piecewise-constant at `step` resolution.**  `window(t)`
    is the memoization key the host loop uses: two queries in the same
    window see identical factors, so phase caches stay small.
  * **A constant trace is the stationary model, bitwise.**  Factors of
    exactly 1.0 multiply through (x * 1.0 is IEEE-identity), every
    client is always available, `next_available(t) == t` — the whole
    scheduler-equivalence test family transfers unchanged.

Providers:

  ConstantTrace    fixed factors (1.0/1.0 = the stationary clock)
  FileTrace        replay a recorded JSON trace (see format below)
  SyntheticTrace   seeded generators, composable via `make_trace_gen`:
                   diurnal sinusoid x per-window lognormal (speed),
                   Markov availability churn, correlated-bandwidth
                   cells, thermal-throttle ramps under sustained
                   compute

Trace file format (JSON, `--trace`): piecewise-constant rows every
`step` simulated seconds, wrapping periodically past the end::

    {"step": 60.0,                      # seconds per row
     "t0": 0.0,                        # optional origin (default 0)
     "speed":     [[1.0, 0.5], ...],   # (T, C) speed factors
     "bandwidth": [[1.0, 0.2], ...],   # (T, C) bandwidth factors
     "available": [[1, 1], ...]}       # (T, C) 0/1 availability

Each series is optional (missing -> all ones); a 1-D series of length T
broadcasts over clients.  Client `pid` reads column ``pid % C``, so one
recorded trace drives any population size.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

TraceSample = Tuple[np.ndarray, np.ndarray, np.ndarray]

_MASK = 0x7FFFFFFF


def _keyed_rng(seed: int, pid: int, window: int,
               salt: int) -> np.random.RandomState:
    """Deterministic per-(pid, window) RandomState — the
    population_speed_draws hashing idiom, extended with a time key."""
    return np.random.RandomState(
        (int(pid) * 2654435761 + int(window) * 97003
         + int(seed) * 1000003 + int(salt) * 7919 + 17) & _MASK)


class Trace:
    """Provider protocol + shared piecewise-constant time indexing.

    sample(t, pids) -> (speed, bandwidth, available): multiplicative
    factors on the SpeedModel's stationary draws (float64, (N,)) and a
    bool availability mask, all keyed by pid and constant within one
    `step`-second window."""

    step: float = 60.0

    def window(self, t: float) -> int:
        """Memoization key: the window index containing time t."""
        if not np.isfinite(self.step) or self.step <= 0:
            return 0
        return int(max(float(t), 0.0) // self.step)

    def sample(self, t: float, pids: Sequence[int]) -> TraceSample:
        raise NotImplementedError

    def next_available(self, t: float, pid: int, *,
                       horizon_steps: int = 10_000) -> float:
        """Earliest instant >= t at which `pid` is available; scans at
        most `horizon_steps` windows and returns the horizon's end if
        the client never comes back (the caller proceeds rather than
        deadlocking the simulation)."""
        return float(t)

    # -- checkpoint round-trip (msgpack/JSON-friendly plain types) ------
    def state_dict(self) -> Dict:
        return {}

    def load_state_dict(self, d: Dict):
        pass


class ConstantTrace(Trace):
    """Fixed factors.  speed == bw == 1.0 reproduces the stationary
    SpeedModel clock bitwise (the backward-compatibility pin every
    scheduler-equivalence test rides on)."""

    step = float("inf")

    def __init__(self, *, speed: float = 1.0, bw: float = 1.0):
        self.speed = float(speed)
        self.bw = float(bw)

    def sample(self, t: float, pids: Sequence[int]) -> TraceSample:
        n = len(pids)
        return (np.full(n, self.speed, np.float64),
                np.full(n, self.bw, np.float64),
                np.ones(n, bool))


class FileTrace(Trace):
    """Replay a recorded trace (format in the module docstring)."""

    def __init__(self, path: str):
        self.path = str(path)
        with open(path) as f:
            raw = json.load(f)
        if "step" not in raw:
            raise ValueError(f"trace file {path!r} has no 'step' "
                             "(seconds per row)")
        self.step = float(raw["step"])
        if self.step <= 0:
            raise ValueError(f"trace step must be > 0, got {self.step}")
        self.t0 = float(raw.get("t0", 0.0))
        series = {}
        rows = cols = None
        for name in ("speed", "bandwidth", "available"):
            if name not in raw:
                continue
            arr = np.asarray(raw[name], np.float64)
            if arr.ndim == 1:
                arr = arr[:, None]
            if arr.ndim != 2 or arr.shape[0] < 1:
                raise ValueError(f"trace series {name!r} must be (T,) "
                                 f"or (T, C), got shape {arr.shape}")
            if rows is not None and arr.shape[0] != rows:
                raise ValueError(
                    f"trace series lengths disagree: {name!r} has "
                    f"{arr.shape[0]} rows, expected {rows}")
            rows = arr.shape[0]
            cols = max(cols or 1, arr.shape[1])
            series[name] = arr
        if not series:
            raise ValueError(f"trace file {path!r} has no series "
                             "(speed / bandwidth / available)")
        self.rows = int(rows)
        self.cols = int(cols)
        self.speed = series.get("speed")
        self.bandwidth = series.get("bandwidth")
        self.available = series.get("available")
        self._clock = 0.0

    def _row(self, t: float) -> int:
        k = int(max(float(t) - self.t0, 0.0) // self.step)
        return k % self.rows            # wrap: the recording repeats

    def _col(self, arr: Optional[np.ndarray], row: int, pid: int,
             default: float) -> float:
        if arr is None:
            return default
        return float(arr[row, int(pid) % arr.shape[1]])

    def sample(self, t: float, pids: Sequence[int]) -> TraceSample:
        self._clock = max(self._clock, float(t))
        row = self._row(t)
        n = len(pids)
        sp = np.empty(n, np.float64)
        bw = np.empty(n, np.float64)
        av = np.empty(n, bool)
        for j, pid in enumerate(pids):
            sp[j] = self._col(self.speed, row, pid, 1.0)
            bw[j] = self._col(self.bandwidth, row, pid, 1.0)
            av[j] = self._col(self.available, row, pid, 1.0) > 0
        return sp, bw, av

    def next_available(self, t: float, pid: int, *,
                       horizon_steps: int = 10_000) -> float:
        if self.available is None:
            return float(t)
        horizon = min(int(horizon_steps), self.rows)  # one full wrap
        row = self._row(t)
        for d in range(horizon + 1):
            if self._col(self.available, (row + d) % self.rows,
                         pid, 1.0) > 0:
                if d == 0:
                    return float(t)
                k = int(max(float(t) - self.t0, 0.0) // self.step)
                return self.t0 + (k + d) * self.step
        return float(t) + horizon * self.step

    def state_dict(self) -> Dict:
        return {"clock": self._clock}

    def load_state_dict(self, d: Dict):
        self._clock = float(d.get("clock", 0.0))


class SyntheticTrace(Trace):
    """Seeded synthetic fleet dynamics, all pure in (pid, window):

    diurnal    speed factor exp(amp * sin(2 pi (t/period + phase_pid)))
               x a per-window lognormal exp(sigma * z_{pid,k}) — the
               day/night cycle with pid-keyed phase so the fleet does
               not breathe in lockstep
    markov     2-state availability chain per pid at `step` resolution
               (up -> down w.p. p_down, down -> up w.p. p_up per step);
               churn arrives in bursts, not i.i.d. dropout
    cells      correlated bandwidth: pid's cell is ``pid % cells`` and
               the whole cell shares one per-window lognormal factor
               exp(sigma * z_{cell,k}) — congestion hits neighbourhoods
    thermal    throttle ramp under sustained compute: while a device
               stays available it heats, its speed factor ramping
               linearly from 1.0 to `floor` over `heat` seconds of
               continuous uptime; a down period (markov) cools it back
               to 1.0.  Without markov the ramp runs from t = 0 — a
               device that never rests converges to the floor.
    """

    def __init__(self, *, seed: int = 0, step: float = 60.0,
                 diurnal: Optional[Dict] = None,
                 markov: Optional[Dict] = None,
                 cells: Optional[Dict] = None,
                 thermal: Optional[Dict] = None):
        self.seed = int(seed)
        self.step = float(step)
        if self.step <= 0:
            raise ValueError(f"trace step must be > 0, got {self.step}")
        self.diurnal = None if diurnal is None else {
            "amp": float(diurnal.get("amp", 0.5)),
            "period": float(diurnal.get("period", 86_400.0)),
            "sigma": float(diurnal.get("sigma", 0.2))}
        self.markov = None if markov is None else {
            "p_down": float(markov.get("p_down", 0.02)),
            "p_up": float(markov.get("p_up", 0.2))}
        self.cells = None if cells is None else {
            "k": int(cells.get("k", 8)),
            "sigma": float(cells.get("sigma", 0.5))}
        if self.cells is not None and self.cells["k"] < 1:
            raise ValueError("cells:k must be >= 1")
        self.thermal = None if thermal is None else {
            "floor": float(thermal.get("floor", 0.5)),
            "heat": float(thermal.get("heat", 1_800.0))}
        self._clock = 0.0
        # pid -> [window, state(1=up), up_since_window]: the Markov
        # cursor — a cache over the pure (pid, window) function, never
        # the source of truth (backward queries replay from window 0)
        self._markov: Dict[int, list] = {}

    # -- Markov availability chain --------------------------------------
    def _markov_at(self, pid: int, k: int) -> Tuple[int, int]:
        """(state, up_since_window) of `pid` at window k."""
        if self.markov is None:
            return 1, 0
        cur = self._markov.get(int(pid))
        store = True
        if cur is None:
            cur = [0, 1, 0]            # every pid starts up at window 0
        elif k < cur[0]:
            cur = [0, 1, 0]            # backward query: pure replay,
            store = False              # keep the farther cursor cached
        p_down, p_up = self.markov["p_down"], self.markov["p_up"]
        while cur[0] < k:
            kk = cur[0] + 1
            u = _keyed_rng(self.seed, pid, kk, 5).uniform()
            if cur[1] == 1:
                if u < p_down:
                    cur[1] = 0
            elif u < p_up:
                cur[1] = 1
                cur[2] = kk            # a fresh uptime stretch begins
            cur[0] = kk
        if store:
            self._markov[int(pid)] = cur
        return cur[1], cur[2]

    def sample(self, t: float, pids: Sequence[int]) -> TraceSample:
        self._clock = max(self._clock, float(t))
        k = self.window(t)
        tk = k * self.step             # window start: piecewise-constant
        n = len(pids)
        sp = np.ones(n, np.float64)
        bw = np.ones(n, np.float64)
        av = np.ones(n, bool)
        for j, pid in enumerate(pids):
            pid = int(pid)
            state, up_since = self._markov_at(pid, k)
            av[j] = bool(state)
            if self.diurnal is not None:
                d = self.diurnal
                phase = _keyed_rng(self.seed, pid, 0, 1).uniform()
                z = _keyed_rng(self.seed, pid, k, 2).normal()
                sp[j] *= np.exp(
                    d["amp"] * np.sin(2.0 * np.pi
                                      * (tk / d["period"] + phase))
                    + d["sigma"] * z)
            if self.thermal is not None and state:
                th = self.thermal
                elapsed = (k - up_since) * self.step
                sp[j] *= max(th["floor"],
                             1.0 - (1.0 - th["floor"])
                             * elapsed / max(th["heat"], self.step))
            if self.cells is not None:
                c = self.cells
                z = _keyed_rng(self.seed, pid % c["k"], k, 3).normal()
                bw[j] *= np.exp(c["sigma"] * z)
        return sp, bw, av

    def next_available(self, t: float, pid: int, *,
                       horizon_steps: int = 10_000) -> float:
        if self.markov is None:
            return float(t)
        k = self.window(t)
        if self._markov_at(pid, k)[0]:
            return float(t)
        for d in range(1, int(horizon_steps) + 1):
            if self._markov_at(pid, k + d)[0]:
                return (k + d) * self.step
        return float(t) + horizon_steps * self.step

    def state_dict(self) -> Dict:
        return {"clock": self._clock,
                "markov": {str(p): [int(c[0]), int(c[1]), int(c[2])]
                           for p, c in sorted(self._markov.items())}}

    def load_state_dict(self, d: Dict):
        self._clock = float(d.get("clock", 0.0))
        self._markov = {int(p): [int(c[0]), int(c[1]), int(c[2])]
                        for p, c in (d.get("markov") or {}).items()}


# ---------------------------------------------------------------------------
# construction: trace files and generator specs

_GEN_KNOBS = {
    "const": {"speed", "bw"},
    "diurnal": {"amp", "period", "sigma", "step"},
    "markov": {"p_down", "p_up", "step"},
    "cells": {"k", "sigma", "step"},
    "thermal": {"floor", "heat", "step"},
}


def load_trace(path: str) -> FileTrace:
    """`--trace PATH`: replay a recorded JSON trace file."""
    return FileTrace(path)


def make_trace_gen(spec: str, *, seed: int = 0) -> Trace:
    """`--trace-gen SPEC`: build a synthetic trace from a spec string.

    SPEC is '+'-joined component segments, each ``name`` or
    ``name:knob=value,knob=value``::

        const                                   # stationary, bitwise
        diurnal:amp=0.8,period=900,sigma=0.3
        diurnal+markov:p_down=0.05,p_up=0.3+cells:k=4+thermal:floor=0.4

    Components: const | diurnal | markov | cells | thermal (knobs per
    component in `_GEN_KNOBS`; any segment may set the shared ``step``
    resolution).  Unknown names/knobs raise with the known set."""
    if not spec or not spec.strip():
        raise ValueError("empty --trace-gen spec")
    parts: Dict[str, Dict[str, float]] = {}
    step = None
    for seg in spec.split("+"):
        seg = seg.strip()
        name, _, kvs = seg.partition(":")
        name = name.strip()
        if name not in _GEN_KNOBS:
            raise ValueError(
                f"unknown trace component {name!r} in spec {spec!r}; "
                f"known: {sorted(_GEN_KNOBS)}")
        knobs: Dict[str, float] = {}
        for kv in filter(None, (s.strip() for s in kvs.split(","))):
            key, _, val = kv.partition("=")
            key = key.strip()
            if key not in _GEN_KNOBS[name]:
                raise ValueError(
                    f"unknown knob {key!r} for trace component "
                    f"{name!r}; known: {sorted(_GEN_KNOBS[name])}")
            if key == "step":
                step = float(val)
            else:
                knobs[key] = float(val)
        if name in parts:
            raise ValueError(f"duplicate trace component {name!r} "
                             f"in spec {spec!r}")
        parts[name] = knobs
    if "const" in parts:
        if len(parts) > 1:
            raise ValueError("'const' does not compose with other "
                             f"trace components (spec {spec!r})")
        return ConstantTrace(**{k: v for k, v in parts["const"].items()})
    kw = {name: parts.get(name) for name in
          ("diurnal", "markov", "cells", "thermal")}
    if kw["cells"] is not None and "k" in kw["cells"]:
        kw["cells"]["k"] = int(kw["cells"]["k"])
    return SyntheticTrace(seed=seed, step=step if step else 60.0, **kw)
