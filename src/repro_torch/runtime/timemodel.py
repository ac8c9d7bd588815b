"""Pluggable phase pricing: one time-model layer for charge + predict.

A numpy copy of src/repro/runtime/timemodel.py (the port imports nothing of the
JAX package); tests/test_torch_host_loop.py pins it bitwise against
the reference on seeded inputs.

Before this module, "how long does a phase take" was answered in four
places with three different conventions: `SpeedModel.phase_times`
charged the simulated clock (jitter + trace factors), the same call
with `jitter=False` priced the co-controller's candidates, the trace
factors multiplied through implicitly whenever a trace was installed,
and the async event loop memoized whichever of those it happened to
need.  The controller could therefore only ever be as right as the
analytic simulator — exactly the transfer gap that breaks adaptation on
hardware the declared SpeedModel mis-describes.

`PhasePricer` splits the two roles explicitly:

  * **charge** — the ground-truth simulated clock: the `clock`
    SpeedModel with per-round jitter and trace factors.  Every source
    charges identically; refactoring the pricing layer must never move
    the simulated clock (bitwise-pinned under all five schedulers).
  * **predict** — the controller's *belief* about phase durations, used
    to price candidate (cut, rank, compressor, topk-frac) assignments.
    This is where the sources differ:

      analytic   the stationary model SpeedModel, no jitter, no trace
                 factors — the declared spec sheet.
      trace      the model x the trace's factors at the current window
                 ("what would this assignment cost *now*", not
                 under the stationary mean).
      measured   the stationary model corrected by a per-client,
                 per-phase EWMA of observed/predicted duration ratios
                 fed back from each round's charged `phase_times`.
                 Phase durations are linear in each client's speed and
                 bandwidth factors, so a ratio learned at the current
                 assignment transfers exactly to any candidate — the
                 controller prices from measured reality and adapts on
                 hardware where the declared model is wrong.

The `model` SpeedModel defaults to the `clock` object itself (analytic
== the clock's own stationary view, bitwise with the pre-refactor
pricer).  Passing a model drawn from a different seed deliberately
mis-specifies the controller's belief — the testbed `bench_adaptive`
uses to show `measured` beating `analytic` on time-to-target.

Measured state is keyed by population id (`SpeedModel._pids`), so the
EWMA survives cohort churn, and round-trips through checkpoint metadata
(`state_dict`/`load_state_dict`, plain JSON types).

`TraceRecorder` closes the loop in the other direction: it converts the
charged phase durations back into per-window (speed, bandwidth,
availability) factors — observed = stationary / factor, so factor =
stationary / observed — and dumps them in the `FileTrace` JSON format,
so a run's heterogeneity replays later via `--trace`.  Record with
`jitter_sigma=0` for an exact round-trip; with jitter on, the per-round
noise is folded into the recorded factors (they are *observed* factors,
not the generator's).
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from repro_torch.runtime.straggler import PHASES, SpeedModel, \
    population_speed_draws

TIME_SOURCES = ("analytic", "trace", "measured")


class PhasePricer:
    """Base pricer: charge through the clock, predict through the model.

    clock: the ground-truth SpeedModel (jitter + trace) — the simulated
    clock every scheduler charges.  model: the controller's belief;
    defaults to the clock object itself (a correctly-specified
    controller), in which case `install_cohort` is a no-op because the
    system already refreshes the clock's draws on cohort install."""

    source = "analytic"

    def __init__(self, clock: SpeedModel,
                 model: Optional[SpeedModel] = None):
        self.clock = clock
        self.model = clock if model is None else model

    # -- ground truth ---------------------------------------------------
    def charge(self, **kw) -> np.ndarray:
        """(5, N) charged phase durations — the simulated clock."""
        return self.clock.phase_times(**kw)

    # -- controller belief ----------------------------------------------
    def _stationary(self, sm: SpeedModel, **kw) -> np.ndarray:
        kw.update(jitter=False, apply_trace=False)
        return sm.phase_times(**kw)

    def predict(self, **kw) -> np.ndarray:
        """(5, N) predicted phase durations for a candidate assignment
        (always jitter-free; source-specific beyond that)."""
        raise NotImplementedError

    def model_baseline(self, **kw) -> np.ndarray:
        """The model's stationary view — the denominator the measured
        source learns correction ratios against."""
        return self._stationary(self.model, **kw)

    def clock_baseline(self, **kw) -> np.ndarray:
        """The clock's stationary view — what TraceRecorder divides by
        to recover trace factors."""
        return self._stationary(self.clock, **kw)

    # -- telemetry ------------------------------------------------------
    def observe(self, observed: np.ndarray, mask: np.ndarray,
                baseline: np.ndarray):
        """Feed back one round's charged (5, N) durations (no-op for
        the memoryless sources)."""

    def install_cohort(self, pids: np.ndarray):
        """Population mode installed a new cohort: refresh the model's
        pid-keyed draws (the system refreshes the clock's)."""
        if self.model is self.clock:
            return
        pids = np.asarray(pids, np.int64)
        sp, bw, js = population_speed_draws(
            pids, seed=self.model.seed,
            speed_sigma=self.model.speed_sigma,
            bw_mean=self.model.bw_mean, bw_sigma=self.model.bw_sigma)
        self.model.speed = np.asarray(sp)
        self.model.bandwidth = np.asarray(bw)
        self.model.jitter_seeds = np.asarray(js, np.int64)
        self.model.trace_pids = pids.copy()

    # -- checkpoint round-trip (plain JSON types) -----------------------
    def state_dict(self) -> Dict:
        return {}

    def load_state_dict(self, d: Dict):
        pass


class AnalyticPricer(PhasePricer):
    """Predict from the stationary model: no jitter, no trace factors.
    Without a trace installed this is bit-identical to the pre-refactor
    `phase_times(jitter=False)` pricer."""

    source = "analytic"

    def predict(self, **kw) -> np.ndarray:
        return self._stationary(self.model, **kw)


class TracePricer(PhasePricer):
    """Predict from the model x the trace's factors at the query's
    `start_time` window: candidates are priced at the CURRENT window,
    not the stationary mean."""

    source = "trace"

    def predict(self, **kw) -> np.ndarray:
        kw["jitter"] = False
        return self.model.phase_times(**kw)


class MeasuredPricer(PhasePricer):
    """Predict from the stationary model corrected by per-(pid, phase)
    EWMA ratios of observed / model-baseline durations.

    Warm start is ratio 1.0 everywhere, so before the first observation
    `measured` prices exactly like `analytic`.  Each observed round
    updates ratio <- (1 - alpha) * ratio + alpha * observed/baseline
    for the clients that actually ran (the active mask).  Because every
    phase duration is linear in the client's speed or bandwidth factor,
    the ratio learned at the current (cut, rank, compressor, frac)
    transfers exactly to any candidate assignment — with jitter_sigma=0
    and a constant clock, ONE observation makes predictions coincide
    with the true clock even under a mis-specified model."""

    source = "measured"

    def __init__(self, clock: SpeedModel,
                 model: Optional[SpeedModel] = None, *,
                 ewma_alpha: float = 0.3):
        super().__init__(clock, model)
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got "
                             f"{ewma_alpha}")
        self.ewma_alpha = float(ewma_alpha)
        self._ratio: Dict[int, np.ndarray] = {}   # pid -> (5,) float64
        self._count: Dict[int, int] = {}

    def predict(self, **kw) -> np.ndarray:
        base = self._stationary(self.model, **kw)
        pids = self.clock._pids()
        out = base.copy()
        for j, pid in enumerate(pids):
            r = self._ratio.get(int(pid))
            if r is not None:
                out[:, j] = base[:, j] * r
        return out

    def observe(self, observed: np.ndarray, mask: np.ndarray,
                baseline: np.ndarray):
        obs = np.asarray(observed, np.float64)
        base = np.asarray(baseline, np.float64)
        pids = self.clock._pids()
        a = self.ewma_alpha
        for j in np.flatnonzero(np.asarray(mask, bool)):
            # a zero-baseline phase (e.g. free server compute) carries
            # no signal: hold its ratio at the warm-start identity
            r = np.where(base[:, j] > 0.0, obs[:, j]
                         / np.where(base[:, j] > 0.0, base[:, j], 1.0),
                         1.0)
            pid = int(pids[j])
            prev = self._ratio.get(pid)
            self._ratio[pid] = r if prev is None \
                else (1.0 - a) * prev + a * r
            self._count[pid] = self._count.get(pid, 0) + 1

    def state_dict(self) -> Dict:
        return {"ewma_alpha": self.ewma_alpha,
                "ratio": {str(p): [float(x) for x in r]
                          for p, r in sorted(self._ratio.items())},
                "count": {str(p): int(c)
                          for p, c in sorted(self._count.items())}}

    def load_state_dict(self, d: Dict):
        if not d:
            return
        self.ewma_alpha = float(d.get("ewma_alpha", self.ewma_alpha))
        self._ratio = {int(p): np.asarray(r, np.float64)
                       for p, r in (d.get("ratio") or {}).items()}
        self._count = {int(p): int(c)
                       for p, c in (d.get("count") or {}).items()}


def make_pricer(source: str, clock: SpeedModel,
                model: Optional[SpeedModel] = None, *,
                ewma_alpha: float = 0.3) -> PhasePricer:
    """Build the pricer for a `SystemConfig.time_source` value."""
    if source == "analytic":
        return AnalyticPricer(clock, model)
    if source == "trace":
        return TracePricer(clock, model)
    if source == "measured":
        return MeasuredPricer(clock, model, ewma_alpha=ewma_alpha)
    raise ValueError(f"unknown time_source {source!r}; known: "
                     f"{TIME_SOURCES}")


class TraceRecorder:
    """Record a run's observed per-phase factors as a replayable trace.

    Each observation is one charged (5, N) phase matrix plus the
    clock's stationary baseline for the same assignment.  Factors
    multiply the stationary draws in `SpeedModel.phase_times` (duration
    = stationary / factor), so the observed factor is baseline /
    observed: the `client_compute` row yields the speed factor, the
    `f2_uplink` row the bandwidth factor.  Rows are keyed by the
    recording's piecewise-constant window (the clock trace's `step`
    when one is installed, else `step` seconds); unvisited windows are
    forward-filled on dump, and availability snapshots the clock's mask
    at each observed instant.

    Columns are client slots: replaying with the same fleet size maps
    slot i back onto client i (`FileTrace` reads column pid % C)."""

    def __init__(self, clock: SpeedModel, *, step: float = 60.0):
        self.clock = clock
        tr = clock.trace
        if tr is not None and np.isfinite(tr.step) and tr.step > 0:
            step = float(tr.step)
        self.step = float(step)
        # window -> (speed (N,), bw (N,), avail (N,)) float64 rows
        self._rows: Dict[int, tuple] = {}

    def observe(self, observed: np.ndarray, baseline: np.ndarray,
                mask: np.ndarray, t: float):
        obs = np.asarray(observed, np.float64)
        base = np.asarray(baseline, np.float64)
        sel = np.asarray(mask, bool)
        w = int(max(float(t), 0.0) // self.step)
        n = obs.shape[1]
        prev = self._rows.get(w)
        speed = (prev[0].copy() if prev is not None
                 else np.ones(n, np.float64))
        bw = (prev[1].copy() if prev is not None
              else np.ones(n, np.float64))
        avail = (prev[2].copy() if prev is not None
                 else np.ones(n, np.float64))
        with np.errstate(divide="ignore", invalid="ignore"):
            sp = np.where(obs[0] > 0, base[0] / np.where(obs[0] > 0,
                                                         obs[0], 1.0),
                          1.0)
            bf = np.where(obs[1] > 0, base[1] / np.where(obs[1] > 0,
                                                         obs[1], 1.0),
                          1.0)
        speed[sel] = sp[sel]
        bw[sel] = bf[sel]
        avail[:] = self.clock.available_mask(float(t)).astype(np.float64)
        self._rows[w] = (speed, bw, avail)

    def to_trace_dict(self) -> Dict:
        """The `FileTrace` JSON dict (format: runtime/traces.py)."""
        if not self._rows:
            raise ValueError(
                "nothing recorded: --record-trace needs at least one "
                "completed round with a simulated clock")
        n = next(iter(self._rows.values()))[0].shape[0]
        last = max(self._rows)
        speed, bw, avail = [], [], []
        row = (np.ones(n), np.ones(n), np.ones(n))
        for w in range(last + 1):
            row = self._rows.get(w, row)    # forward-fill gaps
            speed.append([float(x) for x in row[0]])
            bw.append([float(x) for x in row[1]])
            avail.append([int(x > 0) for x in row[2]])
        return {"step": self.step, "t0": 0.0, "phases": list(PHASES),
                "speed": speed, "bandwidth": bw, "available": avail}

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_trace_dict(), f)
