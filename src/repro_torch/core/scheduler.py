"""Round schedulers: who participates in a round, and how much work each
client does before the FedAvg barrier.

A numpy copy of src/repro/core/scheduler.py (the port imports nothing of the
JAX package); tests/test_torch_host_loop.py pins it bitwise against
the reference on seeded inputs.

The round *engine* (rounds.make_train_step) is one jitted executable whose
behaviour is controlled by data — survivor masks, per-client step budgets.
A `RoundScheduler` is the host-side policy that produces that data each
round, plus the simulated wall-clock accounting the benchmarks report:

  sync         paper Algorithm 1: every client runs exactly one step and
               the round barrier waits for the slowest client.  Default;
               bit-identical to the pre-scheduler engine.
  deadline     straggler drop (previously inlined in SplitFTSystem.run):
               ACTIVE clients that would exceed deadline_frac x the
               active-fleet median round time are excluded from this
               round's step and FedAvg; fast clients still idle until the
               last *survivor* finishes.
  local_steps  speed-proportional local work (FlexP-SFL-style flexible
               participation): client i runs K_i local steps per round
               with K_i ~ floor(t_max / t_i) so everyone finishes near the
               sync barrier — fast clients do useful extra steps instead
               of idling.  FedAvg weights are step-normalized (FedNova
               style) in aggregation.fedavg so extra steps do not bias the
               global adapter.
  async        FedBuff-style buffered asynchrony: there is NO barrier.
               Clients run free, each completion (an event on the
               EventQueue's simulated clock) pushes the client's update
               into a server buffer; when `buffer_size` distinct clients
               have contributed, the server aggregates with staleness-
               discounted weights ((1+s)^-power, aggregation.fedavg),
               re-broadcasts to the contributors only, and bumps the
               global version.  In-flight clients keep training on stale
               adapters — the straggler tax becomes a staleness discount
               instead of idle time.

The time model is multi-phase (runtime.straggler.PHASES): one local step
= client compute -> f2 uplink -> server compute -> f4 downlink -> adapter
sync.  With `overlap_comm=False` (default) the phases are charged back to
back through `serial_step_times` — the legacy single-duration clock.
With `overlap_comm=True` the phases PIPELINE: double-buffered, one
outstanding transfer per direction, so a client whose f2 of step k is in
flight may already be computing step k+1.  Barrier schedulers charge the
pipelined makespan of their K_i-step rounds; the async host loop pops
phase-tagged `(client, phase, launch)` completions off the EventQueue and
only a step's final phase contributes an engine tick.  Training numerics
are unchanged in every mode — overlap reshapes only the simulated clock
(and with it the event ORDER under heterogeneity).

Schedulers compose with the C3 controllers (repro.core.adaptive): the
round epilogue may move each client's cut — and, under the
co-controller, its rank-at-cut and smashed compressor — which changes
the client's phase durations.  Barrier schedulers see the new durations
at the next plan(); the async loop re-draws them at the client's next
scheduled phase (SplitFTSystem's phase cache is keyed by the full
policy assignment, so a moved triple is re-priced, not stale).

The barrier schedulers are small, stateless policy objects; everything
they decide is arrays in a `RoundPlan`, so the engine below them never
recompiles when the policy changes its mind.  The async scheduler
additionally owns the event-driven simulation state (the queue of
per-client completion times, per-client launch counters, pipeline
bookkeeping and the per-round tick accounting); SplitFTSystem persists
that state through checkpoint metadata so async runs resume mid-buffer
bit-exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.straggler import (PHASES, deadline_survivors,
                                     local_step_budgets,
                                     overlap_step_budgets,
                                     pipelined_makespan)

SCHEDULERS = ("sync", "deadline", "local_steps", "async")

# Event-key phase tag for an un-overlapped whole step (all five phases
# charged serially as one event).  Overlap mode tags events with the
# individual runtime.straggler.PHASES names instead.
PHASE_STEP = "step"
PHASE_FINAL = PHASES[-1]            # adapter_sync: a step's last phase


@dataclasses.dataclass
class RoundPlan:
    """Everything the engine + accounting need for one round.

    active:       (N,) float {0,1} — pool membership x scheduler survivors
                  (async: the clients whose updates entered this round's
                  aggregation buffer).
    step_budgets: (N,) int — local steps each client runs this round
                  (0 for inactive clients; all-ones for sync/deadline;
                  async: completions per client since the last
                  aggregation).
    sim_time:     simulated wall-clock of this round (seconds); 0.0 when
                  no speed model is attached.
    times:        per-client one-step round-time estimates (or None).
                  Async: drawn at each client's actual launch index, not
                  the aggregation-round index.
    deadline:     the drop threshold, when the policy has one.
    staleness:    (N,) version lag of each buffered update at aggregation
                  time (async only).
    buffer_fill:  number of distinct clients in the buffer when it
                  flushed (async only; >= buffer_size by construction).
    phases:       (P, N) per-phase one-step durations the plan was drawn
                  from (runtime.straggler.PHASES order), or None without
                  a speed model.  Carried through so the round record can
                  report phase-level accounting — e.g. the charged
                  server-phase/adapter-sync time that hierarchical
                  aggregation reduces (benchmarks/bench_fleet.py).
    """

    active: np.ndarray
    step_budgets: np.ndarray
    sim_time: float
    times: Optional[np.ndarray] = None
    deadline: Optional[float] = None
    staleness: Optional[np.ndarray] = None
    buffer_fill: Optional[float] = None
    phases: Optional[np.ndarray] = None


def _barrier_time(active: np.ndarray, times: Optional[np.ndarray]) -> float:
    if times is None:
        return 0.0
    sel = np.asarray(times, np.float64)[active > 0]
    return float(sel.max()) if sel.size else 0.0


def _apply_available(act: np.ndarray, available) -> np.ndarray:
    """Intersect pool membership with the trace's availability mask (a
    diurnal/churn trace gates who can even take a round).  None — or an
    all-ones mask — leaves `act` bitwise unchanged (x * 1.0 identity),
    which is the constant-trace == stationary pin."""
    if available is None:
        return act
    return act * np.asarray(available, np.float64)


class RoundScheduler:
    """Base policy: synchronous lockstep (paper Algorithm 1).

    plan(available=...) is the trace-driven availability mask
    (runtime/traces.py): barrier schedulers treat an unavailable client
    exactly like a pool-inactive one for this round — no step, no
    FedAvg share, and it cannot set the barrier time."""

    name = "sync"
    max_steps = 1          # static K cap: the engine's inner-scan length
    needs_speed = False    # whether plan() requires round-time estimates

    def plan(self, *, active, times=None, phases=None,
             round_idx: int = 0, available=None) -> RoundPlan:
        act = _apply_available(np.asarray(active, np.float64).copy(),
                               available)
        budgets = np.where(act > 0, 1, 0).astype(np.int64)
        return RoundPlan(active=act, step_budgets=budgets,
                         sim_time=_barrier_time(act, times), times=times,
                         phases=phases)


class SyncScheduler(RoundScheduler):
    pass


class DeadlineScheduler(RoundScheduler):
    """Drop clients that would blow the round deadline (straggler
    mitigation moved out of SplitFTSystem.run).  The deadline is
    deadline_frac x the median over ACTIVE clients — departed
    (elastic-leave) clients must not skew it."""

    name = "deadline"
    needs_speed = True

    def __init__(self, *, deadline_frac: float = 1.5):
        self.deadline_frac = deadline_frac

    def plan(self, *, active, times=None, phases=None,
             round_idx: int = 0, available=None) -> RoundPlan:
        if times is None:
            raise ValueError("deadline scheduler needs round-time "
                             "estimates (a SpeedModel)")
        act = _apply_available(np.asarray(active, np.float64).copy(),
                               available)
        surv, deadline = deadline_survivors(
            np.asarray(times, np.float64),
            deadline_frac=self.deadline_frac, active=act)
        act = act * surv
        budgets = np.where(act > 0, 1, 0).astype(np.int64)
        return RoundPlan(active=act, step_budgets=budgets,
                         sim_time=_barrier_time(act, times), times=times,
                         deadline=deadline, phases=phases)


class LocalStepsScheduler(RoundScheduler):
    """Speed-proportional per-client local steps: fast clients fill the
    sync barrier with extra useful steps instead of idling.

    Each local step in split learning is a full f2/f4 exchange with the
    server, so a step costs one `times[i]`; K_i = clamp(floor(t_max/t_i),
    1, max_steps) keeps every client's K_i * t_i near the barrier t_max.
    With overlap a step's wire time hides behind the next step's
    compute, so pipelined steps are cheaper than serial ones: the budget
    becomes the largest K_i whose pipelined MAKESPAN still fits the
    barrier (overlap_step_budgets) — fast clients pack more useful steps
    into the same wall-clock instead of finishing early — and the round
    is charged the makespan of the slowest client's pipelined budget.
    """

    name = "local_steps"
    needs_speed = True

    def __init__(self, *, max_steps: int = 4, overlap: bool = False):
        if max_steps < 1:
            raise ValueError(f"max_steps must be >= 1, got {max_steps}")
        self.max_steps = max_steps
        self.overlap = overlap

    def plan(self, *, active, times=None, phases=None,
             round_idx: int = 0, available=None) -> RoundPlan:
        if times is None:
            raise ValueError("local_steps scheduler needs round-time "
                             "estimates (a SpeedModel)")
        act = _apply_available(np.asarray(active, np.float64).copy(),
                               available)
        t = np.asarray(times, np.float64)
        overlapped = self.overlap and phases is not None
        if overlapped:
            budgets = overlap_step_budgets(
                phases, max_steps=self.max_steps, active=act)
        else:
            budgets = local_step_budgets(t, max_steps=self.max_steps,
                                         active=act)
        sel = act > 0
        if not sel.any():
            sim = 0.0
        elif overlapped:
            span = pipelined_makespan(phases, budgets)
            sim = float(span[sel].max())
        else:
            sim = float((budgets[sel] * t[sel]).max())
        return RoundPlan(active=act, step_budgets=budgets, sim_time=sim,
                         times=times, phases=phases)


def event_client(key: Hashable) -> int:
    """Client id of an event key (int legacy key or (client, phase,
    launch) tuple)."""
    return int(key[0]) if isinstance(key, tuple) else int(key)


def _key_order(key: Hashable):
    """Deterministic pop order: by client, then phase name, then launch.
    Within one tie-tick this sorts `adapter_sync` (a step's completion)
    before the same client's `client_compute` of the next step, so a
    completed step's launch counter is settled before the pipeline asks
    whether the following compute may start."""
    if isinstance(key, tuple):
        return (int(key[0]), str(key[1]), int(key[2]))
    return (int(key), "", -1)


class EventQueue:
    """Event-driven simulated clock over phase-completion events.

    Keys are `(client, phase, launch)` tuples — phase is one of
    runtime.straggler.PHASES or PHASE_STEP for a whole un-overlapped step
    (plain int keys are accepted for backward compatibility and mean
    "one whole step for client int").  Each key has one pending
    completion time; `pop_next` advances the clock to the earliest
    pending completion and returns every key finishing at that instant
    (ties within a relative tolerance are batched into one tick, so a
    constant-speed fleet reduces to lockstep rounds).  The clock is
    monotone non-decreasing — pinned by tests/test_scheduler_equiv.py."""

    def __init__(self, now: float = 0.0):
        self.now = float(now)
        self._pending: Dict[Hashable, float] = {}

    def __len__(self) -> int:
        return len(self._pending)

    def push(self, key: Hashable, finish_time: float):
        if finish_time < self.now:
            raise ValueError(
                f"completion at t={finish_time} is before the clock "
                f"(t={self.now}); events cannot land in the past")
        self._pending[key] = float(finish_time)

    def pop_next(self, *, tol: float = 1e-9) -> Tuple[float, List]:
        """(time, ordered keys) of the earliest completion tick."""
        if not self._pending:
            raise ValueError("no pending events (no clients in flight)")
        t = min(self._pending.values())
        eps = tol * max(1.0, abs(t))
        who = sorted((k for k, ft in self._pending.items()
                      if ft <= t + eps), key=_key_order)
        for k in who:
            del self._pending[k]
        self.now = max(self.now, t)
        return t, who

    # -- membership -----------------------------------------------------
    def clients(self) -> set:
        """Set of client ids with at least one pending event."""
        return {event_client(k) for k in self._pending}

    def discard_client(self, client: int) -> int:
        """Drop every pending event of `client` (elastic leave mid-
        flight); returns how many were dropped."""
        gone = [k for k in self._pending if event_client(k) == client]
        for k in gone:
            del self._pending[k]
        return len(gone)

    # -- checkpoint round-trip (msgpack-friendly plain types) -----------
    def state_dict(self) -> Dict:
        return {"now": self.now,
                "events": [[list(k) if isinstance(k, tuple) else int(k), t]
                           for k, t in sorted(self._pending.items(),
                                              key=lambda kv:
                                              _key_order(kv[0]))]}

    @classmethod
    def from_state_dict(cls, d: Dict) -> "EventQueue":
        q = cls(now=float(d.get("now", 0.0)))
        for k, t in (d.get("events") or []):
            key = ((int(k[0]), str(k[1]), int(k[2]))
                   if isinstance(k, (list, tuple)) else int(k))
            q._pending[key] = float(t)
        # pre-phase checkpoints stored {"pending": {client: time}}
        for c, t in (d.get("pending") or {}).items():
            q._pending[int(c)] = float(t)
        return q


class AsyncScheduler(RoundScheduler):
    """FedBuff-style buffered asynchrony (see module docstring).

    Unlike the barrier policies this scheduler is *stateful*: it owns the
    event queue (phase-completion times on the simulated clock),
    per-client launch counters (which local round each client is running,
    also the client's deterministic batch index), the per-round tick
    accounting, and — under `overlap` — the pipeline bookkeeping (which
    compute phases have been scheduled/finished and when each transfer
    channel frees up).  The authoritative buffer/version arrays live in
    engine state (rounds.with_async_buffer) so they checkpoint with the
    model; the host-side pieces here round-trip via state_dict()."""

    name = "async"
    needs_speed = True

    def __init__(self, *, buffer_size: int = 2,
                 staleness_power: float = 0.5, overlap: bool = False):
        if buffer_size < 1:
            raise ValueError(
                f"buffer_size must be >= 1, got {buffer_size}")
        if staleness_power < 0:
            raise ValueError(f"staleness_power must be >= 0, got "
                             f"{staleness_power}")
        self.buffer_size = buffer_size
        self.staleness_power = staleness_power
        self.overlap = overlap
        self.queue: Optional[EventQueue] = None
        self.launches: Optional[np.ndarray] = None   # (N,) int: completed
        self.round_steps: Optional[np.ndarray] = None  # ticks since agg
        self.last_agg_clock = 0.0
        # per-client serial one-step time at the launch the client most
        # recently ran — the flush record reports THESE, not a fresh
        # full-fleet draw at the aggregation-round index
        self.last_times: Optional[np.ndarray] = None
        # overlap pipeline bookkeeping (all zeros / unused when serial):
        # csched/cfin count scheduled/finished compute phases per client;
        # eu/es/ed/ea are each stage's scheduled-busy-until times (the
        # per-client server lane is serialized too, so a later launch
        # with a shorter server phase can never complete before an
        # earlier one — steps finish in launch order by construction)
        self.csched: Optional[np.ndarray] = None
        self.cfin: Optional[np.ndarray] = None
        self.eu: Optional[np.ndarray] = None
        self.es: Optional[np.ndarray] = None
        self.ed: Optional[np.ndarray] = None
        self.ea: Optional[np.ndarray] = None
        # clients whose completion flushed the buffer: they relaunch only
        # AFTER the round epilogue (C3 may move their cut, which changes
        # their next completion time — and they are exactly the clients
        # that just received the new global model)
        self.pending_relaunch: List[int] = []

    @property
    def started(self) -> bool:
        return self.queue is not None

    def start(self, num_clients: int, *, clock: float = 0.0):
        """Reset the simulation: all clients about to launch round 0."""
        self.queue = EventQueue(now=clock)
        self.launches = np.zeros(num_clients, np.int64)
        self.round_steps = np.zeros(num_clients, np.int64)
        self.last_agg_clock = float(clock)
        self.last_times = np.zeros(num_clients, np.float64)
        self.csched = np.zeros(num_clients, np.int64)
        self.cfin = np.zeros(num_clients, np.int64)
        self.eu = np.zeros(num_clients, np.float64)
        self.es = np.zeros(num_clients, np.float64)
        self.ed = np.zeros(num_clients, np.float64)
        self.ea = np.zeros(num_clients, np.float64)
        self.pending_relaunch = []

    def reset_client(self, i: int):
        """Forget client i's in-flight pipeline (elastic leave dropped
        its events); the next launch starts a fresh pipeline at the
        current clock with the client's next batch index."""
        self.csched[i] = self.cfin[i] = self.launches[i]
        now = self.queue.now if self.queue is not None else 0.0
        self.eu[i] = self.es[i] = self.ed[i] = self.ea[i] = now

    def plan(self, *, active, times=None, phases=None,
             round_idx: int = 0, available=None) -> RoundPlan:
        raise NotImplementedError(
            "the async scheduler has no per-round barrier plan; "
            "SplitFTSystem drives it through the event-queue host loop "
            "(trace availability defers each LAUNCH to the client's "
            "next-available instant instead of masking rounds)")

    # -- checkpoint round-trip ------------------------------------------
    def state_dict(self) -> Dict:
        if not self.started:
            return {}
        return {
            "queue": self.queue.state_dict(),
            "launches": self.launches.tolist(),
            "round_steps": self.round_steps.tolist(),
            "last_agg_clock": self.last_agg_clock,
            "last_times": self.last_times.tolist(),
            "csched": self.csched.tolist(),
            "cfin": self.cfin.tolist(),
            "eu": self.eu.tolist(),
            "es": self.es.tolist(),
            "ed": self.ed.tolist(),
            "ea": self.ea.tolist(),
            "pending_relaunch": list(self.pending_relaunch),
        }

    def load_state_dict(self, d: Dict):
        if not d:
            return
        self.queue = EventQueue.from_state_dict(d["queue"])
        self.launches = np.asarray(d["launches"], np.int64)
        self.round_steps = np.asarray(d["round_steps"], np.int64)
        self.last_agg_clock = float(d["last_agg_clock"])
        n = self.launches.shape[0]
        # None (not zeros) when restoring a pre-phase checkpoint: the
        # host loop re-seeds real per-launch draws before the first
        # flush, so C3's straggler detection never sees fake 0.0 times
        self.last_times = (np.asarray(d["last_times"], np.float64)
                           if "last_times" in d else None)
        self.csched = np.asarray(d.get("csched", self.launches), np.int64)
        self.cfin = np.asarray(d.get("cfin", self.launches), np.int64)
        self.eu = np.asarray(d.get("eu", np.zeros(n)), np.float64)
        self.es = np.asarray(d.get("es", np.zeros(n)), np.float64)
        self.ed = np.asarray(d.get("ed", np.zeros(n)), np.float64)
        self.ea = np.asarray(d.get("ea", np.zeros(n)), np.float64)
        self.pending_relaunch = [int(i)
                                 for i in d.get("pending_relaunch", [])]


def make_scheduler(name: str, *, deadline_frac: float = 1.5,
                   max_local_steps: int = 4, buffer_size: int = 2,
                   staleness_power: float = 0.5,
                   overlap_comm: bool = False) -> RoundScheduler:
    if name == "sync":
        return SyncScheduler()
    if name == "deadline":
        return DeadlineScheduler(deadline_frac=deadline_frac)
    if name == "local_steps":
        return LocalStepsScheduler(max_steps=max_local_steps,
                                   overlap=overlap_comm)
    if name == "async":
        return AsyncScheduler(buffer_size=buffer_size,
                              staleness_power=staleness_power,
                              overlap=overlap_comm)
    raise ValueError(
        f"unknown scheduler {name!r}; known: {SCHEDULERS}")
