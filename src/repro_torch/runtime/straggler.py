"""Straggler modeling and mitigation.

A numpy copy of src/repro/runtime/straggler.py (the port imports nothing of the
JAX package); tests/test_torch_host_loop.py pins it bitwise against
the reference on seeded inputs.

On real federated hardware, per-round time = max over clients of
(client compute + smashed-data transfer).  On a TPU pod the SPMD program
gives every "client" identical silicon, so heterogeneity is *simulated*
with a per-client speed model; the mitigation policies are the real
deliverable and transfer unchanged to physical deployments:

  * deadline-based partial aggregation — clients that would exceed the
    round deadline are excluded from this round's FedAvg (survivor
    re-weighting keeps the estimator unbiased w.r.t. sample counts);
  * speed-proportional local steps — instead of dropping the slow or
    stalling the fast, each client gets a step budget K_i so that
    K_i * t_i lands near the barrier (consumed by the local_steps
    scheduler, repro.core.scheduler);
  * adaptive cut (paper C3) doubles as straggler mitigation: slow clients
    shed layers, directly reducing their round time;
  * overlapped communication — a split-learning step is not one opaque
    duration but a PIPELINE of phases (client compute -> f2 uplink ->
    server compute -> f4 gradient downlink -> adapter sync).  With
    double buffering the client may compute step k+1 while step k's
    transfers are in flight, so wire time hides behind compute instead
    of adding to it.  `SpeedModel.phase_times` exposes the per-phase
    durations; `pipelined_makespan` is the double-buffered clock the
    overlap-aware schedulers charge.

The phase decomposition mirrors comm.py's per-channel byte split:
f2/f4 are the smashed-activation channel (one uplink + one downlink per
local step), adapter sync is the b1/b3 channel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

# Phase order of one split-learning local step.  `phase_times` returns
# one row per entry; the serial clock is the column sum; the event-queue
# host loop tags its events with these names.
PHASES = ("client_compute", "f2_uplink", "server_compute",
          "f4_downlink", "adapter_sync")


@dataclasses.dataclass
class SpeedModel:
    """Per-client relative compute speed (1.0 = reference) and link
    bandwidth (bytes/s), lognormally drawn."""

    num_clients: int
    seed: int = 0
    speed_sigma: float = 0.5
    bw_mean: float = 100e6          # 100 MB/s WAN-ish uplink
    bw_sigma: float = 0.7
    jitter_sigma: float = 0.1       # per-round multiplicative noise
    server_flops_per_s: float = 0.0  # 0 -> server compute is free (the
                                     # datacenter server is never the
                                     # bottleneck; legacy clock parity)
    server_ingest_bw: float = 0.0    # >0 -> the server's shared adapter-
                                     # sync ingest link (bytes/s): flat
                                     # aggregation serializes EVERY
                                     # client's b1 upload through it;
                                     # hierarchical (edge_assign) only
                                     # one pre-aggregated update per
                                     # edge group.  0 = infinite ingest
                                     # (legacy clock, bitwise)
    edge_bw: float = 0.0             # >0 -> client->edge hop bandwidth
                                     # (bytes/s) charged per client under
                                     # hierarchical aggregation; 0 = free

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        self.speed = np.exp(rng.normal(0.0, self.speed_sigma,
                                       self.num_clients))
        self.bandwidth = self.bw_mean * np.exp(
            rng.normal(0.0, self.bw_sigma, self.num_clients))
        # Optional non-stationarity (runtime/traces.py): a Trace
        # provider queried at each launch's simulated start time whose
        # (speed, bandwidth) factors multiply the stationary draws and
        # whose availability gates participation.  None = stationary
        # clock, bitwise.  trace_pids maps slot i -> population id so
        # the series survive cohort churn (fleet mode: pid == slot).
        self.trace = None
        self.trace_pids = None
        # Population mode installs per-pid jitter seeds here so a pid's
        # per-round noise is an attribute of the CLIENT, not of the
        # cohort slot it landed in.  None = legacy positional draw.
        self.jitter_seeds = None

    def _pids(self) -> np.ndarray:
        return (np.arange(self.num_clients)
                if self.trace_pids is None
                else np.asarray(self.trace_pids, np.int64))

    def available_mask(self, t: float) -> np.ndarray:
        """(N,) bool availability at simulated time t (all-true without
        a trace)."""
        if self.trace is None:
            return np.ones(self.num_clients, bool)
        return np.asarray(self.trace.sample(float(t), self._pids())[2],
                          bool)

    def next_available(self, i: int, t: float) -> float:
        """Earliest instant >= t at which client slot i is available."""
        if self.trace is None:
            return float(t)
        return float(self.trace.next_available(
            float(t), int(self._pids()[i])))

    def phase_times(self, *, cuts: Sequence[int], flops_per_layer: float,
                    smashed_bytes, adapter_bytes: Sequence[float],
                    round_idx: int = 0, ref_flops_per_s: float = 5e12,
                    server_layers: Optional[Sequence[int]] = None,
                    smashed_down_bytes=None,
                    edge_assign: Optional[Sequence[int]] = None,
                    num_edges: int = 1,
                    jitter: bool = True,
                    start_time: float = 0.0,
                    apply_trace: bool = True) -> np.ndarray:
        """(5, N) per-client phase durations for one local step.

        Rows follow `PHASES`: client compute (cut_i layers of
        forward+backward on the client device), f2 smashed uplink,
        server compute ((L - cut_i) layers at `server_flops_per_s`; zero
        when that rate is 0 — the legacy model), f4 gradient downlink
        (`smashed_down_bytes`; defaults to the uplink size — every
        current compressor is symmetric), and the b1/b3 adapter sync.
        The per-round jitter draw scales every phase, so the serial
        column sum preserves the legacy single-duration clock's
        semantics.

        smashed_bytes / smashed_down_bytes may be scalars or (N,) arrays
        (per-client compressor choices produce per-client payloads).
        jitter=False disables the per-round noise draw — the EXPECTED
        phase times the adaptive co-controller prices candidate (cut,
        rank, compressor) assignments with; with jitter_sigma == 0 the
        jittered and unjittered clocks coincide exactly, which is what
        makes predicted-vs-simulated makespan testable.

        server_ingest_bw > 0 adds the server's SHARED adapter-ingest
        serialization to the adapter_sync row (un-jittered; it is the
        server's link, not the client's): flat topology pushes every
        client's b1 bytes through it, while hierarchical aggregation
        (edge_assign (N,) group ids + num_edges > 1) pushes one
        pre-aggregated update per edge group — sum over groups of the
        group's largest member payload — plus a per-client client->edge
        hop at edge_bw.  With at least one multi-member group the
        hierarchical charge is strictly smaller; with
        server_ingest_bw == 0 the row is the legacy clock bitwise.

        start_time is the launch's position on the simulated clock: with
        a `trace` provider installed the stationary (speed, bandwidth)
        draws are multiplied by the trace's factors at that instant
        (piecewise-constant per trace window).  Without a trace — or
        with a constant trace of 1.0 factors — the clock is the
        stationary model bitwise.  apply_trace=False ignores the
        installed trace entirely (the stationary view the time-model
        layer's analytic pricer and EWMA baselines are built on)."""
        if jitter:
            if self.jitter_seeds is not None:
                # pid-keyed: fold the round index into each client's own
                # seed stream so the draw is independent of cohort slot
                js = np.asarray(self.jitter_seeds, np.int64)
                jit = np.empty(self.num_clients, np.float64)
                for i in range(self.num_clients):
                    rng = np.random.RandomState(
                        (int(js[i]) + round_idx * 7919) & 0x7FFFFFFF)
                    jit[i] = np.exp(self.jitter_sigma
                                    * rng.normal(0.0, 1.0))
            else:
                rng = np.random.RandomState(round_idx * 7919 + self.seed)
                jit = np.exp(rng.normal(0.0, self.jitter_sigma,
                                        self.num_clients))
        else:
            jit = np.ones(self.num_clients)
        speed, bandwidth = self.speed, self.bandwidth
        if self.trace is not None and apply_trace:
            tsp, tbw, _ = self.trace.sample(float(start_time),
                                            self._pids())
            speed = speed * tsp
            bandwidth = bandwidth * tbw
        cuts = np.asarray(cuts, np.float64)
        client = cuts * flops_per_layer * 3.0 / \
            (ref_flops_per_s * speed) * jit
        up = np.asarray(smashed_bytes, np.float64)
        down = (up if smashed_down_bytes is None
                else np.asarray(smashed_down_bytes, np.float64))
        f2 = up / bandwidth * jit
        f4 = down / bandwidth * jit
        adapter = np.asarray(adapter_bytes, np.float64) \
            / bandwidth * jit
        if self.server_ingest_bw > 0:
            ab = np.broadcast_to(
                np.asarray(adapter_bytes, np.float64),
                (self.num_clients,)).astype(np.float64)
            if edge_assign is not None and num_edges > 1:
                ea = np.asarray(edge_assign, np.int64) % num_edges
                per_edge = np.zeros(num_edges, np.float64)
                np.maximum.at(per_edge, ea, ab)
                ingest = per_edge.sum() / self.server_ingest_bw
                if self.edge_bw > 0:
                    adapter = adapter + ab / self.edge_bw
            else:
                ingest = ab.sum() / self.server_ingest_bw
            adapter = adapter + ingest
        if self.server_flops_per_s > 0 and server_layers is not None:
            server = np.asarray(server_layers, np.float64) \
                * flops_per_layer * 3.0 / self.server_flops_per_s * jit
        else:
            server = np.zeros(self.num_clients, np.float64)
        return np.stack([client, f2, server, f4, adapter])

    def round_times(self, *, cuts: Sequence[int], flops_per_layer: float,
                    smashed_bytes: float, adapter_bytes: Sequence[float],
                    round_idx: int = 0,
                    ref_flops_per_s: float = 5e12,
                    start_time: float = 0.0) -> np.ndarray:
        """Serial wall-clock estimate per client for one round: the
        column sum of `phase_times` (compute, then each wire phase back
        to back — no overlap)."""
        return serial_step_times(self.phase_times(
            cuts=cuts, flops_per_layer=flops_per_layer,
            smashed_bytes=smashed_bytes, adapter_bytes=adapter_bytes,
            round_idx=round_idx, ref_flops_per_s=ref_flops_per_s,
            start_time=start_time))


def population_speed_draws(pids: Sequence[int], *, seed: int = 0,
                           speed_sigma: float = 0.5,
                           bw_mean: float = 100e6,
                           bw_sigma: float = 0.7
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-POPULATION-ID (speed, bandwidth, jitter-seed) draws.

    SpeedModel's fleet draws are positional (client slot i), which breaks
    under cohort sampling: slot i holds a different pid every round.
    These draws are keyed by pid — each pid seeds its own tiny RNG — so a
    client's speed is a stable attribute that survives cohort churn,
    restore, and population growth (pid p draws the same pair whether the
    population is 10^3 or 10^6).  With both sigmas 0 every pid gets
    (1.0, bw_mean), matching a sigma-0 SpeedModel exactly.

    The third array is each pid's jitter seed: the pid-keyed stream
    `SpeedModel.phase_times` folds the round index into (installed as
    `SpeedModel.jitter_seeds` by the cohort loop), so per-round jitter
    is also slot-independent.  It is a pure hash of (pid, seed) — no RNG
    state is consumed, so the (speed, bandwidth) pairs are unchanged."""
    pids = np.asarray(pids, np.int64)
    speed = np.empty(pids.shape[0], np.float64)
    bw = np.empty(pids.shape[0], np.float64)
    jseed = np.empty(pids.shape[0], np.int64)
    for j, pid in enumerate(pids):
        rng = np.random.RandomState(
            (int(pid) * 2654435761 + seed * 1000003 + 17) & 0x7FFFFFFF)
        z = rng.normal(0.0, 1.0, 2)
        speed[j] = np.exp(speed_sigma * z[0])
        bw[j] = bw_mean * np.exp(bw_sigma * z[1])
        jseed[j] = (int(pid) * 2654435761
                    + seed * 1000003 + 9176) & 0x7FFFFFFF
    return speed, bw, jseed


def serial_step_times(phases: np.ndarray) -> np.ndarray:
    """(5, N) phase durations -> (N,) serial one-step times.

    THE canonical serial reduction: every scheduler that charges
    un-overlapped steps must sum phases through this helper so the
    barrier and event-queue clocks stay bitwise comparable."""
    out = np.zeros(phases.shape[1], np.float64)
    for row in np.asarray(phases, np.float64):
        out = out + row
    return out


def pipelined_makespan(phases: np.ndarray,
                       steps: Sequence[int]) -> np.ndarray:
    """(N,) makespan of `steps[i]` pipelined local steps per client.

    Double-buffered overlap with one outstanding transfer per direction:
    compute of step k may start once compute of k-1 is done AND step k-2
    has fully completed (its f4 gradient applied and adapters synced), so
    at most two steps are ever in flight and the client trains at
    staleness <= 1.  Each channel (f2 uplink, f4 downlink, adapter sync)
    serializes its own transfers.  With zero wire time this degenerates
    to the serial compute chain bitwise; with zero compute it degenerates
    to back-to-back transfers."""
    phases = np.asarray(phases, np.float64)
    steps = np.asarray(steps, np.int64)
    c, u, s, d, a = phases
    n = phases.shape[1]
    out = np.zeros(n, np.float64)
    for i in range(n):
        ec = eu = ed = ea = 0.0     # last end per resource
        ea_km1 = ea_km2 = 0.0       # end_A(k-1) / end_A(k-2)
        for _ in range(int(steps[i])):
            sc = max(ec, ea_km2)
            ec = sc + c[i]
            su = max(ec, eu)
            eu = su + u[i]
            es = eu + s[i]
            sd = max(es, ed)
            ed = sd + d[i]
            sa = max(ed, ea)
            ea = sa + a[i]
            ea_km2 = ea_km1
            ea_km1 = ea
        out[i] = ea
    return out


def overlap_step_budgets(phases: np.ndarray, *, max_steps: int,
                         active: Optional[np.ndarray] = None
                         ) -> np.ndarray:
    """Per-client budgets under the overlapped pipeline: the largest
    K_i <= max_steps whose pipelined makespan still fits the sync
    barrier t_max (the slowest active client's serial one-step time).

    Pipelining makes extra steps cheaper than serial ones (wire time
    hides behind compute), so K_i here is >= the serial
    `local_step_budgets` everywhere — fast clients pack MORE useful
    steps into the same barrier instead of finishing early.  With zero
    wire time the makespan is the serial compute chain and the budgets
    coincide with the serial rule's (up to fp rounding at exact barrier
    multiples).  Inactive clients get budget 0."""
    phases = np.asarray(phases, np.float64)
    t = serial_step_times(phases)
    act = (np.ones_like(t) if active is None
           else np.asarray(active, np.float64))
    sel = act > 0
    if not sel.any():
        return np.zeros(t.shape, np.int64)
    t_max = float(t[sel].max())
    c, u, s, d, a = phases
    budgets = np.zeros(t.shape, np.int64)
    for i in np.where(sel)[0]:
        # extend one incremental recurrence (identical arithmetic to
        # pipelined_makespan) and stop at the first k past the barrier:
        # the makespan is monotone in k
        ec = eu = ed = ea = 0.0
        ea_km1 = ea_km2 = 0.0
        best = 1
        for k in range(1, max_steps + 1):
            sc = max(ec, ea_km2)
            ec = sc + c[i]
            su = max(ec, eu)
            eu = su + u[i]
            es = eu + s[i]
            sd = max(es, ed)
            ed = sd + d[i]
            sa = max(ed, ea)
            ea = sa + a[i]
            ea_km2 = ea_km1
            ea_km1 = ea
            if ea > t_max:
                break
            best = k
        budgets[i] = best
    return budgets


def local_step_budgets(times: np.ndarray, *, max_steps: int,
                       active: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-client local-step budgets K_i = clamp(floor(t_max/t_i), 1, cap).

    t_max is the slowest *active* client's one-step time (the sync
    barrier), so K_i * t_i <= t_max: every client finishes its budget
    near the moment the slowest finishes its single step.  Inactive
    clients get budget 0."""
    t = np.asarray(times, np.float64)
    act = (np.ones_like(t) if active is None
           else np.asarray(active, np.float64))
    sel = act > 0
    if not sel.any():
        return np.zeros(t.shape, np.int64)
    t_max = float(t[sel].max())
    k = np.floor(t_max / np.maximum(t, 1e-12)).astype(np.int64)
    k = np.clip(k, 1, max_steps)
    return np.where(sel, k, 0)


def deadline_survivors(times: np.ndarray, *, deadline_frac: float = 1.5,
                       active: Optional[np.ndarray] = None
                       ) -> Tuple[np.ndarray, float]:
    """Clients finishing within deadline_frac x median time survive.

    The median — and therefore the deadline — is computed over ACTIVE
    clients only: a departed (elastic-leave) client's stale time estimate
    must not skew the deadline and evict healthy survivors.  Returns
    (bool mask restricted to active clients, deadline).  Always keeps at
    least one active client (the fastest)."""
    t = np.asarray(times, np.float64)
    act = (np.ones(t.shape, bool) if active is None
           else np.asarray(active, np.float64) > 0)
    if not act.any():
        return np.zeros(t.shape, bool), 0.0
    med = float(np.median(t[act]))
    deadline = deadline_frac * med
    mask = act & (t <= deadline)
    if not mask.any():
        # exactly ONE survivor, as documented: the single deterministic
        # argmin over active clients (float-equality against the min
        # could keep several tied clients, making the fallback round's
        # aggregate depend on how ties happened to materialize)
        idx = np.flatnonzero(act)
        mask = np.zeros(t.shape, bool)
        mask[idx[int(np.argmin(t[idx]))]] = True
    return mask, deadline
