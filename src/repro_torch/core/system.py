"""SplitFTSystem — host-side orchestration of the paper workflow.

Port of src/repro/core/system.py, the barrier loop in fleet mode.  It
owns: corpus -> tokenize -> partition (C4) -> per-client loaders ->
round loop -> eval, C3 adjustment, aggregation weights,
checkpoint/resume, elastic membership.

The round loop is split engine/policy:

  * the *engine* is the round step of repro_torch.core.rounds; which
    clients run in a round is data (the `active` mask);
  * the *policy* is a barrier RoundScheduler (repro_torch.core.
    scheduler): sync (Algorithm 1 lockstep) or deadline (straggler
    drop).  The scheduler also owns the simulated wall-clock accounting
    (`sim_time` / cumulative `sim_clock` in the round records), priced
    per phase by runtime.straggler's SpeedModel under an optional
    heterogeneity trace (runtime.traces) and time model
    (runtime.timemodel).

C3 runs in the round epilogue (`_adjust_c3`): the global model is
evaluated per client, then either the paper's `accuracy` controller
moves the cuts by per-client accuracy, or the phase-time `co` controller
(adaptive.co_adjust) picks each client's (cut, rank-at-cut, smashed
compressor) triple, and with continuous_topk its topk keep fraction, by
the predicted round time (`predict_round_times`) inside an accuracy
dead-band.  The new policy is written into round state as host tensors,
so it re-masks the next engine call.

Device and randomness: the model, its base parameters and the adapters
and optimizer slots of the round state live on `device` (the card unless
the caller names the CPU); `cuts` and `round` are int32 host tensors.
The reference draws base parameters and state from jax.random.PRNGKey
(seed); here a torch.Generator seeded with `seed` draws the base
parameters and one seeded with `seed + 1` the round state, so the two
packages start from different weights at one seed (parity tests copy the
reference's weights in through repro_torch.bridge).  Data, loaders, the
speed model and traces are numpy and seeded exactly as the reference's.

Options outside this path raise NotImplementedError in the constructor,
naming the ROADMAP item that ports them: adapter compression, agg_every
> 1, smashed error feedback, two-tier aggregation, local steps, the
local_steps and async schedulers, and population mode.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import bridge, roadmap
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import ArchConfig
from repro_torch.core import adaptive, comm, rounds, smashed
from repro_torch.core import scheduler as scheduler_lib
from repro_torch.core.scheduler import RoundPlan
from repro_torch.core.split import serve_adapters
from repro_torch.data import (make_client_loaders, partition_dataset,
                              synthetic_corpus)
from repro_torch.data.pipeline import stack_client_batches
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import build_model
from repro_torch.runtime import straggler
from repro_torch.runtime import timemodel
from repro_torch.runtime import traces as traces_lib
from repro_torch.runtime.elastic import ClientPool
from repro_torch.runtime.straggler import SpeedModel


@dataclasses.dataclass
class SystemConfig:
    """The reference's SystemConfig, field for field (names, defaults);
    see src/repro/core/system.py for each field's meaning."""
    num_samples: int = 2000
    eval_samples: int = 256
    adjust_every: int = 1
    agg_every: int = 1
    compress: str = "none"
    topk_frac: float = 0.05
    smashed_compress: Optional[str] = None
    smashed_topk_frac: Optional[float] = None
    smashed_ef: Optional[bool] = None
    scheduler: Optional[str] = None
    max_local_steps: Optional[int] = None
    straggler_sim: bool = False
    deadline_frac: Optional[float] = None
    buffer_size: Optional[int] = None
    staleness_power: Optional[float] = None
    overlap_comm: Optional[bool] = None
    speed_sigma: Optional[float] = None
    bw_sigma: Optional[float] = None
    jitter_sigma: Optional[float] = None
    bw_mean: Optional[float] = None
    client_flops_per_s: Optional[float] = None
    server_flops_per_s: Optional[float] = None
    server_ingest_bw: Optional[float] = None
    edge_bw: Optional[float] = None
    population: Optional[int] = None
    edge_groups: Optional[int] = None
    server_step_norm: Optional[bool] = None
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0
    keep_checkpoints: int = 3
    adaptive: Optional[bool] = None
    controller: Optional[str] = None
    rank_buckets: Optional[tuple] = None
    compressor_buckets: Optional[tuple] = None
    acc_dead_band: Optional[float] = None
    min_gain: Optional[float] = None
    trace: Optional[str] = None
    trace_gen: Optional[str] = None
    time_source: Optional[str] = None
    ewma_alpha: float = 0.3
    model_seed: Optional[int] = None
    record_trace: Optional[str] = None
    continuous_topk: Optional[bool] = None


def _pick(value, default):
    return default if value is None else value


def _np(x) -> np.ndarray:
    """A tensor (any device) or array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _refuse_unported(arch: ArchConfig, s: SystemConfig, *, scheduler: str,
                     use_ef: bool) -> None:
    """NotImplementedError for the first option that leaves the barrier
    loop in fleet mode, naming it as SystemConfig does."""
    population = _pick(s.population, arch.data.population) or 0
    refused = [
        (population > 0, f"population={population}", roadmap.POPULATION),
        (s.compress != "none", f"compress={s.compress!r}",
         roadmap.ENGINE_OPTIONS),
        (s.agg_every > 1, f"agg_every={s.agg_every}",
         roadmap.ENGINE_OPTIONS),
        (use_ef, "smashed_ef=True (error feedback on the smashed "
         "channel; pass smashed_ef=False for topk without it)",
         roadmap.ENGINE_OPTIONS),
        ((_pick(s.edge_groups, arch.split.edge_groups) or 1) > 1,
         f"edge_groups={_pick(s.edge_groups, arch.split.edge_groups)}",
         roadmap.ENGINE_OPTIONS),
        ((s.max_local_steps or 1) > 1,
         f"max_local_steps={s.max_local_steps}", roadmap.ENGINE_OPTIONS),
        (scheduler in ("local_steps", "async"), f"scheduler={scheduler!r}",
         roadmap.ENGINE_OPTIONS),
    ]
    for bad, what, item in refused:
        if bad:
            raise NotImplementedError(
                f"SystemConfig {what} is not ported yet ({item}); the port "
                "runs the sync and deadline barrier loop in fleet mode "
                "with the accuracy and co controllers")


class SplitFTSystem:
    def __init__(self, arch: ArchConfig, sys_cfg: SystemConfig = None, *,
                 seed: int = 0, device: DeviceLike = None):
        self.arch = arch
        self.sys = sys_cfg or SystemConfig()
        self.seed = seed
        self.device = resolve_device(device)

        sched_name = self.sys.scheduler
        if sched_name is None:
            sched_name = arch.split.scheduler
            if sched_name == "sync" and self.sys.straggler_sim:
                sched_name = "deadline"   # legacy: straggler_sim == drop
        self.smashed_compress = _pick(self.sys.smashed_compress,
                                      arch.split.smashed_compress)
        self.smashed_topk_frac = _pick(self.sys.smashed_topk_frac,
                                       arch.split.smashed_topk_frac)
        self.controller = _pick(self.sys.controller, arch.split.controller)
        if self.controller not in ("accuracy", "co"):
            raise ValueError(f"unknown C3 controller "
                             f"{self.controller!r}; known: accuracy, co")
        use_ef = bool(_pick(self.sys.smashed_ef,
                            self.smashed_compress == "topk"))
        self._co_search_space(use_ef)
        _refuse_unported(arch, self.sys, scheduler=sched_name,
                         use_ef=use_ef)

        self.model = build_model(arch, device=self.device)
        n = arch.data.num_clients
        self.pool = ClientPool(n)

        # ---- data (C4) ----
        tok = HashTokenizer(arch.model.vocab_size)
        texts = synthetic_corpus(self.sys.num_samples, seed=arch.data.seed)
        self.samples = [np.asarray(tok.encode(t), np.int32) for t in texts]
        self.parts = partition_dataset(
            [len(s) for s in self.samples], n, strategy=arch.data.partition,
            alpha=arch.data.alpha, num_classes=arch.data.num_length_classes,
            seed=arch.data.seed)
        eval_texts = synthetic_corpus(self.sys.eval_samples,
                                      seed=arch.data.seed + 777)
        eval_tokens = [np.asarray(tok.encode(t), np.int32)
                       for t in eval_texts]
        self.loaders = make_client_loaders(
            self.samples, self.parts, batch_size=arch.train.batch_size,
            seq_len=arch.train.seq_len, seed=seed)
        self.eval_loaders = make_client_loaders(
            eval_tokens, [np.arange(len(eval_tokens))] * n,
            batch_size=arch.train.batch_size,
            seq_len=arch.train.seq_len, seed=seed + 999)

        # ---- round scheduler (policy) + straggler simulation ----
        self.overlap_comm = _pick(self.sys.overlap_comm,
                                  arch.split.overlap_comm)
        self.scheduler = scheduler_lib.make_scheduler(
            sched_name,
            deadline_frac=_pick(self.sys.deadline_frac,
                                arch.split.deadline_frac),
            overlap_comm=self.overlap_comm)
        speed_kw = {k: getattr(self.sys, k)
                    for k in ("speed_sigma", "bw_sigma", "jitter_sigma",
                              "bw_mean", "server_flops_per_s",
                              "server_ingest_bw", "edge_bw")
                    if getattr(self.sys, k) is not None}
        if self.sys.trace and self.sys.trace_gen:
            raise ValueError("set --trace (replay a recorded file) or "
                             "--trace-gen (synthetic generator), not "
                             "both")
        # the co-controller prices candidates with SpeedModel.phase_times,
        # so it always carries a speed model
        self.speed = (SpeedModel(n, seed=seed, **speed_kw)
                      if (self.sys.straggler_sim
                          or self.scheduler.needs_speed
                          or self.controller == "co"
                          or self.sys.trace or self.sys.trace_gen)
                      else None)
        if self.sys.trace:
            self.speed.trace = traces_lib.load_trace(self.sys.trace)
        elif self.sys.trace_gen:
            self.speed.trace = traces_lib.make_trace_gen(
                self.sys.trace_gen, seed=seed)

        # ---- time-model layer (runtime/timemodel.py) ----
        # the clock always charges the jittered SpeedModel; time_source
        # selects what the controller's predictions are built from
        src = self.sys.time_source
        if src is not None and src not in timemodel.TIME_SOURCES:
            raise ValueError(f"unknown time_source {src!r}; known: "
                             f"{timemodel.TIME_SOURCES}")
        if self.speed is None:
            for bad, what in ((src not in (None, "analytic"),
                               f"time_source={src!r}"),
                              (self.sys.record_trace, "record_trace"),
                              (self.sys.model_seed is not None,
                               "model_seed")):
                if bad:
                    raise ValueError(
                        f"{what} needs the simulated clock, but no "
                        "SpeedModel is attached; set straggler_sim=True, "
                        "a speed-model scheduler, or a trace")
        if src is None:
            src = ("trace" if (self.speed is not None
                               and self.speed.trace is not None)
                   else "analytic")
        if src == "trace" and (self.speed is None
                               or self.speed.trace is None):
            raise ValueError(
                "time_source='trace' prices candidates at the trace "
                "window, but no trace is installed; set trace/trace_gen "
                "(or use analytic/measured)")
        self.time_source = src
        model_sm = None
        if self.sys.model_seed is not None \
                and int(self.sys.model_seed) != seed:
            model_sm = SpeedModel(n, seed=int(self.sys.model_seed),
                                  **speed_kw)
            model_sm.trace = self.speed.trace
        self.pricer = (timemodel.make_pricer(
            src, self.speed, model_sm, ewma_alpha=self.sys.ewma_alpha)
            if self.speed is not None else None)
        self.recorder = (timemodel.TraceRecorder(self.speed)
                         if self.sys.record_trace else None)
        self._observing = (src == "measured"
                           or self.recorder is not None)
        self.sim_clock = 0.0           # cumulative simulated seconds

        # ---- model/state (engine) ----
        self.base_params = self.model.init_params(
            torch.Generator().manual_seed(seed))
        co = self.controller == "co"
        init_rank = int(self.rank_buckets[int(np.argmin(np.abs(
            np.asarray(self.rank_buckets) - arch.lora.r_cut)))])
        init_choice = (self.comp_buckets.index(self.smashed_compress)
                       if self.smashed_compress in self.comp_buckets
                       else 0)
        self.state = rounds.prepare_state(
            rounds.init_state(self.model,
                              torch.Generator().manual_seed(seed + 1),
                              num_clients=n),
            rank_cut=init_rank if co else None,
            smashed_choice=init_choice if co else None,
            topk_frac=(self.smashed_topk_frac
                       if (co and self.continuous_topk) else None))
        self.train_step = rounds.make_train_step(
            self.model, remat=arch.train.remat,
            smashed_compress=self.smashed_compress,
            smashed_topk_frac=self.smashed_topk_frac,
            compressor_buckets=self.comp_buckets if co else None)
        self.eval_step = rounds.make_eval_step(self.model)

        # ---- C3 state ----
        self.c3_weights = np.ones(n)
        self.sample_counts = np.array([l.num_samples()
                                       for l in self.loaders], float)
        self.ckpt = (CheckpointManager(self.sys.checkpoint_dir,
                                       keep=self.sys.keep_checkpoints)
                     if self.sys.checkpoint_dir else None)
        self.history: List[Dict[str, Any]] = []
        self._adaptive = _pick(self.sys.adaptive, arch.split.adaptive)

    def _co_search_space(self, use_ef: bool):
        """The co-controller's search space (cut x rank x compressor) and
        the reference's checks on it, which hold for either controller."""
        arch, s = self.arch, self.sys
        self.acc_dead_band = _pick(s.acc_dead_band, arch.split.acc_dead_band)
        self.min_gain = _pick(s.min_gain, arch.split.min_gain)
        rb = _pick(s.rank_buckets, arch.split.rank_buckets) \
            or (arch.lora.r_cut,)
        self.rank_buckets = tuple(sorted({int(r) for r in rb}))
        if any(r < 1 or r > arch.lora.r_others for r in self.rank_buckets):
            raise ValueError(
                f"rank_buckets {self.rank_buckets} must lie in "
                f"[1, r_others={arch.lora.r_others}] (adapters are "
                "allocated at r_others; ranks are masks, not shapes)")
        cbk = _pick(s.compressor_buckets, arch.split.compressor_buckets) \
            or (self.smashed_compress,)
        # bucket index order == aggressiveness order: weakest compression
        # (most wire bytes) first, so "one step weaker" is index - 1
        self.comp_buckets = tuple(sorted(
            dict.fromkeys(cbk),
            key=lambda nm: -smashed.wire_bytes(
                nm, batch=arch.train.batch_size, seq=arch.train.seq_len,
                d_model=arch.model.d_model,
                topk_frac=self.smashed_topk_frac)))
        self.continuous_topk = _pick(s.continuous_topk,
                                     arch.split.continuous_topk)
        if self.continuous_topk:
            if self.controller != "co":
                raise ValueError(
                    "continuous_topk is a co-controller search knob; "
                    f"set controller='co' (got {self.controller!r})")
            if "topk" not in self.comp_buckets:
                raise ValueError(
                    "continuous_topk tunes the topk compressor's keep "
                    "fraction, but 'topk' is not in the compressor "
                    f"buckets {self.comp_buckets}")
        if self.controller == "co" and use_ef:
            raise ValueError(
                "the co-controller's per-client compressor choice does "
                "not compose with smashed error feedback (the EF "
                "residual is sized for one compressor's remainder "
                "semantics); set smashed_ef=False")

    # ------------------------------------------------------------------
    def combined_weights(self) -> np.ndarray:
        """FedAvg weight |D_i|/|D| x C3 weight w_i (paper formula 2)."""
        p = self.pool.weights(self.sample_counts)
        w = p * self.c3_weights
        s = w.sum()
        return w / s if s > 0 else w

    def _weights32(self) -> np.ndarray:
        return self.combined_weights().astype(np.float32)

    def _train_batch(self, r: int):
        return stack_client_batches([l.batch(r) for l in self.loaders])

    def _eval_batch(self, r: int):
        return stack_client_batches([l.batch(r) for l in self.eval_loaders])

    def _cuts(self) -> np.ndarray:
        return _np(self.state["cuts"]).copy()

    # ------------------------------------------------------------------
    # round-loop pieces (one engine call + host-side policy around it)

    def _state_policy(self):
        """The co-controller's per-client (rank_cut, smashed_choice) from
        round state as numpy, (None, None) under the static policy."""
        rank = self.state.get("rank_cut")
        choice = self.state.get("smashed_choice")
        return (None if rank is None else _np(rank),
                None if choice is None else _np(choice))

    def _state_frac(self) -> Optional[np.ndarray]:
        """The co-controller's per-client topk keep fraction from round
        state, None under the static (bucket-only) policy."""
        frac = self.state.get("topk_frac")
        return None if frac is None else _np(frac).astype(np.float64)

    def _round_comm(self, cuts_np: np.ndarray, rank_np=None,
                    choice_np=None, frac_np=None) -> Dict[str, np.ndarray]:
        """Per-client comm bytes for a (cut, rank, compressor, frac)
        assignment: once per round for the state's policy (shared by the
        straggler model and the round record), and once per candidate
        when the co-controller prices moves."""
        arch = self.arch
        names = (self.smashed_compress if choice_np is None
                 else [self.comp_buckets[int(k)] for k in choice_np])
        return comm.round_comm_bytes(
            self.model, cuts=cuts_np,
            batch_size=arch.train.batch_size,
            seq_len=arch.train.seq_len,
            smashed_compress=names,
            smashed_topk_frac=(self.smashed_topk_frac
                               if frac_np is None else frac_np),
            rank_cut=rank_np)

    @property
    def _flops_layer(self) -> float:
        arch = self.arch
        return 12 * arch.model.d_model ** 2 \
            * arch.train.batch_size * arch.train.seq_len

    def _phase_kwargs(self, r: int, cuts_np: np.ndarray,
                      cb: Dict[str, np.ndarray],
                      start_time: Optional[float] = None
                      ) -> Dict[str, Any]:
        """The SpeedModel.phase_times argument set for one assignment,
        shared by the charged clock, the pricer's predictions and the
        telemetry baselines."""
        kw = dict(
            cuts=cuts_np, flops_per_layer=self._flops_layer,
            smashed_bytes=cb["smashed_up"],
            smashed_down_bytes=cb["smashed_down"],
            adapter_bytes=cb["adapter_up"], round_idx=r,
            server_layers=self.model.num_flat_layers - cuts_np,
            edge_assign=None, num_edges=1,
            start_time=(self.sim_clock if start_time is None
                        else start_time))
        if self.sys.client_flops_per_s is not None:
            kw["ref_flops_per_s"] = float(self.sys.client_flops_per_s)
        return kw

    def _round_phases(self, r: int, cuts_np: np.ndarray,
                      cb: Dict[str, np.ndarray], *,
                      jitter: bool = True,
                      start_time: Optional[float] = None
                      ) -> Optional[np.ndarray]:
        """(5, N) per-phase durations of one step (None without a speed
        model): jitter=True is the CHARGED clock (pricer.charge),
        jitter=False the controller's PREDICTION (pricer.predict)."""
        if self.speed is None:
            return None
        kw = self._phase_kwargs(r, cuts_np, cb, start_time)
        if jitter:
            return self.pricer.charge(**kw)
        return self.pricer.predict(**kw)

    def _observe_phases(self, r: int, observed: np.ndarray, mask,
                        cb: Dict[str, np.ndarray], t0: float):
        """Feed one charged (5, N) phase matrix to the telemetry
        consumers: the measured pricer's EWMA (against the MODEL's
        stationary baseline) and the trace recorder (against the CLOCK's).
        mask selects the clients that ran; t0 is the launch instant."""
        if not self._observing:
            return
        kw = self._phase_kwargs(r, self._cuts(), cb, t0)
        mask = np.asarray(mask, bool)
        observed = np.asarray(observed, np.float64)
        if self.pricer.source == "measured":
            self.pricer.observe(observed, mask,
                                self.pricer.model_baseline(**kw))
        if self.recorder is not None:
            self.recorder.observe(observed,
                                  self.pricer.clock_baseline(**kw),
                                  mask, t0)

    def predict_round_times(self, r: int, cuts, rank_cut=None,
                            comp_idx=None, topk_frac=None) -> np.ndarray:
        """(N,) predicted per-client one-step round time for a candidate
        (cut, rank-at-cut, compressor index, topk fraction) assignment,
        the co-controller's objective: the bytes of the same
        comm.round_comm_bytes the clock charges, priced by the pricer's
        jitter-free `predict` (with jitter_sigma 0 and an analytic or
        trace source, prediction and simulation coincide).  topk_frac
        None takes the state's.  Under overlap_comm, the steady-state
        per-step time of the double-buffered pipeline."""
        cuts_np = np.asarray(cuts, int)
        cb = self._round_comm(
            cuts_np,
            None if rank_cut is None else np.asarray(rank_cut, int),
            None if comp_idx is None else np.asarray(comp_idx, int),
            (self._state_frac() if topk_frac is None
             else np.asarray(topk_frac, np.float64)))
        phases = self._round_phases(r, cuts_np, cb, jitter=False)
        if self.overlap_comm:
            k = max(2, self.scheduler.max_steps)
            steps = np.full(cuts_np.shape[0], k, np.int64)
            return straggler.pipelined_makespan(phases, steps) / k
        return straggler.serial_step_times(phases)

    def _trace_availability(self) -> Optional[np.ndarray]:
        """The availability mask at the round's start under a trace.  If
        no pool-active client is available the fleet idles: the clock
        advances to the earliest next-available instant (past the trace's
        scan horizon, everyone counts as available)."""
        if self.speed is None or self.speed.trace is None:
            return None
        act = np.asarray(self.pool.active, bool)
        avail = self.speed.available_mask(self.sim_clock)
        if act.any() and not (act & avail).any():
            t = min(self.speed.next_available(int(i), self.sim_clock)
                    for i in np.flatnonzero(act))
            if t > self.sim_clock:
                self.sim_clock = float(t)
                avail = self.speed.available_mask(self.sim_clock)
            if not (act & avail).any():
                avail = np.ones_like(avail)
        return avail.astype(np.float64)

    def _plan_round(self, r: int):
        """One scheduler decision: (RoundPlan, comm-bytes dict)."""
        avail = self._trace_availability()   # may advance sim_clock
        cuts_np = self._cuts()
        cb = self._round_comm(cuts_np, *self._state_policy(),
                              self._state_frac())
        phases = self._round_phases(r, cuts_np, cb)
        times = (None if phases is None
                 else straggler.serial_step_times(phases))
        plan = self.scheduler.plan(
            active=self.pool.active.astype(np.float64), times=times,
            phases=phases, round_idx=r, available=avail)
        return plan, cb

    def _round_record(self, r: int, metrics, plan: RoundPlan,
                      cb: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """The round's history record: numpy and Python values only."""
        rec: Dict[str, Any] = {
            "round": r,
            "loss": float(metrics["total"]),
            "ce": _np(metrics["ce"]),
            "accuracy": _np(metrics["accuracy"]),
            "cuts": self._cuts(),
            "active": plan.active.copy(),
        }
        for k in rounds.POLICY:
            if k in self.state:
                rec[k] = _np(self.state[k]).copy()
        if plan.times is not None:
            rec["round_time_sim"] = plan.times
            rec["sim_time"] = plan.sim_time
            rec["sim_clock"] = self.sim_clock
        if plan.phases is not None:
            rec["phase_times"] = np.asarray(plan.phases).copy()
        # a dropped/inactive client (budget 0) transmits nothing; it still
        # receives the b3 adapter broadcast but sends no b1 update
        steps = plan.step_budgets.astype(np.float64)
        smashed = (cb["smashed_up"] + cb["smashed_down"]) * steps
        rec["comm"] = (smashed + cb["adapter_up"] * plan.active
                       + cb["adapter_down"])
        rec["comm_smashed"] = smashed
        rec["smashed_ratio"] = cb["smashed_ratio"]
        return rec

    def _adjust_c3(self, r: int, rec: Dict[str, Any], weights,
                   times: Optional[np.ndarray]):
        """C3: evaluate the global model per client, then move the cuts
        by the paper's accuracy rule, or the whole (cut, rank-at-cut,
        compressor[, topk fraction]) policy by the co-controller."""
        _, e_metrics = self.eval_step(
            self.base_params, self.state, self._eval_batch(r), weights)
        accs = _np(e_metrics["accuracy"])
        rec["eval_ce"] = _np(e_metrics["ce"])
        rec["eval_accuracy"] = accs
        self.c3_weights = adaptive.update_weights(
            accs, self.arch.split.gamma)
        active = self.pool.active.astype(np.float64)
        if self.controller != "co":
            new_cuts = adaptive.adjust_cuts(
                self._cuts(), accs, self.arch.split,
                self.model.num_flat_layers, round_times=times,
                active=active)
            self.state["cuts"] = torch.as_tensor(new_cuts,
                                                 dtype=torch.int32)
            rec["weights"] = self.c3_weights.copy()
            return
        rank_np, choice_np = self._state_policy()
        frac_np = self._state_frac()
        kw = dict(rank_buckets=self.rank_buckets,
                  num_compressors=len(self.comp_buckets), active=active,
                  dead_band=self.acc_dead_band, min_gain=self.min_gain,
                  round_times=times)
        if frac_np is None:
            new_cuts, new_rank, new_comp, pred = adaptive.co_adjust(
                self._cuts(), rank_np, choice_np, accs, self.arch.split,
                self.model.num_flat_layers,
                price=lambda c, rk, ci: self.predict_round_times(
                    r + 1, c, rk, ci), **kw)
        else:
            new_cuts, new_rank, new_comp, new_frac, pred = \
                adaptive.co_adjust(
                    self._cuts(), rank_np, choice_np, accs, self.arch.split,
                    self.model.num_flat_layers,
                    price=lambda c, rk, ci, fr: self.predict_round_times(
                        r + 1, c, rk, ci, topk_frac=fr),
                    topk_frac=frac_np, **kw)
            self.state["topk_frac"] = torch.as_tensor(new_frac,
                                                      dtype=torch.float32)
        self.state["cuts"] = torch.as_tensor(new_cuts, dtype=torch.int32)
        self.state["rank_cut"] = torch.as_tensor(new_rank, dtype=torch.int32)
        self.state["smashed_choice"] = torch.as_tensor(new_comp,
                                                       dtype=torch.int32)
        rec["predicted_time"] = pred
        rec["weights"] = self.c3_weights.copy()

    def _finish_round(self, r: int, rec: Dict[str, Any], log_every: int,
                      callback: Optional[Callable]):
        """Round epilogue: C3 adjustment, history, callback, checkpoint
        cadence, logging."""
        if self._adaptive and (r + 1) % self.sys.adjust_every == 0:
            self._adjust_c3(r, rec, self._weights32(),
                            rec.get("round_time_sim"))
        self.history.append(rec)
        if callback:
            callback(rec)
        if self.ckpt and self.sys.checkpoint_every and \
                (r + 1) % self.sys.checkpoint_every == 0:
            self.save(r + 1)
        if log_every and (r + 1) % log_every == 0:
            print(f"[round {r + 1}] loss={rec['loss']:.4f} "
                  f"acc={rec['accuracy'].mean():.4f} "
                  f"cuts={rec['cuts'].tolist()}")

    # ------------------------------------------------------------------
    def run(self, num_rounds: int, *, log_every: int = 10,
            callback: Optional[Callable] = None) -> List[Dict[str, Any]]:
        """`num_rounds` barrier rounds: one plan -> one engine call -> one
        record per round.  Returns the whole history."""
        lr_c = float(self.arch.train.lr_client)
        lr_s = float(self.arch.train.lr_server)
        start = int(self.state["round"])
        for r in range(start, start + num_rounds):
            plan, cb = self._plan_round(r)
            t0 = self.sim_clock        # the round's launch instant
            self.state, metrics = self.train_step(
                self.base_params, self.state, self._train_batch(r),
                self._weights32(), plan.active.astype(np.float32),
                lr_c, lr_s)
            self.sim_clock += plan.sim_time
            if plan.phases is not None:
                # telemetry feedback: the plan's charged phase matrix is
                # exactly what the clock just billed this round
                self._observe_phases(r, plan.phases, plan.active, cb, t0)
            rec = self._round_record(r, metrics, plan, cb)
            self._finish_round(r, rec, log_every, callback)
        if self.recorder is not None:
            # cumulative: a second run() re-dumps the extended recording
            self.recorder.dump(self.sys.record_trace)
        return self.history

    def evaluate(self, *, num_batches: int = 4) -> Dict[str, float]:
        """Global-model perplexity/accuracy on held-out data."""
        weights = self._weights32()
        ces, accs = [], []
        for b in range(num_batches):
            _, metrics = self.eval_step(
                self.base_params, self.state, self._eval_batch(10_000 + b),
                weights)
            ces.append(_np(metrics["ce"]).mean())
            accs.append(_np(metrics["accuracy"]).mean())
        ce = float(np.mean(ces))
        return {"ce": ce, "perplexity": float(np.exp(ce)),
                "accuracy": float(np.mean(accs))}

    # ------------------------------------------------------------------
    def save(self, step: int):
        assert self.ckpt is not None
        meta = {
            "round": int(self.state["round"]),
            "c3_weights": self.c3_weights.tolist(),
            "active": self.pool.active.tolist(),
            "seed": self.seed,
            "sim_clock": self.sim_clock,
            "scheduler": self.scheduler.name,
            # template signature: lets restore() explain a leaf-count
            # mismatch instead of silently restarting from round 0
            "state_keys": sorted(self.state.keys()),
        }
        if self.speed is not None and self.speed.trace is not None:
            meta["trace"] = self.speed.trace.state_dict()
        if self.pricer is not None:
            tm = self.pricer.state_dict()
            if tm:
                meta["timemodel"] = tm
        self.ckpt.save(step, self.state, metadata=meta)

    def restore(self) -> bool:
        """Resume from the newest loadable checkpoint; False when there is
        none.  Raises when checkpoints exist but were written with another
        state template or scheduler."""
        assert self.ckpt is not None
        got = self.ckpt.restore_latest(self.state)
        if got is None:
            steps = self.ckpt.steps()
            if steps:
                meta = self.ckpt.metadata(steps[-1]) or {}
                saved = meta.get("scheduler")
                if saved and saved != self.scheduler.name:
                    raise ValueError(
                        f"checkpoint step {steps[-1]} was written with "
                        f"scheduler={saved!r} but this run uses "
                        f"{self.scheduler.name!r}; resume with the same "
                        "scheduler or point at a fresh checkpoint dir")
                saved_keys = meta.get("state_keys")
                now_keys = sorted(self.state.keys())
                if saved_keys and saved_keys != now_keys:
                    raise ValueError(
                        f"checkpoint step {steps[-1]} state template "
                        f"{saved_keys} does not match this run's "
                        f"{now_keys}; resume with the original config or "
                        "use a fresh checkpoint dir")
            return False
        tree, meta, _ = got
        self.state = bridge.state_from_numpy(tree, self.device)
        self.c3_weights = np.asarray(meta.get("c3_weights",
                                              self.c3_weights))
        if "active" in meta:
            self.pool.active = np.asarray(meta["active"], bool)
        self.sim_clock = float(meta.get("sim_clock", 0.0))
        if self.speed is not None and self.speed.trace is not None \
                and meta.get("trace") is not None:
            self.speed.trace.load_state_dict(meta["trace"])
        if self.pricer is not None and meta.get("timemodel") is not None:
            self.pricer.load_state_dict(meta["timemodel"])
        return True

    # ------------------------------------------------------------------
    def serve_model(self):
        """(base_params, global adapters) for the serving path."""
        eff = serve_adapters(self.model, self.state["client_adapters"],
                             self.state["server_adapters"],
                             self.state["cuts"], self._weights32())
        return self.base_params, eff
