"""SplitFTSystem — host-side orchestration of the paper workflow.

Port of src/repro/core/system.py.  It owns: corpus -> tokenize ->
partition (C4) -> per-client loaders -> round loop -> eval, C3
adjustment, aggregation weights, checkpoint/resume, elastic membership,
cohort sampling over a client population.

The round loop is split engine/policy:

  * the *engine* is the round step of repro_torch.core.rounds; which
    clients run and how many local steps each takes is data (the
    `active` mask, state["step_budgets"]);
  * the *policy* is a RoundScheduler (repro_torch.core.scheduler): sync
    (Algorithm 1 lockstep), deadline (straggler drop), local_steps
    (speed-proportional K_i per client) or async (FedBuff buffered
    asynchrony).  The scheduler also owns the simulated wall-clock
    accounting (`sim_time` / cumulative `sim_clock` in the round
    records), priced per phase by runtime.straggler's SpeedModel under an
    optional heterogeneity trace (runtime.traces) and time model
    (runtime.timemodel).

The host loop has two shapes.  The barrier schedulers run one plan ->
one engine call -> one record per round (`_run_barrier`).  The async
scheduler replaces the barrier with an event-queue loop (`_run_async`):
phase-completion events drawn from the SpeedModel advance a simulated
clock; a step-completion tick is one engine call over the finishing
clients, and a round record is emitted when the server buffer flushes
(one round == one aggregation).  With `overlap_comm` the async loop
runs each step's phases as a double-buffered pipeline, and only
`adapter_sync` completions reach the engine.  Elastic membership
composes with the event loop: a leaver's in-flight events are dropped,
a rejoiner enters at the current clock with its next batch index.

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
(seed); here a CPU torch.Generator seeded with `seed` draws the base
parameters and one seeded with `seed + 1` the round state, so the two
packages start from different weights at one seed (parity tests copy the
reference's weights in through repro_torch.bridge), and one seed gives
the same weights on every device.  draw_on_device=True draws the base
parameters on `device` instead (on the card, a model of tens of GB needs
no host draw), which gives other weights than the host's at one seed: a
checkpoint, which holds the state but not the base weights, records the
device type they were drawn on, and restoring it under another raises.  Data, loaders, the
speed model and traces are numpy and seeded exactly as the reference's.

Population mode (population P > 0): the engine's client axis is a cohort
of C = num_clients pids that a seeded sampler (runtime.population.
CohortSampler) draws from P each round.  Each pid's state (adapter rows,
optimizer slots, EF residuals, policy, data cursor, C3 weight, speed
draws) lives in a host-side runtime.population.PopulationStore; the
loops gather the cohort into the engine state at the round's start and
scatter it back at its end (the async loop at each aggregation, where
the event pipeline restarts only when the cohort's membership changed).
Checkpoints then hold the engine state and the store, and the sampler's
RNG state in their metadata.

Sharding (``policy``, a runtime.sharding.MeshShard or ClientShard; the
reference's ``policy=`` takes its mesh): every rank of the group runs
this host loop on the same seed (data pipeline, scheduler, clock,
deadlines, elastic membership, controllers, population sampler), so the
host decisions are the same on every rank, and ``self.state`` holds the
rank's rows of the cohort over the mesh's "data" axis
(``shard_state``).  A MeshShard also places the base weights once, at
init, by ``param_specs`` (``leaf_block``, each leaf narrowed as it is
drawn, so no rank holds the full tree: FSDP over ("pod", "data"),
heads, FFN width, vocabulary, SSM heads and MoE experts over "model",
every family), and the engine's steps run the model on those blocks
(models/common.ShardingPolicy: each client's batch rows over "pod", and
under the MeshShard's ``seq_shard`` the residual stream's sequence over
"model"); the adapters stay whole on every "pod" and "model" rank.  Every
host read of a client-axis leaf goes through a row gather, every host
write of one is sliced, and once a round rank 0 broadcasts a digest of
the round's host decisions (cuts and policy, active mask, weights,
clock), against which every rank checks its own: ranks that disagree
raise together.  A checkpoint holds the gathered state (no base
weights), written by rank 0, so it restores under any mesh, sharded or
not.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import ArchConfig
from repro_torch.core import adaptive, comm, rounds, smashed
from repro_torch.core import scheduler as scheduler_lib
from repro_torch.core.scheduler import RoundPlan
from repro_torch.core.split import serve_adapters
from repro_torch.data import (ClientDataLoader, make_client_loaders,
                              partition_dataset, synthetic_corpus)
from repro_torch.data.pipeline import stack_client_batches
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import NO_SHARDING, ShardingPolicy
from repro_torch.models.model import build_model
from repro_torch.runtime import straggler
from repro_torch.runtime import timemodel
from repro_torch.runtime import traces as traces_lib
from repro_torch.runtime.elastic import ClientPool
from repro_torch.runtime.population import CohortSampler, PopulationStore
from repro_torch.runtime.sharding import (MeshShard, cohort_of,
                                          gather_state, leaf_block,
                                          shard_state, state_client_axis)
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


class SplitFTSystem:
    def __init__(self, arch: ArchConfig, sys_cfg: SystemConfig = None, *,
                 seed: int = 0, device: DeviceLike = None,
                 draw_on_device: bool = False,
                 policy: Optional[MeshShard] = None):
        self.arch = arch
        self.sys = sys_cfg or SystemConfig()
        self.seed = seed
        self.device = resolve_device(device)
        if policy is not None and policy.device.type != self.device.type:
            raise ValueError(f"the shard's collectives run on "
                             f"{policy.device}, the system on {self.device}")
        self.shard = policy
        self.cohort = cohort_of(policy, arch.data.num_clients)
        self._written: Dict[str, np.ndarray] = {}
        self.draw_device = (self.device if draw_on_device
                            else torch.device("cpu"))

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
        if use_ef and self.smashed_compress != "topk":
            raise ValueError(
                "smashed_ef=True requires smashed_compress='topk' "
                f"(got {self.smashed_compress!r}); int8/fp8 are "
                "memoryless round-trips with no residual to feed back")
        self._co_search_space(use_ef)

        self.model = build_model(arch, device=self.device)
        n = arch.data.num_clients
        self.pool = ClientPool(n)
        self.population = _pick(self.sys.population,
                                arch.data.population) or 0
        if 0 < self.population < n:
            raise ValueError(
                f"population={self.population} must be >= the cohort "
                f"size (num_clients={n}); the engine's client axis IS "
                "the cohort")

        # ---- data (C4) ----
        tok = HashTokenizer(arch.model.vocab_size)
        texts = synthetic_corpus(self.sys.num_samples, seed=arch.data.seed)
        self.samples = [np.asarray(tok.encode(t), np.int32) for t in texts]
        # fleet mode partitions over the N clients; population mode over a
        # fixed pool of shards, pid p streaming shard p % shards, so the
        # cost is O(shards), not O(P), and pid p sees the same shard at
        # any population size >= shards
        self._n_shards = (n if not self.population
                          else min(self.population, max(n, 256)))
        self.parts = partition_dataset(
            [len(s) for s in self.samples], self._n_shards,
            strategy=arch.data.partition, alpha=arch.data.alpha,
            num_classes=arch.data.num_length_classes, seed=arch.data.seed)
        eval_texts = synthetic_corpus(self.sys.eval_samples,
                                      seed=arch.data.seed + 777)
        self._eval_tokens = [np.asarray(tok.encode(t), np.int32)
                             for t in eval_texts]
        if not self.population:
            self.loaders = make_client_loaders(
                self.samples, self.parts, batch_size=arch.train.batch_size,
                seq_len=arch.train.seq_len, seed=seed)
            self.eval_loaders = make_client_loaders(
                self._eval_tokens, [np.arange(len(self._eval_tokens))] * n,
                batch_size=arch.train.batch_size,
                seq_len=arch.train.seq_len, seed=seed + 999)
        else:
            # loaders are built per pid on cohort install; the slots start
            # with pids 0..n-1, exactly the first P == C cohort (which the
            # sampler returns without consuming RNG)
            self._loader_cache: Dict[int, ClientDataLoader] = {}
            self._eval_loader_cache: Dict[int, ClientDataLoader] = {}
            self.loaders = [self._loader_for(p) for p in range(n)]
            self.eval_loaders = [self._eval_loader_for(p) for p in range(n)]

        # ---- round scheduler (policy) + straggler simulation ----
        self.overlap_comm = _pick(self.sys.overlap_comm,
                                  arch.split.overlap_comm)
        # the buffer can never exceed the distinct clients
        buf = max(1, min(_pick(self.sys.buffer_size,
                               arch.split.async_buffer_size), n))
        spow = _pick(self.sys.staleness_power, arch.split.staleness_power)
        self.scheduler = scheduler_lib.make_scheduler(
            sched_name,
            deadline_frac=_pick(self.sys.deadline_frac,
                                arch.split.deadline_frac),
            max_local_steps=_pick(self.sys.max_local_steps,
                                  arch.split.max_local_steps),
            buffer_size=buf, staleness_power=spow,
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
        self.num_edges = max(1, _pick(self.sys.edge_groups,
                                      arch.split.edge_groups) or 1)
        self.server_step_norm = _pick(self.sys.server_step_norm,
                                      arch.split.server_step_norm)
        # the model's policy first: a mesh the port does not place
        # raises before any weight is drawn
        self.model_policy = ShardingPolicy.for_model(policy, arch)
        # each leaf narrowed to this rank's block as it is drawn: no rank
        # ever holds the full tree
        place = (None if self.model_policy is NO_SHARDING else
                 functools.partial(leaf_block, mesh=policy.mesh,
                                   rank=policy.rank))
        self.base_params = self.model.init_params(
            torch.Generator(device=self.draw_device).manual_seed(seed),
            place=place)
        state = rounds.init_state(self.model,
                                  torch.Generator().manual_seed(seed + 1),
                                  num_clients=n)
        if self.sys.compress == "topk":
            state = rounds.with_error_feedback(state)
        if use_ef:
            state = rounds.with_smashed_ef(state, self.model)
        co = self.controller == "co"
        is_async = self.scheduler.name == "async"
        init_rank = int(self.rank_buckets[int(np.argmin(np.abs(
            np.asarray(self.rank_buckets) - arch.lora.r_cut)))])
        init_choice = (self.comp_buckets.index(self.smashed_compress)
                       if self.smashed_compress in self.comp_buckets
                       else 0)
        state = rounds.prepare_state(
            state, max_local_steps=self.scheduler.max_steps,
            async_buffer=is_async,
            rank_cut=init_rank if co else None,
            smashed_choice=init_choice if co else None,
            topk_frac=(self.smashed_topk_frac
                       if (co and self.continuous_topk) else None),
            edge_groups=self.num_edges)
        # drawn for the whole cohort on every rank, then sliced
        self.state = shard_state(state, self.cohort)
        self.train_step = rounds.make_train_step(
            self.model, remat=arch.train.remat,
            agg_every=self.sys.agg_every, compress=self.sys.compress,
            topk_frac=self.sys.topk_frac,
            smashed_compress=self.smashed_compress,
            smashed_topk_frac=self.smashed_topk_frac,
            compressor_buckets=self.comp_buckets if co else None,
            max_local_steps=self.scheduler.max_steps,
            async_buffer=is_async, buffer_size=buf, staleness_power=spow,
            num_edges=self.num_edges,
            server_step_norm=self.server_step_norm, shard=policy)
        self.eval_step = rounds.make_eval_step(self.model, shard=policy)

        # ---- C3 state ----
        self.c3_weights = np.ones(n)
        self.sample_counts = np.array([l.num_samples()
                                       for l in self.loaders], float)
        self._comm_cache = None        # (policy bytes, comm dict) memo
        self._times_cache: Dict[Any, np.ndarray] = {}
        self.ckpt = (CheckpointManager(self.sys.checkpoint_dir,
                                       keep=self.sys.keep_checkpoints)
                     if self.sys.checkpoint_dir else None)
        self.history: List[Dict[str, Any]] = []
        self._adaptive = _pick(self.sys.adaptive, arch.split.adaptive)

        # ---- fleet-scale population (cohort engine) ----
        if self.population:
            sp_kw = (dict(speed_sigma=self.speed.speed_sigma,
                          bw_mean=self.speed.bw_mean,
                          bw_sigma=self.speed.bw_sigma)
                     if self.speed is not None else {})
            self.store = PopulationStore(self.population, state,
                                         seed=seed, **sp_kw)
            self.sampler = CohortSampler(self.population, n, seed=seed)
        else:
            self.store = None
            self.sampler = None
        self._cohort_pids: Optional[np.ndarray] = None
        self._cohort_cursors: Optional[np.ndarray] = None
        self._cohort_scattered = True

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
    # fleet-scale population: cohort install / gather / scatter

    def _loader_for(self, pid: int) -> ClientDataLoader:
        """Per-pid train loader (population mode): pid p streams shard
        p % shards with a pid-keyed seed, so its batch sequence survives
        cohort churn.  With P == C this is make_client_loaders' seed + i
        convention exactly."""
        ld = self._loader_cache.get(pid)
        if ld is None:
            arch = self.arch
            part = self.parts[pid % self._n_shards]
            ld = ClientDataLoader([self.samples[j] for j in part],
                                  batch_size=arch.train.batch_size,
                                  seq_len=arch.train.seq_len,
                                  seed=self.seed + pid)
            if len(self._loader_cache) > 4 * len(self.pool.active):
                self._loader_cache.clear()   # bound memory under churn
            self._loader_cache[pid] = ld
        return ld

    def _eval_loader_for(self, pid: int) -> ClientDataLoader:
        ld = self._eval_loader_cache.get(pid)
        if ld is None:
            arch = self.arch
            ld = ClientDataLoader(self._eval_tokens,
                                  batch_size=arch.train.batch_size,
                                  seq_len=arch.train.seq_len,
                                  seed=self.seed + 999 + pid)
            if len(self._eval_loader_cache) > 4 * len(self.pool.active):
                self._eval_loader_cache.clear()
            self._eval_loader_cache[pid] = ld
        return ld

    def _install_cohort(self, pids: np.ndarray):
        """Point the whole host side at a new cohort: gather the pids'
        slots into engine state, recompute the derived per-client arrays
        (edge assignment, C3 weights, loaders, speed draws) and drop the
        per-cohort memo caches."""
        pids = np.asarray(pids, np.int64)
        self._cohort_pids = pids
        self.state = shard_state(self.store.gather(self.state, pids),
                                 self.cohort)
        if "edge_assign" in self.state:
            self._set_leaf("edge_assign", torch.as_tensor(
                pids % self.num_edges, dtype=torch.int32))
        self._cohort_cursors = self.store.cursors(pids)
        self.c3_weights = self.store.c3_weights(pids)
        self.loaders = [self._loader_for(int(p)) for p in pids]
        self.eval_loaders = [self._eval_loader_for(int(p)) for p in pids]
        self.sample_counts = np.array([l.num_samples()
                                       for l in self.loaders], float)
        if self.speed is not None:
            sp, bw, js = self.store.speed_draws(pids)
            self.speed.speed = sp
            self.speed.bandwidth = bw
            # pid-keyed jitter and trace series: both are attributes of
            # the client, so they follow the pid into its slot
            self.speed.jitter_seeds = js
            self.speed.trace_pids = pids.copy()
            # the pricer's model draws (and measured state) follow too
            self.pricer.install_cohort(pids)
        self._comm_cache = None
        self._times_cache.clear()
        self._cohort_scattered = False

    def _pop_gather(self):
        """Draw and install the next cohort (no-op in fleet mode)."""
        if self.store is None:
            return
        if self._cohort_pids is not None and not self._cohort_scattered:
            self._pop_scatter()        # never drop a live cohort
        self._install_cohort(self.sampler.sample())

    def _pop_scatter(self):
        """Write the live cohort's state back into the store.  Idempotent:
        a second call before the next gather is a no-op, so the checkpoint
        inside _finish_round composes with the loop's own scatter."""
        if self.store is None or self._cohort_pids is None \
                or self._cohort_scattered:
            return
        sched = self.scheduler
        if sched.name == "async" and sched.started:
            cursors = sched.launches.copy()
        else:
            # every cohort member consumed batch index cursor_i this round
            # (inactive and dropped clients advance too, as the fleet
            # path's batch(r) stream does)
            cursors = np.asarray(self._cohort_cursors) + 1
        self.store.scatter(gather_state(self.state, self.cohort),
                           self._cohort_pids, cursors=cursors,
                           c3_weights=self.c3_weights)
        self._cohort_scattered = True

    def _batch_index(self, i: int, r: int) -> int:
        """Client slot i's batch index in barrier round r: the fleet path
        streams by round, population mode by the pid's own cursor."""
        if self._cohort_cursors is not None:
            return int(self._cohort_cursors[i])
        return r

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
        return stack_client_batches([l.batch(self._batch_index(i, r))
                                     for i, l in enumerate(self.loaders)])

    def _train_batches(self, r: int, k: int):
        """(K, N, B, S) batch stack for the local-steps engine; inner step
        j of round r draws from the deterministic stream at r * K + j."""
        steps = [stack_client_batches(
                    [l.batch(self._batch_index(i, r) * k + j)
                     for i, l in enumerate(self.loaders)])
                 for j in range(k)]
        return {key: np.stack([s[key] for s in steps]) for key in steps[0]}

    def _eval_batch(self, r: int):
        return stack_client_batches([l.batch(r) for l in self.eval_loaders])

    def _leaf(self, key: str) -> torch.Tensor:
        """A top-level state leaf for the host: the whole cohort's rows
        of a client-axis leaf (a row gather under a split cohort)."""
        x = self.state[key]
        if (self.shard is None
                or state_client_axis((key,), x.dim()) is None):
            return x
        return gather_state({key: x}, self.cohort)[key]

    def _set_leaf(self, key: str, full: torch.Tensor):
        """A host decision for the whole cohort into the state: this
        rank's rows of a client-axis leaf.  The ranks' decisions are
        checked against rank 0's once a round (_check_ranks_agree)."""
        if self.shard is None:
            self.state[key] = full
            return
        self._written[key] = _np(full).copy()
        self.state[key] = shard_state({key: full}, self.cohort)[key]

    def _check_ranks_agree(self, r: int, rec: Dict[str, Any]):
        """Raise on every rank unless every rank took the same host
        decisions in round r (no-op without a shard)."""
        if self.shard is None:
            return
        self.shard.check_agree(
            f"round {r}", np.int64(r), rec["active"], self._weights32(),
            np.float64(self.sim_clock), self.pool.active,
            *(self._written[k] for k in sorted(self._written)))

    def _cuts(self) -> np.ndarray:
        return _np(self._leaf("cuts")).copy()

    # ------------------------------------------------------------------
    # round-loop pieces (one engine call + host-side policy around it)

    def _state_policy(self):
        """The co-controller's per-client (rank_cut, smashed_choice) from
        round state as numpy, (None, None) under the static policy."""
        return tuple(_np(self._leaf(k)) if k in self.state else None
                     for k in ("rank_cut", "smashed_choice"))

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
        ea = (_np(self._leaf("edge_assign"))
              if (self.num_edges > 1 and "edge_assign" in self.state)
              else None)
        kw = dict(
            cuts=cuts_np, flops_per_layer=self._flops_layer,
            smashed_bytes=cb["smashed_up"],
            smashed_down_bytes=cb["smashed_down"],
            adapter_bytes=cb["adapter_up"], round_idx=r,
            server_layers=self.model.num_flat_layers - cuts_np,
            edge_assign=ea, num_edges=self.num_edges,
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
        """The round's history record: numpy and Python values only.  An
        async tick trains a subset, so its record's loss is the engine's
        whole-fleet "fleet_total" at the flush tick."""
        async_rec = plan.buffer_fill is not None
        rec: Dict[str, Any] = {
            "round": r,
            "loss": float(metrics["fleet_total" if async_rec else "total"]),
            "ce": _np(metrics["ce"]),
            "accuracy": _np(metrics["accuracy"]),
            "cuts": self._cuts(),
            "active": plan.active.copy(),
        }
        for k in rounds.POLICY:
            if k in self.state:
                rec[k] = _np(self._leaf(k)).copy()
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
        if async_rec:
            # only the buffered clients upload b1 and receive the b3
            # broadcast at this aggregation
            rec["comm"] = (smashed + (cb["adapter_up"]
                                      + cb["adapter_down"]) * plan.active)
            rec["staleness"] = np.asarray(plan.staleness).copy()
            rec["buffer_fill"] = plan.buffer_fill
            rec["round_steps"] = plan.step_budgets.copy()
        else:
            rec["comm"] = (smashed + cb["adapter_up"] * plan.active
                           + cb["adapter_down"])
        rec["comm_smashed"] = smashed
        rec["smashed_ratio"] = cb["smashed_ratio"]
        if self.scheduler.max_steps > 1:
            rec["step_budgets"] = plan.step_budgets.copy()
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
            self._set_leaf("cuts", torch.as_tensor(new_cuts,
                                                   dtype=torch.int32))
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
            self._set_leaf("topk_frac", torch.as_tensor(
                new_frac, dtype=torch.float32))
        self._set_leaf("cuts", torch.as_tensor(new_cuts, dtype=torch.int32))
        self._set_leaf("rank_cut", torch.as_tensor(new_rank,
                                                   dtype=torch.int32))
        self._set_leaf("smashed_choice", torch.as_tensor(new_comp,
                                                         dtype=torch.int32))
        rec["predicted_time"] = pred
        rec["weights"] = self.c3_weights.copy()

    def _finish_round(self, r: int, rec: Dict[str, Any], log_every: int,
                      callback: Optional[Callable]):
        """Round epilogue: C3 adjustment, history, callback, checkpoint
        cadence, logging."""
        if self._adaptive and (r + 1) % self.sys.adjust_every == 0:
            self._adjust_c3(r, rec, self._weights32(),
                            rec.get("round_time_sim"))
        self._check_ranks_agree(r, rec)
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
        """`num_rounds` rounds (aggregations under async).  Returns the
        whole history."""
        if self.scheduler.name == "async":
            hist = self._run_async(num_rounds, log_every=log_every,
                                   callback=callback)
        else:
            hist = self._run_barrier(num_rounds, log_every=log_every,
                                     callback=callback)
        if self.recorder is not None:
            # cumulative: a second run() re-dumps the extended recording
            self.recorder.dump(self.sys.record_trace)
        return hist

    def _lrs(self):
        return (float(self.arch.train.lr_client),
                float(self.arch.train.lr_server))

    def _run_barrier(self, num_rounds: int, *, log_every: int = 10,
                     callback: Optional[Callable] = None
                     ) -> List[Dict[str, Any]]:
        """One plan -> one engine call -> one record per round."""
        lr_c, lr_s = self._lrs()
        k = self.scheduler.max_steps
        start = int(self.state["round"])
        for r in range(start, start + num_rounds):
            self._pop_gather()         # population mode: next cohort in
            plan, cb = self._plan_round(r)
            t0 = self.sim_clock        # the round's launch instant
            batch = (self._train_batch(r) if k == 1
                     else self._train_batches(r, k))
            if "step_budgets" in self.state:
                self._set_leaf("step_budgets", torch.as_tensor(
                    plan.step_budgets, dtype=torch.int32))
            self.state, metrics = self.train_step(
                self.base_params, self.state, batch, self._weights32(),
                plan.active.astype(np.float32), lr_c, lr_s)
            self.sim_clock += plan.sim_time
            if plan.phases is not None:
                # telemetry feedback: the plan's charged phase matrix is
                # exactly what the clock just billed this round
                self._observe_phases(r, plan.phases, plan.active, cb, t0)
            rec = self._round_record(r, metrics, plan, cb)
            self._finish_round(r, rec, log_every, callback)
            self._pop_scatter()        # cohort rows back to their slots
        return self.history

    # ------------------------------------------------------------------
    # async (FedBuff) host loop: event-queue simulation, no barrier

    def _policy_key(self):
        rank_np, choice_np = self._state_policy()
        frac_np = self._state_frac()
        return tuple(None if a is None else a.tobytes()
                     for a in (rank_np, choice_np, frac_np))

    def _cached_comm(self, cuts_np: np.ndarray) -> Dict[str, np.ndarray]:
        """_round_comm memo for the event loop: the policy changes only in
        the per-aggregation C3 epilogue, but ticks fire many times per
        round."""
        key = (cuts_np.tobytes(),) + self._policy_key()
        if self._comm_cache is None or self._comm_cache[0] != key:
            self._comm_cache = (key, self._round_comm(
                cuts_np, *self._state_policy(), self._state_frac()))
        return self._comm_cache[1]

    def _cached_phases(self, round_idx: int, cuts_np: np.ndarray,
                       cb: Dict[str, np.ndarray],
                       start_time: Optional[float] = None) -> np.ndarray:
        """_round_phases memo keyed by (launch index, trace window, cuts
        and controller policy): clients relaunching at one launch index
        share one full-fleet draw.  Traces are piecewise constant per
        window, so the key keeps the memo exact under a trace."""
        start = self.sim_clock if start_time is None else start_time
        trace = None if self.speed is None else self.speed.trace
        win = None if trace is None else trace.window(start)
        key = (round_idx, win, cuts_np.tobytes()) + self._policy_key()
        p = self._times_cache.get(key)
        if p is None:
            if len(self._times_cache) > 64:   # launches only grow; old
                self._times_cache.clear()     # entries never recur
            p = self._round_phases(round_idx, cuts_np, cb,
                                   start_time=start)
            self._times_cache[key] = p
        return p

    def _serial_time(self, i: int, launch: int, cuts_np: np.ndarray,
                     cb: Dict[str, np.ndarray],
                     start_time: Optional[float] = None) -> float:
        """Client i's serial one-step time at a launch index (priced at
        `start_time` on the simulated clock; None = now)."""
        ph = self._cached_phases(launch, cuts_np, cb, start_time)
        return float(straggler.serial_step_times(ph)[i])

    def _overlap_try_compute(self, i: int, cuts_np: np.ndarray,
                             cb: Dict[str, np.ndarray]):
        """Schedule client i's next `client_compute` phase if the
        pipeline allows: no compute in flight, and step k-2 fully done
        (double buffer: the client trains at staleness <= 1)."""
        sched = self.scheduler
        if not self.pool.active[i]:
            return
        if int(sched.csched[i]) != int(sched.cfin[i]):
            return                 # a compute phase is already in flight
        k = int(sched.csched[i])
        if int(sched.launches[i]) < k - 1:
            return                 # step k-2 has not fully completed
        # trace availability defers the launch to the client's next
        # available instant (max(t, t) == t keeps the clock bitwise)
        t0 = max(sched.queue.now, self.speed.next_available(
            i, sched.queue.now))
        ph = self._cached_phases(k, cuts_np, cb, t0)
        sched.queue.push((i, "client_compute", k), t0 + float(ph[0, i]))
        sched.csched[i] += 1

    def _overlap_advance(self, i: int, phase: str, k: int, t_now: float,
                         cuts_np: np.ndarray, cb: Dict[str, np.ndarray]):
        """One non-final phase of step k finished: hand the step to the
        next resource of the pipeline.  Each per-client stage (f2 up,
        server lane, f4 down, adapter sync) serializes through the
        scheduler's busy-until times, so steps complete in launch order
        and the engine may index batches by `launches[i]`."""
        sched = self.scheduler
        q = sched.queue
        ph = self._cached_phases(k, cuts_np, cb, t_now)
        if phase == "client_compute":
            sched.cfin[i] += 1
            start = max(t_now, float(sched.eu[i]))
            sched.eu[i] = start + float(ph[1, i])
            q.push((i, "f2_uplink", k), sched.eu[i])
            # the compute unit is free: step k+1 may start while step
            # k's transfers are in flight
            self._overlap_try_compute(i, cuts_np, cb)
        elif phase == "f2_uplink":
            start = max(t_now, float(sched.es[i]))
            sched.es[i] = start + float(ph[2, i])
            q.push((i, "server_compute", k), sched.es[i])
        elif phase == "server_compute":
            start = max(t_now, float(sched.ed[i]))
            sched.ed[i] = start + float(ph[3, i])
            q.push((i, "f4_downlink", k), sched.ed[i])
        elif phase == "f4_downlink":
            start = max(t_now, float(sched.ea[i]))
            sched.ea[i] = start + float(ph[4, i])
            q.push((i, "adapter_sync", k), sched.ea[i])
        else:
            raise ValueError(f"unknown pipeline phase {phase!r}")

    def _async_launch(self, i: int, cuts_np: np.ndarray,
                      cb: Dict[str, np.ndarray]):
        """Put client i's next local step in flight at the current clock:
        one whole-step event (serial) or its first pipeline phase
        (overlap)."""
        sched = self.scheduler
        if sched.overlap:
            self._overlap_try_compute(i, cuts_np, cb)
            return
        launch = int(sched.launches[i])
        t0 = max(sched.queue.now, self.speed.next_available(
            i, sched.queue.now))
        t_i = self._serial_time(i, launch, cuts_np, cb, t0)
        sched.queue.push((i, scheduler_lib.PHASE_STEP, launch), t0 + t_i)

    def _async_ensure_started(self):
        """Launch every active client's first local step onto the event
        queue (no-op when the simulation is in flight, e.g. after a
        restore repopulated it)."""
        sched = self.scheduler
        if sched.started:
            return
        n = self.pool.active.shape[0]
        sched.start(n, clock=self.sim_clock)
        if self._cohort_cursors is not None:
            # population mode: each slot resumes its pid's batch stream,
            # so the launch counters are the cursors
            self._launch_at_cursors()
        cuts_np = self._cuts()
        cb = self._cached_comm(cuts_np)
        # baseline for the flush record before anyone has completed
        sched.last_times = straggler.serial_step_times(
            self._cached_phases(0, cuts_np, cb)).copy()
        for i in range(n):
            if self.pool.active[i]:
                self._async_launch(i, cuts_np, cb)

    def _async_sync_membership(self):
        """Reconcile the event simulation with elastic membership: a
        leaver's in-flight events are dropped, and an active client with
        nothing in flight (a join, or a rejoin after a mid-flight leave)
        enters at the current clock with its next batch index."""
        sched = self.scheduler
        active = self.pool.active
        cuts_np = self._cuts()
        cb = self._cached_comm(cuts_np)
        for i in range(active.shape[0]):
            if not active[i] and sched.queue.discard_client(i):
                sched.reset_client(i)
        sched.pending_relaunch = [i for i in sched.pending_relaunch
                                  if active[i]]
        in_flight = sched.queue.clients()
        for i in range(active.shape[0]):
            if active[i] and i not in in_flight \
                    and i not in sched.pending_relaunch:
                self._async_launch(i, cuts_np, cb)

    def _async_tick(self, r: int, lr_c, lr_s) -> Optional[Dict[str, Any]]:
        """Advance the simulation by one completion tick: pop the
        earliest-finishing phase events, move non-final phases down the
        pipeline, run the step-completing clients through the engine
        (their updates join the buffer) and keep their pipelines fed.
        Returns the round record when this tick flushed the buffer
        (closing round r), None otherwise."""
        sched = self.scheduler
        cuts_np = self._cuts()
        cb = self._cached_comm(cuts_np)
        t_now, keys = sched.queue.pop_next()
        self.sim_clock = sched.queue.now

        finishers: List[int] = []
        for key in keys:
            if isinstance(key, tuple):
                i, phase, k = int(key[0]), key[1], int(key[2])
            else:   # whole-step key of an older checkpoint
                i, phase = int(key), scheduler_lib.PHASE_STEP
                k = int(sched.launches[i])
            if not self.pool.active[i]:
                # elastic leave mid-flight: the event dies with the
                # membership (no engine contribution, no relaunch)
                sched.queue.discard_client(i)
                sched.reset_client(i)
                continue
            if phase in (scheduler_lib.PHASE_STEP,
                         scheduler_lib.PHASE_FINAL):
                finishers.append(i)
            else:
                self._overlap_advance(i, phase, k, t_now, cuts_np, cb)
        if not finishers:
            return None            # pipeline hand-offs only

        act = np.zeros(len(self.loaders), np.float64)
        act[finishers] = 1.0
        # client i's tick consumes its own launch-indexed batch stream, so
        # constant speeds reproduce the sync data order exactly
        batch = stack_client_batches(
            [l.batch(int(sched.launches[i]))
             for i, l in enumerate(self.loaders)])
        self.state, metrics = self.train_step(
            self.base_params, self.state, batch, self._weights32(),
            act.astype(np.float32), lr_c, lr_s)

        sched.round_steps[act > 0] += 1
        aggregated = bool(metrics["aggregated"])
        for i in finishers:
            # the flush record reports the serial step time each client
            # had at ITS launch index
            launch = int(sched.launches[i])
            ph = self._cached_phases(launch, cuts_np, cb, t_now)
            sched.last_times[i] = float(
                straggler.serial_step_times(ph)[i])
            if self._observing:
                m = np.zeros(ph.shape[1], bool)
                m[i] = True
                self._observe_phases(launch, ph, m, cb, t_now)
            sched.launches[i] += 1
        if aggregated:
            # the finishers just received the new global model; their
            # next steps launch after the round epilogue (C3 may move
            # cuts): _async_relaunch
            sched.pending_relaunch = list(finishers)
            plan = RoundPlan(
                active=_np(metrics["buffer_mask"]).astype(np.float64),
                step_budgets=sched.round_steps.copy(),
                sim_time=t_now - sched.last_agg_clock,
                times=sched.last_times.copy(),
                staleness=_np(metrics["staleness"]).astype(np.float64),
                buffer_fill=float(_np(metrics["buffer_fill"])))
            rec = self._round_record(r, metrics, plan, cb)
            sched.round_steps[:] = 0
            sched.last_agg_clock = t_now
            return rec
        for i in finishers:
            self._async_launch(i, cuts_np, cb)
        return None

    def _async_relaunch(self):
        """Launch the aggregation tick's finishers' next steps with the
        post-epilogue cuts.  Under overlap a no-op for a finisher whose
        next compute already started mid-pipeline."""
        sched = self.scheduler
        if not sched.pending_relaunch:
            return
        cuts_np = self._cuts()
        cb = self._cached_comm(cuts_np)
        for i in sched.pending_relaunch:
            if self.pool.active[i]:    # may have left in the epilogue
                self._async_launch(i, cuts_np, cb)
        sched.pending_relaunch = []

    def _launch_at_cursors(self):
        """The async counters of a freshly started cohort at its pids'
        cursors."""
        sched = self.scheduler
        cur = np.asarray(self._cohort_cursors, np.int64)
        sched.launches = cur.copy()
        sched.csched = cur.copy()
        sched.cfin = cur.copy()

    def _pop_async_boundary(self):
        """Population mode at an aggregation: scatter the live cohort,
        draw the next one and, only if its membership changed, restart
        the event pipeline for it at the current clock.  An unchanged
        cohort (P == C in particular) keeps its events in flight, as the
        fleet event stream does."""
        if self.store is None:
            return
        self._pop_scatter()
        old = self._cohort_pids
        pids = self.sampler.sample()
        if old is not None and np.array_equal(pids, old):
            self._cohort_pids = pids
            self._cohort_scattered = False
            return
        self._install_cohort(pids)
        sched = self.scheduler
        n = self.pool.active.shape[0]
        sched.start(n, clock=self.sim_clock)   # drops old in-flight work
        self._launch_at_cursors()
        sched.last_agg_clock = self.sim_clock
        cuts_np = self._cuts()
        cb = self._cached_comm(cuts_np)
        sched.last_times = np.array(
            [self._serial_time(i, int(sched.launches[i]), cuts_np, cb)
             for i in range(n)])
        for i in range(n):
            if self.pool.active[i]:
                self._async_launch(i, cuts_np, cb)

    def _run_async(self, num_rounds: int, *, log_every: int = 10,
                   callback: Optional[Callable] = None
                   ) -> List[Dict[str, Any]]:
        """Event-queue host loop: tick until the buffer flushes, one
        record per aggregation."""
        lr_c, lr_s = self._lrs()
        if self.store is not None and self._cohort_pids is None:
            self._pop_gather()         # first cohort before the pipeline
        self._async_ensure_started()
        if self.scheduler.last_times is None:
            # an older checkpoint without per-launch times: seed real
            # draws so the first flush never reports zeros
            cuts_np = self._cuts()
            cb = self._cached_comm(cuts_np)
            self.scheduler.last_times = np.array(
                [self._serial_time(i, int(self.scheduler.launches[i]),
                                   cuts_np, cb)
                 for i in range(self.pool.active.shape[0])])
        self._async_relaunch()         # resume from a mid-epilogue save
        start = int(self.state["round"])
        for r in range(start, start + num_rounds):
            # a shrunken fleet can strand the buffer below its flush
            # threshold: fail loudly instead of ticking forever
            n_active = int(self.pool.active.sum())
            if n_active < self.scheduler.buffer_size:
                raise RuntimeError(
                    f"async buffer_size={self.scheduler.buffer_size} can "
                    f"never fill: only {n_active} clients are active in "
                    "the pool; rejoin clients or rebuild the system with "
                    "a smaller buffer_size")
            self._async_sync_membership()
            rec = None
            while rec is None:
                rec = self._async_tick(r, lr_c, lr_s)
            self._finish_round(r, rec, log_every, callback)
            self._pop_async_boundary()
            self._async_relaunch()
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
            "weights_drawn_on": self.draw_device.type,
            "sim_clock": self.sim_clock,
            "scheduler": self.scheduler.name,
            # template signature: lets restore() explain a leaf-count
            # mismatch instead of silently restarting from round 0
            "state_keys": sorted(self.state.keys()),
        }
        if self.scheduler.name == "async" and self.store is None:
            # the event simulation (queue, launch counters, pipeline);
            # the buffer and version leaves are in the state.  A
            # mid-buffer save resumes the tick stream exactly: event keys
            # come back as tuples, clock floats bit for bit (JSON floats
            # round-trip through repr).  Population mode instead restarts
            # the pipeline from the restored cohort's cursors, which live
            # in the store's slots.
            meta["async_sim"] = self.scheduler.state_dict()
        if self.speed is not None and self.speed.trace is not None:
            meta["trace"] = self.speed.trace.state_dict()
        if self.pricer is not None:
            tm = self.pricer.state_dict()
            if tm:
                meta["timemodel"] = tm
        if self.store is not None:
            # the cohort's rows back to their slots first, so the slot map
            # is the one source of per-pid state in the checkpoint
            self._pop_scatter()
            meta["population"] = self.store.population
            meta["cohort"] = self.store.cohort
            # the sampler's RNG state, so a restored run draws the same
            # cohort sequence
            meta["cohort_sampler"] = self.sampler.state_dict()
        # the whole cohort (a collective), written once: a checkpoint does
        # not depend on the world size
        full = gather_state(self.state, self.cohort)
        tree = (full if self.store is None
                else {"engine": full, "pop": self.store.state_tree()})
        if self.shard is None or self.shard.rank == 0:
            self.ckpt.save(step, tree, metadata=meta)
        if self.shard is not None:
            self.shard.barrier()

    def restore(self) -> bool:
        """Resume from the newest loadable checkpoint; False when there is
        none.  Raises when checkpoints exist but were written with another
        population, state template or scheduler."""
        assert self.ckpt is not None
        like = (self.state if self.store is None
                else {"engine": self.state, "pop": self.store.state_tree()})
        got = self.ckpt.restore_latest(like)
        if got is None:
            steps = self.ckpt.steps()
            if steps:
                meta = self.ckpt.metadata(steps[-1]) or {}
                saved_pop = meta.get("population")
                if saved_pop is not None and saved_pop != self.population:
                    raise ValueError(
                        f"checkpoint step {steps[-1]} was written with "
                        f"population={saved_pop} but this run has "
                        f"population={self.population or 'fleet mode'}; "
                        "per-pid slot state is not transferable — "
                        "resume with the original --population or use "
                        "a fresh checkpoint dir")
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
        tree, meta, step = got
        drawn = meta.get("weights_drawn_on")
        if drawn is not None and drawn != self.draw_device.type:
            raise ValueError(
                f"checkpoint step {step} was trained on base weights drawn "
                f"on {drawn}, but this run draws them on "
                f"{self.draw_device.type} (one seed gives other weights "
                f"there); restore it with draw_on_device={drawn != 'cpu'}"
                + (f" on a {drawn} device" if drawn != "cpu" else ""))
        if self.store is not None:
            # the loud mismatch checks come after a successful load, so
            # restore_latest's corruption fallback cannot swallow them
            if meta.get("population") is not None \
                    and int(meta["population"]) != self.population:
                raise ValueError(
                    f"checkpoint step {step} holds population="
                    f"{meta['population']} but this run has "
                    f"population={self.population}; pid state is not "
                    "transferable — resume with the original "
                    "--population or use a fresh checkpoint dir")
            if "cohort_sampler" not in meta:
                raise ValueError(
                    f"checkpoint step {step} was written in fleet mode "
                    "(no cohort sampler state) but this run sets "
                    f"population={self.population}; resume without "
                    "--population or use a fresh checkpoint dir")
            self.sampler.load_state_dict(meta["cohort_sampler"])
            self.state = shard_state(
                bridge.state_from_numpy(tree["engine"], self.device),
                self.cohort)
            self.store.load_state_tree(tree["pop"])
            self._cohort_pids = None
            self._cohort_cursors = None
            self._cohort_scattered = True
        else:
            self.state = shard_state(bridge.state_from_numpy(tree,
                                                             self.device),
                                     self.cohort)
        self.c3_weights = np.asarray(meta.get("c3_weights",
                                              self.c3_weights))
        if "active" in meta:
            self.pool.active = np.asarray(meta["active"], bool)
        self.sim_clock = float(meta.get("sim_clock", 0.0))
        if self.scheduler.name == "async" and self.store is None:
            self.scheduler.load_state_dict(meta.get("async_sim") or {})
        if self.speed is not None and self.speed.trace is not None \
                and meta.get("trace") is not None:
            self.speed.trace.load_state_dict(meta["trace"])
        if self.pricer is not None and meta.get("timemodel") is not None:
            self.pricer.load_state_dict(meta["timemodel"])
        return True

    # ------------------------------------------------------------------
    def serve_model(self):
        """(base_params, global adapters) for the serving path.  Under a
        MeshShard: (this rank's base blocks, the global adapters at their
        blocks (``Model.serving_blocks``: contiguous once, for the
        indexed LoRA kernel), the model's policy marked so), which
        ``Model.prefill``/``decode_step`` take with a cache of the rank's
        blocks (``Model.init_cache(policy=)``); the reference returns
        its globally sharded base weights."""
        eff = serve_adapters(self.model, self.state["client_adapters"],
                             self.state["server_adapters"],
                             self.state["cuts"],
                             self.cohort.rows(torch.as_tensor(
                                 self._weights32())),
                             rank_cut=self.state.get("rank_cut"),
                             cohort=self.cohort)
        if self.model_policy is not NO_SHARDING:
            return (self.base_params, *self.model.serving_blocks(
                self.base_params, eff, self.model_policy))
        return self.base_params, eff
