"""Configuration schema of the PyTorch port (a copy of the JAX package's).

Everything a run needs is described by a tree of frozen dataclasses:

  ArchConfig        -- one per architecture (repro_torch/configs/<id>.py)
    ModelConfig     -- backbone hyperparameters
    LoRAConfig      -- per-layer rank policy (the paper's C2)
    SplitConfig     -- cut-layer placement + adaptive policy (C1/C3)
  TrainConfig       -- optimizer / schedule / remat / dtype knobs
  DataConfig        -- dataset + partitioner (C4)

  ShapeConfig       -- one assigned shape cell (SHAPES: train_4k,
                       prefill_32k, decode_32k, long_500k)
  MeshConfig        -- the device layout a cell is sized for

The port keeps its own copy so that it never imports the JAX package; the
fields and defaults are the reference's, so a config built here describes
the same model as the reference's config of the same name, and an
(arch x shape) cell of the dry-run (``repro_torch.launch.dryrun``) is the
reference's cell.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

# ---------------------------------------------------------------------------
# Model


@dataclass(frozen=True)
class ModelConfig:
    """Backbone hyperparameters, covering every assigned family."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # Attention details
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    learned_pos: bool = False         # GPT2/OPT-style learned positions
    max_position_embeddings: int = 1 << 20
    local_window: int = 0             # >0: sliding-window attention width
    local_every_other: bool = False   # GPT-Neo: alternate global/local layers

    # FFN details
    activation: str = "swiglu"        # swiglu | gelu | relu | geglu
    mlp_bias: bool = False

    # Norm / embedding details
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    moe_top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                 # per-expert FF dim (0 -> d_ff)
    router_aux_loss: float = 0.0
    moe_capacity_factor: float = 1.25  # >= num_experts/top_k -> dropless

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0                # N (state dim); 0 -> no SSM
    ssm_head_dim: int = 64            # P
    ssm_expand: int = 2               # d_inner = expand * d_model
    ssm_conv_width: int = 4
    ssm_chunk: int = 256              # SSD chunk length
    ssm_groups: int = 1               # G: B/C projection groups (Mamba2: 1)

    # Hybrid (zamba2-style): indices of layers that are attention blocks;
    # everything else is an SSM block.  Empty + family=='hybrid' -> every 6th.
    attn_layer_indices: Tuple[int, ...] = ()

    # Encoder-decoder (whisper-style)
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0          # fixed encoder output length (1500 frames)

    # Modality frontend stubs (vlm / audio): input_specs() supplies
    # precomputed patch/frame embeddings of this many prefix positions.
    frontend_prefix_len: int = 0
    frontend_dim: int = 0             # embedding dim supplied by the stub

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.family == "hybrid" and not self.attn_layer_indices:
            object.__setattr__(
                self,
                "attn_layer_indices",
                tuple(i for i in range(self.num_layers) if i % 6 == 5),
            )
        if self.family == "moe" and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # -- derived quantities ------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic token mixing -> long_500k applies."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def layer_kind(self, i: int) -> str:
        """'attn' | 'ssm' for decoder layer i."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid":
            return "attn" if i in self.attn_layer_indices else "ssm"
        return "attn"

    def param_count(self) -> int:
        """Analytic total parameter count (embeddings included once)."""
        d, v = self.d_model, self.vocab_size
        total = v * d  # token embedding
        if not self.tie_embeddings:
            total += v * d  # lm head
        if self.learned_pos:
            total += self.max_position_embeddings * d

        def attn_params() -> int:
            hd = self.head_dim
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            b = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
            return q + kv + o + b

        def dense_mlp_params(dff: int) -> int:
            mats = 3 if self.activation in ("swiglu", "geglu") else 2
            return mats * d * dff

        def moe_params() -> int:
            per = dense_mlp_params(self.moe_d_ff)
            total_e = self.num_experts * per + d * self.num_experts  # + router
            total_e += self.num_shared_experts * per
            return total_e

        def ssm_params() -> int:
            di, n, h = self.d_inner, self.ssm_state, self.ssm_heads
            g = self.ssm_groups
            in_proj = d * (2 * di + 2 * g * n + h)  # x, z, B, C, dt
            conv = self.ssm_conv_width * (di + 2 * g * n)
            out = di * d
            extra = 2 * h  # A_log, D
            return in_proj + conv + out + extra

        n_dec = self.num_layers
        for i in range(n_dec):
            kind = self.layer_kind(i)
            total += 2 * d  # norms
            if kind == "ssm":
                total += ssm_params()
            else:
                total += attn_params()
                if self.family == "moe":
                    total += moe_params()
                elif self.d_ff > 0:
                    total += dense_mlp_params(self.d_ff)
        if self.family == "hybrid":
            # hybrid attn layers also carry a dense MLP
            pass
        for i in range(self.num_encoder_layers):
            total += attn_params() + dense_mlp_params(self.d_ff) + 2 * d
            total += attn_params()  # decoder cross-attn counted here (1 per dec layer approx)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        mats = 3 if self.activation in ("swiglu", "geglu") else 2
        per_expert = mats * d * self.moe_d_ff
        inactive = (self.num_experts - self.moe_top_k) * per_expert * self.num_layers
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# LoRA (paper C2)


@dataclass(frozen=True)
class LoRAConfig:
    r_others: int = 16
    r_cut: int = 8
    alpha: float = 16.0               # scaling = alpha / r  (per-adapter)
    dropout: float = 0.0
    # Which projections get adapters.  The paper applies LoRA to attention
    # modules; we default to attn + mlp in/out to cover SSM archs too.
    targets: Tuple[str, ...] = ("q", "k", "v", "o")
    lora_on_experts: bool = False     # see DESIGN.md kimi-k2 caveat
    two_side_cut: bool = True         # paper Fig 2a: reduce rank on BOTH sides

    def rank_for_layer(self, layer: int, cut_layer: int) -> int:
        """Rank assigned to decoder layer `layer` given the cut position.

        cut_layer = m means layers [0, m) are client-side; the cut layer is
        the last client layer (m-1) and, with two_side_cut, also the first
        server layer (m)."""
        if layer == cut_layer - 1:
            return self.r_cut
        if self.two_side_cut and layer == cut_layer:
            return self.r_cut
        return self.r_others


# ---------------------------------------------------------------------------
# Split (paper C1 + C3)


@dataclass(frozen=True)
class SplitConfig:
    cut_layer: int = 2                  # m: number of client-side layers
    adaptive: bool = True               # paper C3
    gamma: float = 0.5                  # weight-rule control factor
    cut_buckets: Tuple[int, ...] = ()   # allowed cut positions (static set);
                                        # empty -> {1..min(8, M-1)} ∪ {cut_layer}
    min_cut: int = 1
    max_cut: int = 0                    # 0 -> num_layers - 1
    # Smashed-activation channel (f2 uplink / f4 gradient downlink)
    # compressor: none | int8 | fp8 | topk (repro.core.smashed).  The paper
    # models keep "none" (parity with its experiments); bandwidth-bound
    # deployments of the large assigned archs default to int8.
    smashed_compress: str = "none"
    smashed_topk_frac: float = 0.1      # kept fraction for the topk scheme
    # Round scheduler (repro.core.scheduler): sync (paper Algorithm 1) |
    # deadline (straggler drop) | local_steps (speed-proportional K_i) |
    # async (FedBuff-style buffered asynchrony, no barrier).
    # SystemConfig.scheduler overrides per run.
    scheduler: str = "sync"
    max_local_steps: int = 4            # static K cap for local_steps
    deadline_frac: float = 1.5          # drop threshold for deadline
    async_buffer_size: int = 2          # async: aggregate every M distinct
                                        # client completions (clamped to N)
    staleness_power: float = 0.5        # async: (1+staleness)^-p discount
    # Overlapped communication (simulated clock only — training numerics
    # are identical): pipeline the per-step phases (client compute -> f2
    # uplink -> server compute -> f4 downlink -> adapter sync) double-
    # buffered, one outstanding transfer per direction, so uplink of
    # step k hides behind compute of k+1.  False = the legacy serial
    # clock (phases charged back to back).
    overlap_comm: bool = False
    # C3 controller: "accuracy" = the paper's accuracy-only cut rule;
    # "co" = the phase-time co-controller — per client, pick the (cut
    # bucket, rank-at-cut bucket, smashed compressor) triple minimizing
    # the PREDICTED pipelined makespan (SpeedModel.phase_times over
    # comm.py bytes), with accuracy gating direction via the dead-band
    # (repro.core.adaptive.co_adjust).
    controller: str = "accuracy"
    rank_buckets: Tuple[int, ...] = ()       # rank-at-cut search set;
                                             # empty -> (lora.r_cut,)
    compressor_buckets: Tuple[str, ...] = () # smashed-compressor search
                                             # set; empty ->
                                             # (smashed_compress,)
    acc_dead_band: float = 0.002             # accuracy dead-band half-width
    min_gain: float = 0.05                   # relative predicted-makespan
                                             # improvement required to move
                                             # (co_adjust hysteresis)
    continuous_topk: bool = False            # co: tune the topk keep
                                             # fraction continuously
                                             # (state["topk_frac"]);
                                             # needs "topk" in the
                                             # compressor buckets
    # Hierarchical (two-tier) aggregation: clients FedAvg within each of
    # edge_groups edge aggregators, then the edges FedAvg to the server.
    # 1 = flat single-tier (the paper path, bitwise).  The edge->server
    # hop is priced by SpeedModel.server_ingest_bw / edge_bw.
    edge_groups: int = 1
    # Down-weight each client's per-inner-step gradient into the shared
    # server adapters by 1/K_i under local_steps/async so multi-step
    # clients do not over-train the server side.  K == 1 is bitwise
    # either way (rounds.make_train_step).
    server_step_norm: bool = True

    def buckets(self, num_layers: int) -> Tuple[int, ...]:
        if self.cut_buckets:
            return tuple(sorted(set(self.cut_buckets)))
        hi = self.max_cut or (num_layers - 1)
        step = max(1, num_layers // 8)
        b = set(range(max(1, self.min_cut), hi + 1, step))
        b.add(self.cut_layer)
        return tuple(sorted(x for x in b if 1 <= x < num_layers))


# ---------------------------------------------------------------------------
# Training / data


@dataclass(frozen=True)
class TrainConfig:
    lr_client: float = 5e-5
    lr_server: float = 5e-5
    optimizer: str = "adamw"          # adamw | sgd
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 0
    total_steps: int = 1000
    batch_size: int = 4               # paper: 4
    seq_len: int = 512                # paper: 512
    microbatch: int = 0               # 0 -> no accumulation
    remat: str = "none"               # none | dots | full
    dtype: str = "float32"            # compute dtype
    param_dtype: str = "float32"
    lora_only: bool = True            # freeze base (paper setting)
    seed: int = 0


@dataclass(frozen=True)
class DataConfig:
    num_clients: int = 5              # paper: 5
    partition: str = "dirichlet"      # iid | dirichlet
    alpha: float = 0.9
    num_length_classes: int = 8       # K in the paper's length-based scheme
    samples_per_client: int = 12000   # paper: 12000
    corpus: str = "synthetic"         # synthetic | bytes:<path>
    seed: int = 0
    # Fleet scale: total client population.  0 = fleet mode (the
    # num_clients clients ARE the population, paper setting).  > 0 =
    # population mode: each round a seeded cohort of num_clients ids is
    # drawn from this many clients, with per-id persistent state
    # (runtime.population).  population == num_clients reproduces fleet
    # mode bitwise.
    population: int = 0


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


# The four assigned shape cells (identical for every LM arch).
SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


# ---------------------------------------------------------------------------
# Top-level arch config


@dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    split: SplitConfig = field(default_factory=SplitConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    source: str = ""                  # provenance tag from the assignment

    @property
    def name(self) -> str:
        return self.model.name

    def shape_applicable(self, shape: ShapeConfig) -> Tuple[bool, str]:
        """Whether an assigned shape cell applies to this arch."""
        if shape.name == "long_500k" and not self.model.supports_long_context:
            return False, "quadratic attention: long_500k skipped per brief"
        if shape.name == "long_500k" and self.model.family == "audio":
            return False, "enc-dec audio: 500k target length architecturally undefined"
        return True, ""

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def reduced(cfg: ArchConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 512, experts: int = 4, seq_len: int = 64,
            batch: int = 2) -> ArchConfig:
    """Shrink a config to smoke-test scale, preserving the family shape."""
    m = cfg.model
    heads = max(2, min(4, m.num_heads)) if m.num_heads else 0
    kv = heads if m.num_kv_heads == m.num_heads else max(1, heads // 2)
    head_dim = d_model // heads if heads else 0
    kw: Dict[str, Any] = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv if m.num_kv_heads else 0,
        head_dim=head_dim,
        d_ff=d_model * 4 if m.d_ff else 0,
        vocab_size=vocab,
        max_position_embeddings=max(seq_len * 4, 256),
        frontend_prefix_len=min(m.frontend_prefix_len, 8),
        frontend_dim=d_model if m.frontend_dim else 0,
    )
    if m.num_experts:
        # dropless at smoke scale so prefill/decode match full forward
        kw.update(num_experts=experts, moe_top_k=min(m.moe_top_k, 2),
                  moe_d_ff=d_model * 2,
                  num_shared_experts=min(m.num_shared_experts, 1),
                  moe_capacity_factor=float(experts))
    if m.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if m.family == "hybrid":
        kw.update(attn_layer_indices=(1,))
    if m.num_encoder_layers:
        kw.update(num_encoder_layers=layers, encoder_seq_len=16)
    if m.local_window:
        kw.update(local_window=min(m.local_window, 32))
    model = dataclasses.replace(m, **kw)
    split = dataclasses.replace(
        cfg.split, cut_layer=max(1, layers // 2), cut_buckets=tuple(range(1, layers)))
    lora = dataclasses.replace(cfg.lora, r_others=4, r_cut=2)
    train = dataclasses.replace(cfg.train, seq_len=seq_len, batch_size=batch,
                                total_steps=4)
    data = dataclasses.replace(cfg.data, num_clients=3, samples_per_client=32)
    return ArchConfig(model=model, lora=lora, split=split, train=train,
                      data=data, source=cfg.source + "+reduced")
