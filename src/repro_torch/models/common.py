"""Shared model primitives: initializers, norms, activations, the
LoRA-aware dense projection, the loss, and the sharding policy.

Port of src/repro/models/common.py.  Parameters are nested dicts of
tensors with the reference's names and layouts (``W`` is (d_in, d_out),
per-group stacks keep the leading layer axis), so a JAX tree converted by
``repro_torch.bridge`` drops in as is.

``ShardingPolicy`` is the counterpart of the reference's: where the
reference constrains activations and XLA derives the collectives from
``param_specs``, the port's blocks call the policy's collectives
themselves, over the ranks of a ``runtime.sharding.MeshShard``: the FSDP
gather of a layer's base weights over "data", the two Megatron-style
functions over "model" around each column- and row-parallel pair
(``copy_to_tp``, ``reduce_from_tp``), the exact gather of a block over
"model" (``tp_gather``: the router's logits, the SSM's ``in_proj`` and
conv), and the moves of the MoE experts' activations over "data"
(``data_gather_rows``, ``data_reduce_rows``: the experts' weights stay
where ``param_specs`` put them).  ``NO_SHARDING`` (no shard) calls
nothing, so the unsharded path is the one-card path bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import roadmap
from repro_torch.kernels.lora_matmul import ops as lora_ops
from repro_torch.runtime.sharding import FSDP_AXES, logical_spec

Params = Dict[str, Any]

# the families whose base weights a MeshShard places
PLACED_FAMILIES = ("dense", "moe", "ssm", "hybrid")
# the MoE experts' stacks, split over "model" (the expert axis) and
# "data" (their ff dim)
EXPERT_LEAVES = frozenset({"we_in", "we_gate", "we_out"})


# ---------------------------------------------------------------------------
# Sharding policy


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over the "model" ranks (each
    rank's consumers of x are its column blocks)."""

    @staticmethod
    def forward(ctx, x, policy):
        ctx.policy = policy
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.policy.tp_sum(g), None


class _ReduceFromTP(torch.autograd.Function):
    """The partial sums of a row-parallel product summed over the "model"
    ranks; the gradient passes as it is (every rank's consumers of the
    sum are the same)."""

    @staticmethod
    def forward(ctx, x, policy):
        return policy.tp_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherTP(torch.autograd.Function):
    """This rank's block of a dim's `full` entries into the whole dim on
    every "model" rank (a SUM of zero-filled buffers: exact); the
    gradient keeps the rank's block (every rank's consumers of the whole
    are the same)."""

    @staticmethod
    def forward(ctx, x, policy, dim):
        ctx.dim, ctx.lo, ctx.n = dim, policy.tp_rank * x.shape[dim], \
            x.shape[dim]
        return policy.fill([(x, dim)], "model")[0]

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n), None, None


class _GatherRows(torch.autograd.Function):
    """Every "data" rank's rows of dim 1 into one tensor, rank-major (a SUM
    of zero-filled buffers: exact); the gradient is the rows' sum over
    the "data" ranks, this rank's block kept (the conjugate: a
    reduce-scatter, built from one all-reduce)."""

    @staticmethod
    def forward(ctx, x, policy):
        ctx.policy, ctx.n = policy, x.shape[1]
        return policy.fill([(x, 1)], "data")[0]

    @staticmethod
    def backward(ctx, g):
        return ctx.policy.data_keep(ctx.policy.data_sum(g), ctx.n), None


class _ReduceRows(torch.autograd.Function):
    """The partial sums over the "data" ranks of every rank's rows of dim
    1, this rank's block kept (a reduce-scatter); the gradient is every
    rank's block of the rows gathered again (an all-gather)."""

    @staticmethod
    def forward(ctx, x, policy):
        ctx.policy = policy
        return policy.data_keep(policy.data_sum(x), x.shape[1]
                                // policy.fsdp)

    @staticmethod
    def backward(ctx, g):
        return ctx.policy.fill([(g, 1)], "data")[0], None


class ShardingPolicy:
    """The collectives of a model whose base weights a MeshShard placed
    (``runtime.sharding.leaf_block``), or none (``NO_SHARDING``).

    ``tp`` / ``tp_rank``: the "model" axis's size and this rank's index
    on it, read from the shard; a dim that ``param_specs`` splits over
    "model" (heads, FFN width, vocabulary) holds this rank's block
    ``tp_rank`` of ``tp``.
    ``fsdp`` / ``fsdp_rank``: the same on "data", over which the base
    weights' d_model dims are split and gathered layer by layer
    (``gather``), and the MoE experts' ff dim split and never gathered
    (``moe_apply`` moves the dispatched rows instead).  Which dims are
    split is read from the leaves' shapes against the config's, which
    ``fit_spec``'s divisibility rule makes the same thing."""

    def __init__(self, shard=None):
        self.shard = shard

    @property
    def tp(self) -> int:
        return 1 if self.shard is None else self.shard.model_size

    @property
    def tp_rank(self) -> int:
        return 0 if self.shard is None else self.shard.model_rank

    @property
    def fsdp(self) -> int:
        return 1 if self.shard is None else self.shard.data_size

    @property
    def fsdp_rank(self) -> int:
        return 0 if self.shard is None else self.shard.data_rank

    @classmethod
    def for_model(cls, shard, arch) -> "ShardingPolicy":
        """The policy of a model under `shard`: NO_SHARDING without one
        or under a ClientShard (base weights whole).  The port places the
        dense, MoE (experts over "model", their ff dim over "data"), SSM
        and hybrid families; the audio and vlm families on a mesh of more
        than one rank raise (on one rank their blocks are whole:
        NO_SHARDING), and so does a head count that the "model" axis
        does not divide: the attention heads of a family that has
        attention, the SSM heads of one that has SSM layers (the
        reference would split a head across devices)."""
        if shard is None or not getattr(shard, "places_params", False):
            return NO_SHARDING
        cfg = arch.model
        if cfg.family not in PLACED_FAMILIES:
            if shard.world == 1:
                return NO_SHARDING
            raise NotImplementedError(
                f"{arch.name} is of the {cfg.family} family: the port "
                "places the base weights of the dense, MoE, SSM and hybrid "
                "families only so far (the audio and vlm families under "
                f"TP): see {roadmap.PARAM_SHARDING}")
        counts = []
        if cfg.family != "ssm":
            counts.append(("heads", cfg.num_heads))
        if cfg.family in ("ssm", "hybrid"):
            counts.append(("SSM heads", cfg.ssm_heads))
        for what, n in counts:
            if n % shard.model_size:
                raise ValueError(
                    f"{arch.name}: {n} {what} do not divide over a "
                    f"\"model\" axis of {shard.model_size}; the port "
                    f"computes whole heads ({roadmap.PARAM_SHARDING})")
        return cls(shard)

    # -- collectives ----------------------------------------------------
    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.shard.all_reduce([x], "sum", axis="model")[0]

    def tp_sum_many(self, xs):
        if self.tp == 1 or not xs:
            return list(xs)
        return self.shard.all_reduce(list(xs), "sum", axis="model")

    def tp_max(self, x: torch.Tensor) -> torch.Tensor:
        """MAX over the "model" ranks, no gradient."""
        return self.shard.all_reduce([x.detach()], "max", axis="model")[0]

    def copy_to_tp(self, x):
        return x if self.tp == 1 else _CopyToTP.apply(x, self)

    def reduce_from_tp(self, x):
        return x if self.tp == 1 else _ReduceFromTP.apply(x, self)

    def sum_tp(self, x):
        """The sum over the "model" ranks of per-rank parts whose
        consumers differ by rank (the gated norm's sum of squares over
        the rank's heads): summed forward, and the gradient summed
        backward too."""
        return self.reduce_from_tp(self.copy_to_tp(x))

    def fill(self, parts, axis: str):
        """Each (x, dim) of `parts`, this rank's block of `dim`, into the
        whole dim on every rank of `axis` (the blocks rank-major), no
        gradient: one SUM of zero-filled buffers (exact) for all of
        them."""
        size, rank = ((self.tp, self.tp_rank) if axis == "model"
                      else (self.fsdp, self.fsdp_rank))
        bufs = []
        for x, dim in parts:
            n = x.shape[dim]
            shape = list(x.shape)
            shape[dim] = n * size
            buf = x.detach().new_zeros(shape)
            buf.narrow(dim, rank * n, n).copy_(x.detach())
            bufs.append(buf)
        with torch.no_grad():
            return self.shard.all_reduce(bufs, "sum", axis=axis)

    def tp_gather(self, x: torch.Tensor, dim: int):
        """The whole of a dim that "model" splits, on every rank (the
        router's logits, the SSM's in_proj and conv): each rank's
        consumers of the whole are the same, so the gradient keeps the
        rank's block."""
        return x if self.tp == 1 else _GatherTP.apply(x, self, dim)

    # -- the MoE experts' rows over "data" (their ff dim is split) --------
    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.shard.all_reduce([x], "sum", axis="data")[0]

    def data_keep(self, x: torch.Tensor, n: int) -> torch.Tensor:
        return x.narrow(1, self.fsdp_rank * n, n).contiguous()

    def data_gather_rows(self, x):
        """The experts' dispatched rows (E_local, n, d) of every "data"
        rank, (E_local, fsdp n, d): each rank then runs its block of the
        experts' ff dim over all of them."""
        return x if self.fsdp == 1 else _GatherRows.apply(x, self)

    def data_reduce_rows(self, x):
        """The partial expert outputs of every rank's ff block summed over
        "data", this rank's rows kept: the inverse move of
        data_gather_rows."""
        return x if self.fsdp == 1 else _ReduceRows.apply(x, self)

    def partial_targets(self, cfg, params: Params) -> frozenset:
        """The (group, target) pairs whose adapter gradient this rank
        computes only a part of, read from the rank's base leaves by the
        tests the blocks make (``block``): the attention's when wq holds
        a block of the heads (a column or row block, or the KV heads its
        query heads read), the MLP's when w_in holds one of the FFN
        width, the shared expert's (the same targets) when ws_in holds
        one of its width, and the SSM's when A_log holds a block of its
        heads (``ssm_apply``: in_proj's columns of those heads and B and
        C, which every head reads; out_proj's rows).  A target whose
        whole computation every rank repeats (a width that fit_spec
        leaves whole) has its full gradient on every rank."""
        parts = set()
        mlp = ("mlp_in", "mlp_gate", "mlp_out")
        for name, g in params.items():
            if not isinstance(g, dict):
                continue
            if "wq" in g and self.block(cfg.num_heads * cfg.head_dim,
                                        g["wq"].shape[-1]) is not None:
                parts |= {(name, t) for t in ("q", "k", "v", "o")}
            if "w_in" in g and self.block(cfg.d_ff,
                                          g["w_in"].shape[-1]) is not None:
                parts |= {(name, t) for t in mlp}
            if "ws_in" in g and self.block(
                    cfg.moe_d_ff * cfg.num_shared_experts,
                    g["ws_in"].shape[-1]) is not None:
                parts |= {(name, t) for t in mlp}
            if "A_log" in g and self.block(cfg.ssm_heads,
                                           g["A_log"].shape[-1]) is not None:
                parts |= {(name, "ssm_in"), (name, "ssm_out")}
        return frozenset(parts)

    # -- blocks -----------------------------------------------------------
    def block(self, full: int, local: int) -> Optional[int]:
        """The offset of this rank's block of a dim of `full` entries held
        as `local`, or None when the dim is whole."""
        if self.tp == 1 or local == full:
            return None
        if local * self.tp != full:
            raise ValueError(f"a block of {local} of {full} entries is not "
                             f"one of {self.tp} \"model\" blocks")
        return self.tp_rank * local

    def gather(self, p: Params, d_model: int) -> Params:
        """One layer's (or the embedding's) leaves with every d_model dim
        that FSDP split over "data" gathered (one SUM of zero-filled
        buffers, exact); the MoE experts' leaves stay as they are.  The
        base weights are frozen: a leaf that requires grad raises."""
        if self.fsdp == 1:
            return p
        todo = []
        for name, leaf in p.items():
            # the experts' ff dim stays split: moe_apply moves rows
            if not isinstance(leaf, torch.Tensor) or name in EXPERT_LEAVES:
                continue
            spec = logical_spec(name, leaf.dim())
            for dim, ax in enumerate(spec):
                if ax == FSDP_AXES and leaf.shape[dim] != d_model:
                    todo.append((name, dim))
        if not todo:
            return p
        for name, dim in todo:
            leaf = p[name]
            if leaf.requires_grad:
                raise ValueError(f"base leaf {name!r} requires grad: the "
                                 "FSDP gather carries no gradient")
            if leaf.shape[dim] * self.fsdp != d_model:
                raise ValueError(f"{name}: a block of {leaf.shape[dim]} is "
                                 f"not one of {self.fsdp} \"data\" blocks "
                                 f"of {d_model}")
        full = self.fill([(p[name], dim) for name, dim in todo], "data")
        out = dict(p)
        out.update({name: t for (name, _), t in zip(todo, full)})
        return out


NO_SHARDING = ShardingPolicy()


# ---------------------------------------------------------------------------
# Initializers (drawn on the generator's device from an explicit
# generator: a CPU generator gives the same weights on every device)


def whole(name: str, leaf: torch.Tensor) -> torch.Tensor:
    """The `place` of the initializers that keeps every leaf whole."""
    return leaf


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, *, lead=()) -> torch.Tensor:
    scale = (1.0 / d_in) ** 0.5
    # scaled in place: one leaf-sized buffer while it is drawn
    return torch.randn(tuple(lead) + (d_in, d_out), generator=gen,
                       device=gen.device).mul_(scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=gen.device)
            * 0.02).to(dtype)


def init_norm(d: int, *, bias: bool, dtype=torch.float32, lead=(),
              place=whole) -> Params:
    p = {"scale": place("scale", torch.ones(tuple(lead) + (d,),
                                            dtype=dtype))}
    if bias:
        p["bias"] = place("bias", torch.zeros(tuple(lead) + (d,),
                                              dtype=dtype))
    return p


# ---------------------------------------------------------------------------
# Norms


def apply_norm(p: Params, x, *, kind: str, eps: float):
    """RMSNorm / LayerNorm in fp32 with rsqrt(var + eps), cast back."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations (jax.nn.gelu defaults to the tanh approximation)


def activate(x, gate, kind: str):
    """Apply activation. `gate` is the gate branch for GLU variants (or None)."""
    if kind == "swiglu":
        return F.silu(gate) * x
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * x
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    raise ValueError(kind)


def is_glu(kind: str) -> bool:
    return kind in ("swiglu", "geglu")


# ---------------------------------------------------------------------------
# LoRA-aware dense application
#
# adapter = {"A": (d_in, r), "B": (r, d_out), "scale": scalar} or None.


def lora_dense(x, w, b=None, adapter=None):
    """y = x @ W (+ b) (+ scale * (x @ A) @ B) through the fused LoRA
    kernel (its plain version on the CPU).  Base weights are frozen
    (LoRA fine-tuning), so W gets no gradient and dW is never computed."""
    if adapter is not None:
        y = lora_ops.lora_matmul(x, w, adapter["A"], adapter["B"],
                                 adapter["scale"])
    else:
        y = x @ w
    if b is not None:
        y = y + b
    return y


# ---------------------------------------------------------------------------
# Rotary position embeddings (plain elementwise torch, as the reference's
# are jnp outside any kernel)


def rope_angles(positions, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin of shape (..., head_dim // 2), fp32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., T, H, hd); cos/sin: (..., T, hd//2) broadcast over heads.
    The half-split layout (not interleaved), cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Loss


def cross_entropy(logits, labels, mask=None):
    """Mean next-token CE over (masked) positions, in fp32."""
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) - torch.gather(
        lf, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def token_accuracy(logits, labels, mask=None):
    hit = (torch.argmax(logits, dim=-1) == labels.long()).float()
    if mask is None:
        return hit.mean()
    mask = mask.float()
    return (hit * mask).sum() / torch.clamp(mask.sum(), min=1.0)
