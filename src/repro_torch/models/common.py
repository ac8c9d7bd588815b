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
gather of a layer's base weights over "data", and the two Megatron-style
functions over "model" around each column- and row-parallel pair
(``copy_to_tp``, ``reduce_from_tp``).  ``NO_SHARDING`` (no shard) calls
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


class ShardingPolicy:
    """The collectives of a model whose base weights a MeshShard placed
    (``runtime.sharding.leaf_block``), or none (``NO_SHARDING``).

    ``tp`` / ``tp_rank``: the "model" axis's size and this rank's index
    on it, read from the shard; a dim that ``param_specs`` splits over
    "model" (heads, FFN width, vocabulary) holds this rank's block
    ``tp_rank`` of ``tp``.
    ``fsdp`` / ``fsdp_rank``: the same on "data", over which the base
    weights' d_model dims are split and gathered layer by layer
    (``gather``).  Which dims are split is read from the leaves' shapes
    against the config's, which ``fit_spec``'s divisibility rule makes
    the same thing."""

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
        dense family only: another family on a mesh of more than one
        rank raises (on one rank its blocks are whole: NO_SHARDING), and
        so does a head count that the "model" axis does not divide (the
        reference would split a head across devices)."""
        if shard is None or not getattr(shard, "places_params", False):
            return NO_SHARDING
        cfg = arch.model
        if cfg.family != "dense":
            if shard.world == 1:
                return NO_SHARDING
            raise NotImplementedError(
                f"{arch.name} is of the {cfg.family} family: the port "
                "places the base weights of the dense family only so far "
                f"(experts, SSM and hybrid layers, the audio and vlm "
                f"families under TP): see {roadmap.PARAM_SHARDING}")
        if cfg.num_heads % shard.model_size:
            raise ValueError(
                f"{arch.name}: {cfg.num_heads} heads do not divide over a "
                f"\"model\" axis of {shard.model_size}; the port computes "
                f"whole heads ({roadmap.PARAM_SHARDING})")
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

    def partial_targets(self, cfg, params: Params) -> frozenset:
        """The (group, target) pairs whose adapter gradient this rank
        computes only a part of, read from the rank's base leaves by the
        tests the blocks make (``block``): the attention's when wq holds
        a block of the heads (a column or row block, or the KV heads its
        query heads read), the MLP's when w_in holds one of the FFN
        width.  A target whose whole computation every rank repeats (a
        width that fit_spec leaves whole) has its full gradient on every
        rank."""
        parts = set()
        for name, g in params.items():
            if not isinstance(g, dict) or "wq" not in g:
                continue
            if self.block(cfg.num_heads * cfg.head_dim,
                          g["wq"].shape[-1]) is not None:
                parts |= {(name, t) for t in ("q", "k", "v", "o")}
            if "w_in" in g and self.block(cfg.d_ff,
                                          g["w_in"].shape[-1]) is not None:
                parts |= {(name, t) for t in ("mlp_in", "mlp_gate",
                                              "mlp_out")}
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
        buffers, exact).  The base weights are frozen: a leaf that
        requires grad raises."""
        if self.fsdp == 1:
            return p
        todo = []
        for name, leaf in p.items():
            if not isinstance(leaf, torch.Tensor):
                continue
            spec = logical_spec(name, leaf.dim())
            for dim, ax in enumerate(spec):
                if ax == FSDP_AXES and leaf.shape[dim] != d_model:
                    todo.append((name, dim))
        if not todo:
            return p
        bufs = []
        for name, dim in todo:
            leaf = p[name]
            if leaf.requires_grad:
                raise ValueError(f"base leaf {name!r} requires grad: the "
                                 "FSDP gather carries no gradient")
            n = leaf.shape[dim]
            if n * self.fsdp != d_model:
                raise ValueError(f"{name}: a block of {n} is not one of "
                                 f"{self.fsdp} \"data\" blocks of "
                                 f"{d_model}")
            shape = list(leaf.shape)
            shape[dim] = d_model
            buf = leaf.new_zeros(shape)
            buf.narrow(dim, self.fsdp_rank * n, n).copy_(leaf)
            bufs.append(buf)
        with torch.no_grad():
            full = self.shard.all_reduce(bufs, "sum", axis="data")
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
