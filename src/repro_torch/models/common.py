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
gather of a layer's base weights over the FSDP axes ("pod", "data"),
the two Megatron-style functions over "model" around each column- and
row-parallel pair (``enter``, ``leave``: ``copy_to_tp`` and
``reduce_from_tp``, or under sequence parallelism the gather of the
sequence and the reduce-scatter back to the rank's block), the exact
gather of a block over "model" (``tp_gather``: the router's logits, the
SSM's ``in_proj`` and conv), the moves of the MoE experts' activations
over the FSDP axes (``data_gather_rows``, ``data_reduce_rows``: the
experts' weights stay where ``param_specs`` put them), the split of a
client's batch rows over "pod" (``split_rows``, the loss's sums over
them), the whole message at the cut (``whole_message``), and in serving
the batch rows of a cache over the FSDP axes (``batch_block``) and the
merge of a decode step's partial attention over a KV sequence split on
"model" (``merge_decode``).
``NO_SHARDING`` (no shard) calls nothing, so the unsharded path is the
one-card path bit for bit.

Every gather is a SUM of zero-filled buffers and every reduce-scatter
an all-reduce SUM then the rank's block: gloo takes only all_reduce and
broadcast on CUDA tensors, and so the gathered values are exact and a
reduce-scatter's block holds the bits of the whole sum's.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import roadmap
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.lora_matmul import ops as lora_ops
from repro_torch.runtime.sharding import FSDP_AXES, logical_spec

Params = Dict[str, Any]

# the MoE experts' stacks, split over "model" (the expert axis) and the
# FSDP axes (their ff dim)
EXPERT_LEAVES = frozenset({"we_in", "we_gate", "we_out"})
# the families whose residual stream the reference splits over "model"
# unless told otherwise (src/repro/launch/cells.py: the SSD scan needs
# the contiguous sequence)
NO_SEQ_SHARD_FAMILIES = ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# Sharding policy


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axis_name(axes) -> Any:
    """A mesh axis as MeshShard.all_reduce takes it: a name for one axis,
    the tuple for the FSDP axes joined."""
    axes = _axes(axes)
    return axes[0] if len(axes) == 1 else axes


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


class _Reduce(torch.autograd.Function):
    """The partial sums of every rank of `axes` summed; the gradient
    passes as it is (every rank's consumers of the sum are the same):
    reduce_from_tp over "model", the loss's sums over "pod"."""

    @staticmethod
    def forward(ctx, x, policy, axes):
        return policy.sum_over(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """This rank's block of `dim` into the whole dim on every rank of
    `axes` (exact).  The gradient: with `summed`, the whole's gradient
    summed over the ranks, this rank's block kept (a reduce-scatter: each
    rank's consumers of the whole are its "model" blocks, or its rows);
    without, this rank's block of it (every rank's consumers are the
    same)."""

    @staticmethod
    def forward(ctx, x, policy, dim, axes, summed):
        ctx.policy, ctx.dim, ctx.axes, ctx.summed = policy, dim, axes, summed
        ctx.n = x.shape[dim]
        return policy.fill([(x, dim)], axes)[0]

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = ctx.policy.sum_over(g, ctx.axes)
        return (ctx.policy.keep(g, ctx.dim, ctx.n, ctx.axes), None, None,
                None, None)


class _ReduceScatter(torch.autograd.Function):
    """The partial sums of every rank of `axes` summed, this rank's block
    of `dim` kept; the gradient is every rank's block gathered again."""

    @staticmethod
    def forward(ctx, x, policy, dim, axes):
        ctx.policy, ctx.dim, ctx.axes = policy, dim, axes
        n = x.shape[dim] // policy.axis_size(axes)
        return policy.keep(policy.sum_over(x, axes), dim, n, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.policy.fill([(g, ctx.dim)], ctx.axes)[0], None, None, None


class _Keep(torch.autograd.Function):
    """This rank's block of `dim` of a whole that every rank of `axes`
    computed alike; the gradient is every rank's block gathered (the
    whole's gradient on every rank)."""

    @staticmethod
    def forward(ctx, x, policy, dim, axes):
        ctx.policy, ctx.dim, ctx.axes = policy, dim, axes
        n = x.shape[dim] // policy.axis_size(axes)
        return policy.keep(x, dim, n, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.policy.fill([(g, ctx.dim)], ctx.axes)[0], None, None, None


class _WholeMessage(torch.autograd.Function):
    """fn over the whole stream: this rank's block gathered, fn run on the
    whole (every rank alike), this rank's block of its output kept; the
    backward gathers every rank's block of the gradient and runs fn's
    backward on the whole, so a compressor sees whole messages both
    ways (its straight-through backward compresses the whole
    cotangent).  fn's extra output (a stateful hook's carry) comes back
    through `extra`."""

    @staticmethod
    def forward(ctx, x, policy, fn, carry, extra):
        whole = policy.whole_stream(x).requires_grad_(True)
        with torch.enable_grad():
            y, extra["carry"] = fn(whole, carry)
        ctx.policy, ctx.whole, ctx.y = policy, whole, y
        return policy.stream_block(y.detach())

    @staticmethod
    def backward(ctx, g):
        gw = ctx.policy.whole_stream(g)
        dx, = torch.autograd.grad(ctx.y, ctx.whole, gw)
        return ctx.policy.stream_block(dx), None, None, None, None


class ShardingPolicy:
    """The collectives of a model whose base weights a MeshShard placed
    (``runtime.sharding.leaf_block``), or none (``NO_SHARDING``).

    ``tp`` / ``tp_rank``: the "model" axis's size and this rank's index
    on it, read from the shard; a dim that ``param_specs`` splits over
    "model" (heads, FFN width, vocabulary) holds this rank's block
    ``tp_rank`` of ``tp``.
    ``fsdp``: the size of the FSDP axes ("pod", "data") together, over
    which the base weights' d_model dims are split (over the axes that
    ``fit_spec`` keeps for the dim, ``fsdp_axes``) and gathered layer by
    layer (``gather``), and the MoE experts' ff dim split and never
    gathered (``moe_apply`` moves the dispatched rows instead).  Which
    dims are split is read from the leaves' shapes against the
    config's, which ``fit_spec``'s divisibility rule makes the same
    thing.
    ``seq_shard``: the reference's sequence parallelism.  A policy made
    for a stream (``for_stream``) has ``sp`` set when the stream's
    sequence divides the "model" axis (the reference's ``act``): between
    sub-blocks each rank then holds the block [m S/tp, (m+1) S/tp) of
    the residual stream, norms and residual adds run on it, and each
    sub-block gathers the sequence at its input (``enter``) and
    reduce-scatters it at its output (``leave``).  ``rows``: the
    client's batch rows are split over "pod" (``split_rows``).
    ``adapters_at_blocks``: the adapters were narrowed to the blocks of
    the base weights once (``Model.serving_blocks``), so the layers
    apply them as they are (``transformer.adapter_blocks``)."""

    def __init__(self, shard=None, seq_shard: bool = False):
        self.shard = shard
        self.seq_shard = bool(seq_shard)
        self.sp = False
        self.rows = False
        self.adapters_at_blocks = False

    def _size(self, attr: str) -> int:
        return 1 if self.shard is None else getattr(self.shard, attr, 1)

    def _rank(self, attr: str) -> int:
        return 0 if self.shard is None else getattr(self.shard, attr, 0)

    @property
    def tp(self) -> int:
        return self._size("model_size")

    @property
    def tp_rank(self) -> int:
        return self._rank("model_rank")

    @property
    def pod(self) -> int:
        return self._size("pod_size")

    @property
    def fsdp(self) -> int:
        return self.pod * self._size("data_size")

    @property
    def splits_stream(self) -> bool:
        return self.sp or self.rows

    @classmethod
    def for_model(cls, shard, arch,
                  seq_shard: Optional[bool] = None) -> "ShardingPolicy":
        """The policy of a model under `shard`: NO_SHARDING without one
        or under a ClientShard (base weights whole).  A head count that
        the "model" axis does not divide raises: the attention heads of
        a family that has attention, the SSM heads of one that has SSM
        layers (the reference would split a head across devices).
        seq_shard: sequence parallelism; None takes the shard's, and
        where that is None too the reference's rule (on unless the
        family is SSM or hybrid)."""
        if shard is None or not getattr(shard, "places_params", False):
            return NO_SHARDING
        cfg = arch.model
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
        if seq_shard is None:
            seq_shard = getattr(shard, "seq_shard", None)
        if seq_shard is None:
            seq_shard = cfg.family not in NO_SEQ_SHARD_FAMILIES
        return cls(shard, seq_shard=seq_shard)

    def _with(self, **flags) -> "ShardingPolicy":
        if all(getattr(self, k) == v for k, v in flags.items()):
            return self
        out = copy.copy(self)
        out.__dict__.update(flags)
        return out

    def for_stream(self, seq_len: int) -> "ShardingPolicy":
        """This policy for a residual stream of seq_len positions in the
        training forward or a prefill: ``sp`` when seq_shard is on and the
        sequence divides the "model" axis, on every rank alike (the
        reference's ``act``: a sequence that does not divide is not
        split; a serving policy has seq_shard on for a prefill only, as
        the reference's serve cells build it)."""
        return self._with(sp=(self.seq_shard and self.tp > 1
                              and seq_len % self.tp == 0))

    def split_rows(self, batch):
        """(this rank's rows of a batch, the policy for them): the
        per-client batch dim (tokens, labels, mask: second to last;
        prefix and frames: third to last) over "pod" when "pod" divides
        it (``batch_specs``), else the whole batch on every pod rank and
        no sum over "pod" (each client would count pod times)."""
        b = batch["tokens"].shape[-2]
        if self.pod == 1 or b % self.pod:
            return batch, self._with(rows=False)
        n, lo = b // self.pod, self._rank("pod_rank") * (b // self.pod)
        out = {}
        for k, v in batch.items():
            dim = v.dim() - (3 if k in ("prefix", "frames") else 2)
            out[k] = v.narrow(dim, lo, n)
        return out, self._with(rows=True)

    # -- collectives ----------------------------------------------------
    def axis_size(self, axes) -> int:
        size = 1
        for a in _axes(axes):
            size *= self._size(f"{a}_size")
        return size

    def axis_rank(self, axes) -> int:
        index = 0
        for a in _axes(axes):
            index = index * self._size(f"{a}_size") + self._rank(f"{a}_rank")
        return index

    def sum_over(self, x: torch.Tensor, axes) -> torch.Tensor:
        if _axes(axes) == ("model",):
            return self.tp_sum(x)
        return self.shard.all_reduce([x], "sum", axis=_axis_name(axes))[0]

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.shard.all_reduce([x], "sum", axis="model")[0]

    def tp_sum_many(self, xs):
        if self.tp == 1 or not xs:
            return list(xs)
        return self.shard.all_reduce(list(xs), "sum", axis="model")

    def pod_sum_many(self, xs):
        """Tensors summed over "pod" (no gradient): the adapters'
        gradients when the batch rows were split (``split_rows``)."""
        if self.pod == 1 or not xs:
            return list(xs)
        return self.shard.all_reduce(list(xs), "sum", axis="pod")

    def tp_max(self, x: torch.Tensor) -> torch.Tensor:
        """MAX over the "model" ranks, no gradient."""
        return self.shard.all_reduce([x.detach()], "max", axis="model")[0]

    def copy_to_tp(self, x):
        return x if self.tp == 1 else _CopyToTP.apply(x, self)

    def reduce_from_tp(self, x):
        return self.reduce_over(x, "model")

    def reduce_over(self, x, axis: str):
        """reduce_from_tp over `axis`: summed forward, the gradient as it
        is (the loss's sums over "pod", and over "model" where the head
        ran on the sequence block)."""
        return x if self.axis_size(axis) == 1 else _Reduce.apply(
            x, self, (axis,))

    def sum_tp(self, x):
        """The sum over the "model" ranks of per-rank parts whose
        consumers differ by rank (the gated norm's sum of squares over
        the rank's heads): summed forward, and the gradient summed
        backward too."""
        return self.reduce_from_tp(self.copy_to_tp(x))

    def fill(self, parts, axes):
        """Each (x, dim) of `parts`, this rank's block of `dim`, into the
        whole dim on every rank of `axes` (an axis name, or a tuple of
        names joined; the blocks rank-major), no gradient: one SUM of
        zero-filled buffers (exact) for all of them."""
        size, rank = self.axis_size(axes), self.axis_rank(axes)
        bufs = []
        for x, dim in parts:
            n = x.shape[dim]
            shape = list(x.shape)
            shape[dim] = n * size
            buf = x.detach().new_zeros(shape)
            buf.narrow(dim, rank * n, n).copy_(x.detach())
            bufs.append(buf)
        with torch.no_grad():
            return self.shard.all_reduce(bufs, "sum",
                                         axis=_axis_name(axes))

    def keep(self, x, dim: int, n: int, axes) -> torch.Tensor:
        """This rank's block of n entries of `dim` on `axes`."""
        return x.narrow(dim, self.axis_rank(axes) * n, n).contiguous()

    def tp_gather(self, x: torch.Tensor, dim: int):
        """The whole of a dim that "model" splits, on every rank (the
        router's logits, the SSM's in_proj and conv, the encoder's
        output under SP): each rank's consumers of the whole are the
        same, so the gradient keeps the rank's block."""
        return x if self.tp == 1 else _Gather.apply(x, self, dim,
                                                    ("model",), False)

    # -- the residual stream's sub-blocks -------------------------------
    def enter(self, y, split: bool):
        """A sub-block's input y (its norm's output).  Without SP:
        copy_to_tp when its consumers are "model" blocks (`split`: their
        gradients are this rank's part), else y.  Under SP: the sequence
        gathered, its gradient reduce-scattered when `split`, else kept
        (every rank then computes the whole sub-block alike)."""
        if self.sp:
            return _Gather.apply(y, self, -2, ("model",), split)
        return self.copy_to_tp(y) if split else y

    def leave(self, out, split: bool):
        """A sub-block's output.  Without SP: reduce_from_tp when it is a
        row-parallel partial sum (`split`), else out.  Under SP: the
        partial sums reduce-scattered over the sequence (`split`), or the
        rank's block of a whole that every rank computed."""
        if self.sp:
            return (_ReduceScatter if split else _Keep).apply(
                out, self, -2, ("model",))
        return self.reduce_from_tp(out) if split else out

    def seq_lo(self, seq_len: int) -> int:
        """The first position of this rank's sequence block (0 without
        SP)."""
        return self.tp_rank * (seq_len // self.tp) if self.sp else 0

    def seq_block(self, x, dim: int = -2):
        """The rank's sequence block of an input that every rank holds
        whole (frames, token ids, labels), or x without SP."""
        if not self.sp:
            return x
        n = x.shape[dim] // self.tp
        return x.narrow(dim, self.tp_rank * n, n)

    def whole_stream(self, x: torch.Tensor) -> torch.Tensor:
        """The stream's block ([N,] B, S, d) gathered into the whole
        message on every rank, no gradient: its rows over "pod", its
        sequence over "model", as they are split."""
        if self.rows:
            x = self.fill([(x, x.dim() - 3)], ("pod",))[0]
        if self.sp:
            x = self.fill([(x, x.dim() - 2)], ("model",))[0]
        return x.detach()

    def stream_block(self, x: torch.Tensor) -> torch.Tensor:
        if self.rows:
            x = self.keep(x, x.dim() - 3, x.shape[-3] // self.pod, ("pod",))
        if self.sp:
            x = self.keep(x, x.dim() - 2, x.shape[-2] // self.tp,
                          ("model",))
        return x

    def whole_message(self, fn, x, carry=None):
        """fn(whole, carry) -> (y, carry) on the whole message of every
        rank of a split stream (the cut: each compressor works on one
        whole message, as the reference's does), this rank's block of y
        kept; its gradient is fn's on the whole cotangent
        (``_WholeMessage``).  The carry (the error-feedback residual)
        is whole on every rank."""
        if not self.splits_stream:
            return fn(x, carry)
        if not (torch.is_grad_enabled() and x.requires_grad):
            y, carry = fn(self.whole_stream(x), carry)
            return self.stream_block(y), carry
        extra = {}
        y = _WholeMessage.apply(x, self, fn, carry, extra)
        return y, extra["carry"]

    # -- serving on the rank's cache blocks ------------------------------
    def batch_block(self, b: int) -> Tuple[Tuple[str, ...], int, int]:
        """(axes, lo, n): the FSDP axes that ``cache_specs`` splits a
        serving batch of b rows over (fit_spec's rule: ``fsdp_axes``) and
        this rank's rows [lo, lo + n) of it; ((), 0, b) when it stays
        whole."""
        axes = self.fsdp_axes(b)
        n = b // self.axis_size(axes)
        return axes, (self.axis_rank(axes) * n if axes else 0), n

    def gather_batch(self, x: torch.Tensor, axes, dim: int = 0):
        """Every rank's rows of `dim` (``batch_block``'s axes) into the
        whole batch on every rank, no gradient."""
        return x if not axes else self.fill([(x, dim)], axes)[0]

    def merge_decode(self, o: torch.Tensor, lse: torch.Tensor):
        """The whole KV cache's attention output from this rank's block's
        (o (B, H, hd), lse (B, H)) of a cache whose sequence is split over
        "model" (``decode_attention_partial``): every rank's pair
        gathered (exactly) and merged in rank order
        (``decode_attention.ref.merge_partials``), so every rank holds
        the same bits.  No gradient (serving)."""
        os_, lses = self.fill([(o[None], 0), (lse[None], 0)], ("model",))
        return decode_ref.merge_partials(list(os_.unbind(0)),
                                         list(lses.unbind(0)))

    # -- the MoE experts' rows over the FSDP axes (their ff dim split) ----
    def fsdp_axes(self, n: int) -> Tuple[str, ...]:
        """The FSDP axes that fit_spec keeps for a dim of n entries, in
        order, those of one rank left out (they split nothing)."""
        kept, prod = [], 1
        for a in FSDP_AXES:
            size = self._size(f"{a}_size")
            if n % (prod * size) == 0:
                prod *= size
                if size > 1:
                    kept.append(a)
        return tuple(kept)

    def data_gather_rows(self, x, n_ff: int):
        """The experts' dispatched rows (E_local, n, d) of every rank of
        the FSDP axes that split their ff dim of n_ff entries, (E_local,
        ranks n, d): each rank then runs its block of the experts' ff
        dim over all of them."""
        axes = self.fsdp_axes(n_ff)
        return x if not axes else _Gather.apply(x, self, 1, axes, True)

    def data_reduce_rows(self, x, n_ff: int):
        """The partial expert outputs of every rank's ff block summed over
        those axes, this rank's rows kept: the inverse move of
        data_gather_rows."""
        axes = self.fsdp_axes(n_ff)
        return x if not axes else _ReduceScatter.apply(x, self, 1, axes)

    def partial_targets(self, cfg, params: Params) -> frozenset:
        """The (group, target) pairs whose adapter gradient this rank
        computes only a part of, read from the rank's base leaves by the
        tests the blocks make (``block``): the attention's when wq holds
        a block of the heads (a column or row block, or the KV heads its
        query heads read), the cross-attention's ("xq", "xo") when xwq
        does, the MLP's when w_in holds one of the FFN width, the shared
        expert's (the same targets) when ws_in holds one of its width,
        and the SSM's when A_log holds a block of its heads
        (``ssm_apply``: in_proj's columns of those heads and B and C,
        which every head reads; out_proj's rows).  A target whose whole
        computation every rank repeats (a width that fit_spec leaves
        whole) has its full gradient on every rank."""
        parts = set()
        mlp = ("mlp_in", "mlp_gate", "mlp_out")
        heads = cfg.num_heads * cfg.head_dim
        for name, g in params.items():
            if not isinstance(g, dict):
                continue
            if "wq" in g and self.block(heads, g["wq"].shape[-1]) is not None:
                parts |= {(name, t) for t in ("q", "k", "v", "o")}
            if "xwq" in g and self.block(heads,
                                         g["xwq"].shape[-1]) is not None:
                parts |= {(name, "xq"), (name, "xo")}
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
        that FSDP split gathered over the axes fit_spec kept for it (one
        SUM of zero-filled buffers, exact); the MoE experts' leaves stay
        as they are.  The base weights are frozen: a leaf that requires
        grad raises."""
        axes = self.fsdp_axes(d_model)
        if not axes:
            return p
        size = self.axis_size(axes)
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
            if leaf.shape[dim] * size != d_model:
                raise ValueError(f"{name}: a block of {leaf.shape[dim]} is "
                                 f"not one of {size} {axes} blocks of "
                                 f"{d_model}")
        full = self.fill([(p[name], dim) for name, dim in todo], axes)
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
