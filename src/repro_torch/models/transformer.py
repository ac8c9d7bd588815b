"""Attention and MLP blocks as plain functions on tensors.

Port of src/repro/models/transformer.py.  Activations are (B, S, d) when
serving and (N, B, S, d) in SplitFT training, with the client axis N
first.  "train" and "prefill" run full sequences through the flash
attention kernel (differentiable: its backward is a kernel too), with the
client axis flattened into the batch; "decode" runs one token per slot
against a contiguous or paged KV cache through the flash-decode kernel.

Cross-attention (the whisper decoder, ``init_attention(cross=True)``)
follows the self-attention sub-block inside ``attention_apply``: its
queries come from the decoder, its keys and values from the encoder's
output (``memory``), non-causal over every encoder position.  A prefill
writes those keys and values into the cross cache; each decode step
reads them back through the flash-decode kernel at a cache length of
all of them.

The MoE block (``moe_apply``) routes each token to its top-k experts
with per-group capacity, as the reference does, and computes the experts
as batched products over the expert axis; its dispatch and combine move
rows by index instead of the reference's one-hot einsums (the same
function; see ``moe_apply``).

LoRA adapters (``lora_apply``): an "ids" leaf marks the serving pool (the
indexed LoRA kernel); rank-2 leaves are one shared adapter (the fused
LoRA kernel through ``common.lora_dense``); rank-3 leaves are per-client
training adapters, batched over the client axis with einsums, as in the
reference, where that branch is no kernel either.

KV caches are updated in place (the reference returns new arrays): a
decode tick writes one position per slot instead of copying the cache.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.lora_matmul import ops as lora_ops
from repro_torch.models import common
from repro_torch.models.common import (NO_SHARDING, ShardingPolicy,
                                       activate, apply_norm, is_glu)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# LoRA application


def lora_apply(x, w, adapter: Optional[Params], bias=None, *,
               block=None):
    """y = x @ W (+ s (x A) B) (+ bias).

    x: (N, ..., k) or (..., k).  Rank-3 adapter leaves carry a leading
    client axis matching x's axis 0; an "ids" leaf ((B,) int32) marks the
    serving pool layout instead (stacked (P, ...) adapters, each row of x
    picks its own).

    W may be a tensor-parallel block of the adapted projection: `block`
    is the target's (cols, rows) from ``adapter_blocks``, and the
    adapter is narrowed to it (``narrow_adapter``)."""
    adapter = narrow_adapter(adapter, block)
    if adapter is None:
        y = x @ w
    elif "ids" in adapter:
        y = lora_ops.lora_matmul_indexed(x, w, adapter["A"], adapter["B"],
                                         adapter["scale"], adapter["ids"])
    elif adapter["A"].dim() == 2:
        y = common.lora_dense(x, w, None, adapter)
    else:
        # per-client adapters: batch the low-rank path over axis 0
        a, b, scale = adapter["A"], adapter["B"], adapter["scale"]
        # bf16 activations against fp32 adapters (the dry-run's train
        # cells): the low-rank path runs in the adapters' dtype
        xa = torch.einsum("n...k,nkr->n...r", x.to(a.dtype), a)
        delta = torch.einsum("n...r,nrd->n...d", xa, b)
        extra = (1,) * (x.dim() - 1)          # broadcast over all but N
        y = x @ w + scale.reshape(scale.shape[:1] + extra).to(x.dtype) \
            * delta.to(x.dtype)
    if bias is not None:
        y = y + bias
    return y


def narrow_adapter(adapter: Optional[Params], block) -> Optional[Params]:
    """The adapter of a projection whose W is a "model" block: block =
    (cols, rows); cols narrows B's columns ((offset, count), or an index
    tensor), rows narrows A's rows ((offset, count)); None leaves it as
    it is."""
    if adapter is None or block is None:
        return adapter
    cols, rows = block
    adapter = dict(adapter)
    if isinstance(cols, torch.Tensor):
        adapter["B"] = adapter["B"].index_select(-1, cols)
    elif cols is not None:
        adapter["B"] = adapter["B"].narrow(-1, *cols)
    if rows is not None:
        adapter["A"] = adapter["A"].narrow(-2, *rows)
    return adapter


def adapter_blocks(cfg: ModelConfig, p: Params,
                   policy: ShardingPolicy = NO_SHARDING) -> Dict[str, Any]:
    """{LoRA target: (cols, rows)}: the block of its adapter that a
    layer whose base leaves `p` (one layer's, or a group's stacked)
    hold "model" blocks applies.  A column-parallel projection's B takes
    its W's columns (q, xq: wq's, xwq's; mlp_in and mlp_gate: w_in's, or
    the shared expert's ws_in's), a row-parallel one's A the same rows
    (o, xo, mlp_out); ``ssm.adapter_blocks`` adds the SSM layer's.
    Targets of whole projections are absent, and so is every target
    when the adapters hold their blocks already
    (``policy.adapters_at_blocks``: ``Model.serving_blocks``)."""
    if policy.tp == 1 or policy.adapters_at_blocks:
        return {}
    heads = cfg.num_heads * cfg.head_dim
    out: Dict[str, Any] = {}
    for leaf, full, cols, rows in (
            ("wq", heads, ("q",), "o"), ("xwq", heads, ("xq",), "xo"),
            ("w_in", cfg.d_ff, ("mlp_in", "mlp_gate"), "mlp_out"),
            ("ws_in", cfg.moe_d_ff * cfg.num_shared_experts,
             ("mlp_in", "mlp_gate"), "mlp_out")):
        if leaf not in p:
            continue
        n = p[leaf].shape[-1]
        lo = policy.block(full, n)
        if lo is not None:
            out.update({t: ((lo, n), None) for t in cols})
            out[rows] = (None, (lo, n))
    return out


def _ad(adapters: Optional[Params], name: str) -> Optional[Params]:
    if adapters is None:
        return None
    return adapters.get(name)


# ---------------------------------------------------------------------------
# Attention block
#
# params: norm1{scale[,bias]}, wq (d, H*hd), wk/wv (d, KVH*hd), wo (H*hd, d)
#         [bq/bk/bv/bo biases], and for cross-attention: xnorm, xwq, xwk,
#         xwv, xwo (no biases)


def init_attention(gen: torch.Generator, cfg: ModelConfig, n_layers: int, *,
                   cross: bool, dtype, place=common.whole) -> Params:
    """place(name, leaf): the part of each leaf to keep, called as soon as
    the leaf is drawn (``Model.init_params``)."""
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = (n_layers,)

    def norm():
        return common.init_norm(d, bias=cfg.norm == "layernorm",
                                dtype=dtype, lead=lead, place=place)

    def dense(prefix):
        for name, d_in, d_out in (("wq", d, h * hd), ("wk", d, kvh * hd),
                                  ("wv", d, kvh * hd), ("wo", h * hd, d)):
            p[prefix + name] = place(prefix + name, common.dense_init(
                gen, d_in, d_out, dtype, lead=lead))

    p: Params = {"norm1": norm()}
    dense("")
    if cfg.qkv_bias:
        for name, n in (("bq", h * hd), ("bk", kvh * hd), ("bv", kvh * hd),
                        ("bo", d)):
            p[name] = place(name, torch.zeros((n_layers, n), dtype=dtype))
    if cross:
        p["xnorm"] = norm()
        dense("x")
    return p


def _split_heads(t, n_heads, hd):
    return t.reshape(t.shape[:-1] + (n_heads, hd))


def _merge_heads(t):
    return t.reshape(t.shape[:-2] + (t.shape[-2] * t.shape[-1],))


def attention_apply(p: Params, adapters: Optional[Params], x, *,
                    cfg: ModelConfig, mode: str, causal: bool, window: int,
                    rope: Optional[Tuple[Any, Any]] = None,
                    cache: Optional[Params] = None, memory=None,
                    mem_cache: Optional[Params] = None,
                    policy: ShardingPolicy = NO_SHARDING):
    """One attention sub-block (pre-norm, residual added by the caller).

    x: ([N,] B, S, d).  Returns (attn_out, new_cache).  rope: (cos, sin)
    of the tokens' positions (``common.rope_angles``) or None; q and k are
    rotated before any cache write, so the cache holds rotated keys.
    cache: {"k": ([N,] B, Smax, KVH, hd), "v": ..., "len": (B,)} for
    contiguous decode ("len" shared over the clients N, as in the
    reference; the kernels take the N x B rows), or the paged form {"k":
    (n_pages, ps, KVH, hd), "v": ..., "pages": (B, P_max), "len": (B,)};
    its k/v tensors are written in place.

    memory ([N,] B, S_enc, d), the encoder's output, or mem_cache {"k":
    ([N,] B, S_enc, KVH, hd), "v": ..., "len": (B,) of S_enc in decode},
    the cross cache, adds the cross-attention sub-block
    (``_cross_attention``) to the output: a prefill (memory and
    mem_cache) writes the cross cache in place, a decode step (mem_cache
    alone) reads it.

    policy: when wq holds a "model" block of the heads (a MeshShard's),
    the sub-block runs on that block (Megatron's layout): wq (and bq)
    hold the block's columns and wo its rows; wk and wv stay whole by
    param_specs, so the rank computes the full K and V and keeps the KV
    heads its query heads read (``_kv_heads``).  The
    input enters through ``policy.enter`` (copy_to_tp: its gradient
    summed over "model"; under sequence parallelism x is the rank's
    sequence block, normed there and gathered), the output projection's
    partial sums leave through ``policy.leave`` (reduce_from_tp, or the
    reduce-scatter back to the block), and bo is added once, after the
    sum.  The cross-attention sub-block runs on the same heads
    (``_cross_attention``), its cross cache placed as the KV cache.

    Serving on a MeshShard's cache blocks (``runtime.sharding.
    local_cache``): the cache holds the rank's rows of the batch and,
    where "model" divides the capacity, its block of the sequence, whose
    first global position is cache["seq_lo"].  A prefill writes the
    positions of the whole prompt that fall in the block (by global
    position: under SP the stream's block is another split, and K and V
    are computed over the gathered sequence); a decode step's K and V,
    computed on every rank, are written by the rank whose block holds
    position len.  The step then gathers q's heads over "model" (B x H x
    hd), runs ``decode_attention_partial`` over the block for all H
    heads, merges every rank's (o, lse) (``policy.merge_decode``) and
    keeps its own heads for wo's row block (``_decode_read``).  A
    capacity that "model" does not divide leaves the cache whole on
    every rank: the whole-cache kernel then runs over all heads, as the
    reference's fit_spec rule gives.  A paged cache stays whole (the
    engine takes no mesh)."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lo = policy.block(h * hd, p["wq"].shape[-1])
    hl = p["wq"].shape[-1] // hd
    if lo is not None and cache is not None and "pages" in cache:
        raise ValueError("a paged cache stays whole: the serving engine "
                         "takes no mesh")

    y = policy.enter(apply_norm(p["norm1"], x, kind=cfg.norm,
                                eps=cfg.norm_eps), lo is not None)
    s = y.shape[-2]
    blocks = adapter_blocks(cfg, p, policy)
    q = _split_heads(lora_apply(y, p["wq"], _ad(adapters, "q"), p.get("bq"),
                                block=blocks.get("q")), hl, hd)
    k = _split_heads(lora_apply(y, p["wk"], _ad(adapters, "k"), p.get("bk")),
                     kvh, hd)
    v = _split_heads(lora_apply(y, p["wv"], _ad(adapters, "v"), p.get("bv")),
                     kvh, hd)
    if rope is not None:
        cos, sin = rope
        q = common.apply_rope(q, cos, sin)
        k = common.apply_rope(k, cos, sin)
    seq_lo = cache.get("seq_lo") if cache is not None else None

    new_cache = cache
    if mode == "decode" and cache is not None and "pages" in cache:
        # paged cache: pools addressed through the per-slot page table.
        # Idle slots (len 0, table all trash) all write trash page 0,
        # offset 0; the duplicates are harmless because that page is
        # never read unmasked.
        if s != 1 or x.dim() != 3:
            raise ValueError("paged decode takes one token per slot")
        idx = cache["len"]                                     # (B,)
        pages = cache["pages"]                                 # (B, Pm)
        n_pg, ps = cache["k"].shape[0], cache["k"].shape[1]
        trow = torch.clamp(idx // ps, 0, pages.shape[-1] - 1).long()
        pg = torch.gather(pages, 1, trow[:, None])[:, 0]
        pg = torch.clamp(pg, 0, n_pg - 1).long()
        off = (idx % ps).long()
        cache["k"][pg, off] = k[:, 0].to(cache["k"].dtype)
        cache["v"][pg, off] = v[:, 0].to(cache["v"].dtype)
        o = decode_ops.decode_attention_paged(q[:, 0].contiguous(),
                                              cache["k"], cache["v"], pages,
                                              idx + 1, window=window)
        o = o[:, None]                                         # (B,1,H,hd)
        new_cache = {"k": cache["k"], "v": cache["v"], "pages": pages,
                     "len": idx + 1}
    elif mode == "decode":
        if cache is None or s != 1:
            raise ValueError("decode takes one token per slot and a cache")
        idx = cache["len"]                                     # (B,)
        # the position's slot in this rank's block (off it: no write)
        at = idx if seq_lo is None else idx - seq_lo
        _write_cache(cache["k"], k[..., 0, :, :], at)
        _write_cache(cache["v"], v[..., 0, :, :], at)
        o = _decode_read(q[..., 0, :, :], cache["k"], cache["v"], idx + 1,
                         seq_lo, window=window, policy=policy, lo=lo)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": idx + 1}
    else:
        lead = y.shape[:-2]           # ([N,] B): flatten clients into B
        kf, vf = k, v
        if lo is not None:
            kv = _kv_heads(h, kvh, lo // hd, hl)
            if isinstance(kv, tuple):
                kf, vf = (t.narrow(-2, *kv) for t in (k, v))
            else:
                kf, vf = (t.index_select(-2, kv.to(t.device))
                          for t in (k, v))
        o = flash_ops.flash_attention(
            q.reshape((-1,) + q.shape[-3:]),
            kf.reshape((-1,) + kf.shape[-3:]).contiguous(),
            vf.reshape((-1,) + vf.shape[-3:]).contiguous(), causal=causal,
            window=window)
        o = o.reshape(lead + o.shape[1:])
        if cache is not None:   # prefill: populate the cache
            _bulk_write(cache["k"], k, seq_lo)
            _bulk_write(cache["v"], v, seq_lo)
            new_cache = {"k": cache["k"], "v": cache["v"],
                         "len": cache["len"] + k.shape[-3]}

    out = policy.leave(lora_apply(_merge_heads(o), p["wo"], _ad(adapters, "o"),
                                  block=blocks.get("o")), lo is not None)
    if "bo" in p:
        out = out + p["bo"]
    if memory is not None or mem_cache is not None:
        out = out + _cross_attention(p, adapters, x + out, cfg=cfg,
                                     mode=mode, memory=memory,
                                     mem_cache=mem_cache, policy=policy)
    return out, new_cache


def _kv_heads(h: int, kvh: int, first_q: int, n: int):
    """The KV heads that query heads [first_q, first_q + n) read under GQA
    (head j reads KV head j // (h / kvh)): (first, count) when each of
    them serves the same number of the block's query heads, the flash
    kernels' GQA layout; else a (n,) index of one KV head per query
    head."""
    group = h // kvh
    want = torch.arange(first_q, first_q + n) // group
    first, count = int(want[0]), int(want[-1]) - int(want[0]) + 1
    if n % count == 0 and torch.equal(
            want, torch.arange(first, first + count).repeat_interleave(
                n // count)):
        return (first, count)
    return want


def _decode_read(q1, k, v, lens, seq_lo: Optional[int], *, window: int,
                 policy: ShardingPolicy, lo: Optional[int]):
    """A decode step's read of a cache, self or cross: q1 ([N,] B, h, hd)
    of one query per row over k and v ([N,] B, S, KVH, hd), the first
    lens[b] positions valid (lens (B,), shared over N); returns ([N,] B,
    1, h, hd).  The kernels take the N x B rows flattened.

    Under a MeshShard's policy (lo: the first of this rank's h query
    heads, None when the heads are whole) q's heads are gathered over
    "model" first; a cache block whose first global position is seq_lo
    runs ``decode_attention_partial`` and every rank's (o, lse) are
    merged (``policy.merge_decode``), a whole cache (seq_lo None) the
    whole-cache kernel; the rank then keeps its own heads, as the row
    block of the output projection takes them."""
    lead, hl = q1.shape[:-2], q1.shape[-2]
    if lo is not None:   # every head, over this rank's block
        q1 = policy.fill([(q1, -2)], ("model",))[0]

    def rows(t):
        return t.reshape((-1,) + t.shape[len(lead):])

    qf, kf, vf = rows(q1).contiguous(), rows(k), rows(v)
    lf = torch.broadcast_to(lens, lead).reshape(-1).contiguous()
    if seq_lo is None:
        o = decode_ops.decode_attention(qf, kf, vf, lf, window=window)
    else:
        o, lse = decode_ops.decode_attention_partial(qf, kf, vf, lf, seq_lo,
                                                     window=window)
        o = policy.merge_decode(o, lse).to(q1.dtype)
    o = o.reshape(lead + o.shape[1:])
    if lo is not None:   # the row block's input, as the kernel takes it
        o = o.narrow(-2, lo // q1.shape[-1], hl).contiguous()
    return o[..., None, :, :]


def _cross_attention(p: Params, adapters: Optional[Params], x, *,
                     cfg: ModelConfig, mode: str, memory, mem_cache,
                     policy: ShardingPolicy = NO_SHARDING):
    """The cross-attention sub-block of a decoder layer over x = the
    layer's input plus its self-attention output: q from xnorm(x), k and
    v from the encoder output (train and prefill: the flash kernel,
    non-causal over S_enc keys; a prefill also copies k and v into the
    cross cache) or from the cross cache (decode: the flash-decode
    kernel at a cache length of S_enc for every slot, the same function
    for one query).  The cross projections take an adapter only where
    "xq"/"xo" are LoRA targets, as in the reference.

    policy: when xwq holds a "model" block of the heads, the sub-block
    runs on those heads as the self-attention does: xwq column-parallel,
    xwk and xwv whole (param_specs) with the rank's KV heads kept, xwo
    row-parallel; the xnorm output enters and the partial sums leave
    through the policy.  `memory` is then the whole encoder output on
    every rank, entered through copy_to_tp once for every layer
    (``Model.forward``).  Serving on a MeshShard's cache blocks: the
    cross cache's S_enc positions split over "model" where it divides
    them (``local_cache``; mem_cache["seq_lo"] the block's first), a
    prefill computes K and V over every position (xwk and xwv are whole)
    and writes the block's, and a decode step reads the block through
    ``_decode_read`` (q's heads gathered, the partial kernel, the
    ranks' (o, lse) merged, the rank's heads kept), as the self cache's;
    a cross cache that "model" does not divide stays whole on every rank
    and takes the whole-cache kernel."""
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lo = policy.block(h * hd, p["xwq"].shape[-1])
    hl = p["xwq"].shape[-1] // hd
    y = policy.enter(apply_norm(p["xnorm"], x, kind=cfg.norm,
                                eps=cfg.norm_eps), lo is not None)
    blocks = adapter_blocks(cfg, p, policy)
    q = _split_heads(lora_apply(y, p["xwq"], _ad(adapters, "xq"),
                                block=blocks.get("xq")), hl, hd)
    if mode == "decode":
        if mem_cache is None or memory is not None or q.shape[-3] != 1:
            raise ValueError("cross-attention decode takes one token per "
                             "slot and the cross cache")
        o = _decode_read(q[..., 0, :, :], mem_cache["k"], mem_cache["v"],
                         mem_cache["len"], mem_cache.get("seq_lo"), window=0,
                         policy=policy, lo=lo)
    else:
        mk = _split_heads(lora_apply(memory, p["xwk"], _ad(adapters, "xk")),
                          kvh, hd)
        mv = _split_heads(lora_apply(memory, p["xwv"], _ad(adapters, "xv")),
                          kvh, hd)
        if mem_cache is not None:   # prefill: populate the cross cache
            _bulk_write(mem_cache["k"], mk, mem_cache.get("seq_lo"))
            _bulk_write(mem_cache["v"], mv, mem_cache.get("seq_lo"))
        if lo is not None:
            kv = _kv_heads(h, kvh, lo // hd, hl)
            if isinstance(kv, tuple):
                mk, mv = (t.narrow(-2, *kv) for t in (mk, mv))
            else:
                mk, mv = (t.index_select(-2, kv.to(t.device))
                          for t in (mk, mv))
        lead = y.shape[:-2]
        o = flash_ops.flash_attention(
            q.reshape((-1,) + q.shape[-3:]),
            mk.reshape((-1,) + mk.shape[-3:]).contiguous(),
            mv.reshape((-1,) + mv.shape[-3:]).contiguous(), causal=False)
        o = o.reshape(lead + o.shape[1:])
    return policy.leave(lora_apply(_merge_heads(o), p["xwo"],
                                   _ad(adapters, "xo"),
                                   block=blocks.get("xo")),
                        lo is not None)


def _write_cache(cache, kv_new, idx):
    """In place: cache ([N,] B, Smax, KVH, hd)[..., b, idx[b]] =
    kv_new[..., b] (idx (B,), shared over N).  A slot at idx >= Smax
    writes nothing, as in the reference, and so does one at idx < 0 (a
    position before a rank's block of a split cache)."""
    smax = cache.shape[-3]
    rows = torch.arange(cache.shape[-4], device=cache.device)
    pos = torch.clamp(idx, 0, smax - 1).long()
    keep = ((idx >= 0) & (idx < smax))[:, None, None]
    cache[..., rows, pos, :, :] = torch.where(
        keep, kv_new.to(cache.dtype), cache[..., rows, pos, :, :])


def _bulk_write(cache, kv, seq_lo: Optional[int] = None):
    """Prefill write, in place: kv ([N,] B, S, KVH, hd) into the first S
    slots of cache ([N,] B, Smax, KVH, hd); or, for a rank's block of a
    split cache whose first global position is seq_lo, the positions of
    kv that fall in the block."""
    if seq_lo is None:
        cache[..., :kv.shape[-3], :, :] = kv.to(cache.dtype)
        return
    n = min(kv.shape[-3] - seq_lo, cache.shape[-3])
    if n > 0:
        cache[..., :n, :, :] = kv[..., seq_lo:seq_lo + n, :, :].to(
            cache.dtype)


# ---------------------------------------------------------------------------
# Dense MLP block


def init_mlp(gen: torch.Generator, cfg: ModelConfig, n_layers: int, *, dtype,
             d_ff: Optional[int] = None, place=common.whole) -> Params:
    """place: as in ``init_attention``."""
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    lead = (n_layers,)
    p: Params = {"norm2": common.init_norm(
        d, bias=cfg.norm == "layernorm", dtype=dtype, lead=lead, place=place)}
    shapes = [("w_in", d, ff), ("w_out", ff, d)]
    if is_glu(cfg.activation):
        shapes.append(("w_gate", d, ff))
    for name, d_in, d_out in shapes:
        p[name] = place(name, common.dense_init(gen, d_in, d_out, dtype,
                                                lead=lead))
    if cfg.mlp_bias:
        p["b_in"] = place("b_in", torch.zeros((n_layers, ff), dtype=dtype))
        p["b_out"] = place("b_out", torch.zeros((n_layers, d), dtype=dtype))
    return p


def mlp_apply(p: Params, adapters: Optional[Params], x, *, cfg: ModelConfig,
              policy: ShardingPolicy = NO_SHARDING):
    """The MLP sub-block (pre-norm, residual added by the caller).  When
    w_in holds a "model" block of the FFN width, it runs tensor-parallel:
    w_in, w_gate and b_in hold the block's columns and w_out its rows,
    the input enters through ``policy.enter`` (copy_to_tp, or the
    sequence gathered under SP), the partial sums leave through
    ``policy.leave``, and b_out is added once, after the sum."""
    ff = p["w_in"].shape[-1]
    lo = policy.block(cfg.d_ff, ff)
    y = policy.enter(apply_norm(p["norm2"], x, kind=cfg.norm,
                                eps=cfg.norm_eps), lo is not None)
    blocks = adapter_blocks(cfg, p, policy)
    hin = lora_apply(y, p["w_in"], _ad(adapters, "mlp_in"), p.get("b_in"),
                     block=blocks.get("mlp_in"))
    gate = None
    if "w_gate" in p:
        gate = lora_apply(y, p["w_gate"], _ad(adapters, "mlp_gate"),
                          block=blocks.get("mlp_gate"))
    hmid = activate(hin, gate, cfg.activation)
    out = policy.leave(lora_apply(hmid, p["w_out"], _ad(adapters, "mlp_out"),
                                  block=blocks.get("mlp_out")),
                       lo is not None)
    if "b_out" in p:
        out = out + p["b_out"]
    return out


# ---------------------------------------------------------------------------
# MoE block (token-choice top-k routing with per-group capacity)
#
# params: norm2{scale}, router (d, E), we_in/we_gate (E, d, ff), we_out
#         (E, ff, d); the shared expert ws_in/ws_gate (d, sf), ws_out (sf, d)


def init_moe(gen: torch.Generator, cfg: ModelConfig, n_layers: int, *,
             dtype, place=common.whole) -> Params:
    """place: as in ``init_attention`` (each expert stack is drawn whole
    and narrowed, so the draw is the unsharded one)."""
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    lead = (n_layers,)
    p: Params = {
        "norm2": common.init_norm(d, bias=False, dtype=dtype, lead=lead,
                                  place=place)}
    shapes = [("router", d, e, lead), ("we_in", d, ff, lead + (e,)),
              ("we_out", ff, d, lead + (e,))]
    if is_glu(cfg.activation):
        shapes.append(("we_gate", d, ff, lead + (e,)))
    if cfg.num_shared_experts:
        sf = ff * cfg.num_shared_experts
        shapes += [("ws_in", d, sf, lead), ("ws_out", sf, d, lead)]
        if is_glu(cfg.activation):
            shapes.append(("ws_gate", d, sf, lead))
    for name, d_in, d_out, lead_ in shapes:
        p[name] = place(name, common.dense_init(gen, d_in, d_out, dtype,
                                                lead=lead_))
    return p


MOE_GROUP_TOKENS = 4096    # the reference's routing-group size


def moe_capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per expert in a routing group of s tokens, in Python float
    arithmetic as the reference computes it; a decode token (s = 1) gets
    k, so it is never dropped."""
    k, e = cfg.moe_top_k, cfg.num_experts
    cap = max(int(k * s * cfg.moe_capacity_factor / e), 4 if s > 1 else k)
    return min(cap, s * k)


def moe_route(cfg: ModelConfig, yg, router,
              policy: ShardingPolicy = NO_SHARDING):
    """Routing of groups yg (G, T, d): the router's fp32 probabilities
    (G, T, E), their top-k choices, and moe_queue's values, queue
    positions and cap for those choices.  When `router` holds a "model"
    block of the experts, each rank computes that block of the logits
    and gathers the whole (exactly), so every rank routes alike."""
    logits = yg @ router.to(yg.dtype)
    if policy.block(cfg.num_experts, router.shape[-1]) is not None:
        logits = policy.tp_gather(logits, -1)
    probs = torch.softmax(logits.float(), dim=-1)
    _, topi = torch.topk(probs, cfg.moe_top_k, dim=-1)
    return moe_queue(cfg, probs, topi)


def moe_queue(cfg: ModelConfig, probs, topi):
    """(probs, the top-k values at the choices topi (G, T, k)
    renormalised, topi, queue positions (G, T, k), cap).  A (token,
    choice) pair's position counts the earlier pairs of its expert in
    token-major, choice-minor order; a pair at a position >= cap is
    dropped."""
    e = cfg.num_experts
    g, s, k = topi.shape
    topv = probs.gather(-1, topi)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    flat = F.one_hot(topi, e).reshape(g, s * k, e)            # int64
    pos = ((torch.cumsum(flat, 1) - flat) * flat).sum(-1).reshape(g, s, k)
    return probs, topv, topi, pos, moe_capacity(cfg, s)


def moe_apply(p: Params, adapters: Optional[Params], x, *, cfg: ModelConfig,
              policy: ShardingPolicy = NO_SHARDING):
    """The MoE sub-block (pre-norm, residual added by the caller).

    x: ([N,] B, S, d).  Returns (out like x, aux).  Tokens regroup as
    (-1, S, d), so every sequence (of every client) is a routing group;
    a sequence longer than MOE_GROUP_TOKENS that it divides is cut into
    groups of that size.  The reference dispatches and combines with
    one-hot einsums over (G, T, E, C); here the kept pairs' rows are
    copied into an (E, G, min(C, T), d) buffer by index (exactly), the
    experts run as batched products over E, and each token sums its k
    weighted expert rows gathered back by index (the same sum in another
    order).
    A dropped pair weighs 0.  aux = router_aux_loss * E * mean over
    groups of sum_e(me * pe): me, the share of (token, choice) pairs
    routed to e before any drop (no gradient), pe the mean router
    probability (with gradient).

    policy: under a MeshShard the experts are split over "model" (EP:
    this rank's contiguous block of E / tp of them, and the router's
    block of the logits, gathered whole) and their ff dim over "data".
    Every rank routes alike from the whole logits (the same top-k, queue
    positions, drops and aux as unsharded), fills its experts' buffer
    with the kept pairs routed to them and runs them; over "data" the
    rows move, not the weights: each rank runs its ff block over the
    dispatched rows of every "data" rank (``data_gather_rows``) and
    keeps its own rows of the sum (``data_reduce_rows``).  The routed
    partial output and the shared expert's row-parallel one (ws_in and
    ws_gate column blocks, ws_out rows, as ``mlp_apply``) leave through
    one reduce_from_tp.  Each rank's combine weights' gradient covers
    its own experts' pairs, so the weights enter through copy_to_tp: the
    router's whole logits then get the whole gradient on every rank.
    Under sequence parallelism x is the rank's sequence block: the
    normed input is gathered over the sequence first (``policy.enter``),
    so the routing groups, the capacity, the top-k, the queue positions,
    the drops and the router loss are those of the whole sequences, and
    the output leaves as the rank's block (``policy.leave``)."""
    e, k, d = cfg.num_experts, cfg.moe_top_k, cfg.d_model
    y = apply_norm(p["norm2"], x, kind=cfg.norm, eps=cfg.norm_eps)
    e_loc = p["we_in"].shape[-3]
    e_lo = policy.block(e, e_loc)
    sf = cfg.moe_d_ff * cfg.num_shared_experts
    s_lo = (policy.block(sf, p["ws_in"].shape[-1])
            if cfg.num_shared_experts else None)
    # the input's consumers that hold a "model" block (their gradients
    # are this rank's part), and those that every rank runs whole
    y_tp = (policy.enter(y, True) if e_lo is not None or s_lo is not None
            else None)
    y_all = (policy.enter(y, False) if e_lo is None or (
        cfg.num_shared_experts and s_lo is None) else None)
    y_ep = y_tp if e_lo is not None else y_all
    s = y_ep.shape[-2]
    yg = y_ep.reshape(-1, s, d)                               # (G, T, d)
    if s > MOE_GROUP_TOKENS and s % MOE_GROUP_TOKENS == 0:
        yg = yg.reshape(-1, MOE_GROUP_TOKENS, d)
    g, s = yg.shape[0], yg.shape[1]
    probs, topv, topi, pos, cap = moe_route(cfg, yg, p["router"],
                                            policy=policy)
    keep = pos < cap
    wgt = topv * keep                                         # (G, T, k)
    if e_lo is not None:
        keep = keep & (topi >= e_lo) & (topi < e_lo + e_loc)
        wgt = policy.copy_to_tp(wgt) * keep
        topi = topi - e_lo

    # slot of each kept pair in the (E, G, C) buffer; dropped pairs all
    # write the spare row past the end, which is cut off.  A token picks
    # an expert once, so an expert's queue in a group holds at most s
    # pairs: C = min(cap, s) slots lose nothing (a decode tick's groups
    # of one token take 1 slot an expert, not the cap of k)
    c = min(cap, s)
    grp = torch.arange(g, device=x.device)[:, None, None]
    slot = torch.where(keep, (topi * g + grp) * c + pos, e_loc * g * c)
    rows = yg[:, :, None, :].expand(g, s, k, d).reshape(-1, d)
    buf = yg.new_zeros((e_loc * g * c + 1, d)).index_put(
        (slot.reshape(-1),), rows)
    xe = buf[:-1].reshape(e_loc, g * c, d)
    # the experts' ff dim split over "data" (fit_spec may leave it whole)
    ff_split = p["we_in"].shape[-1] != cfg.moe_d_ff
    if ff_split:
        xe = policy.data_gather_rows(xe, cfg.moe_d_ff)
    hin = torch.bmm(xe, p["we_in"])
    gate = torch.bmm(xe, p["we_gate"]) if "we_gate" in p else None
    ye = torch.bmm(activate(hin, gate, cfg.activation), p["we_out"])
    if ff_split:
        ye = policy.data_reduce_rows(ye, cfg.moe_d_ff)
    # a dropped pair gathers row 0 at weight 0
    got = ye.reshape(-1, d).index_select(
        0, torch.where(keep, slot, 0).reshape(-1)).reshape(g, s, k, d)
    out = (got * wgt.to(got.dtype)[..., None]).sum(2)

    aux = 0.0
    if cfg.router_aux_loss:
        me = F.one_hot(topi if e_lo is None else topi + e_lo,
                       e).sum(2).float().mean(1)              # (G, E)
        pe = probs.mean(1)
        aux = cfg.router_aux_loss * e * torch.mean(torch.sum(me * pe, -1))

    # the parts that hold a "model" block are summed over the ranks
    # together; a whole part is added once, after the sum
    out = out.reshape(y_ep.shape)
    blocked, whole = (out, None) if e_lo is not None else (None, out)
    if cfg.num_shared_experts:
        y_s = y_tp if s_lo is not None else y_all
        blocks = adapter_blocks(cfg, p, policy)
        hin_s = lora_apply(y_s, p["ws_in"], _ad(adapters, "mlp_in"),
                           block=blocks.get("mlp_in"))
        gate_s = None
        if "ws_gate" in p:
            gate_s = lora_apply(y_s, p["ws_gate"], _ad(adapters, "mlp_gate"),
                                block=blocks.get("mlp_gate"))
        shared = lora_apply(activate(hin_s, gate_s, cfg.activation),
                            p["ws_out"], _ad(adapters, "mlp_out"),
                            block=blocks.get("mlp_out"))
        if s_lo is None:
            whole = shared if whole is None else whole + shared
        else:
            blocked = shared if blocked is None else blocked + shared
    if blocked is None:
        return policy.leave(whole, False), aux
    summed = policy.leave(blocked, True)
    return (summed if whole is None
            else summed + policy.leave(whole, False)), aux
