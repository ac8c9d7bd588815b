"""Attention and MLP blocks as plain functions on tensors.

Port of src/repro/models/transformer.py.  Activations are (B, S, d) when
serving and (N, B, S, d) in SplitFT training, with the client axis N
first.  "train" and "prefill" run full sequences through the flash
attention kernel (differentiable: its backward is a kernel too), with the
client axis flattened into the batch; "decode" runs one token per slot
against a contiguous or paged KV cache through the flash-decode kernel.

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

from repro_torch import roadmap
from repro_torch.config import ModelConfig
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.lora_matmul import ops as lora_ops
from repro_torch.models import common
from repro_torch.models.common import activate, apply_norm, is_glu

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# LoRA application


def lora_apply(x, w, adapter: Optional[Params], bias=None):
    """y = x @ W (+ s (x A) B) (+ bias).

    x: (N, ..., k) or (..., k).  Rank-3 adapter leaves carry a leading
    client axis matching x's axis 0; an "ids" leaf ((B,) int32) marks the
    serving pool layout instead (stacked (P, ...) adapters, each row of x
    picks its own)."""
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
        xa = torch.einsum("n...k,nkr->n...r", x, a)
        delta = torch.einsum("n...r,nrd->n...d", xa, b)
        extra = (1,) * (x.dim() - 1)          # broadcast over all but N
        y = x @ w + scale.reshape(scale.shape[:1] + extra).to(x.dtype) \
            * delta.to(x.dtype)
    if bias is not None:
        y = y + bias
    return y


def _ad(adapters: Optional[Params], name: str) -> Optional[Params]:
    if adapters is None:
        return None
    return adapters.get(name)


# ---------------------------------------------------------------------------
# Attention block
#
# params: norm1{scale[,bias]}, wq (d, H*hd), wk/wv (d, KVH*hd), wo (H*hd, d)
#         [bq/bk/bv/bo biases]


def init_attention(gen: torch.Generator, cfg: ModelConfig, n_layers: int, *,
                   cross: bool, dtype) -> Params:
    if cross:
        raise NotImplementedError(
            "cross-attention (whisper) is not ported yet "
            f"({roadmap.FAMILIES})")
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lead = (n_layers,)
    p: Params = {
        "norm1": common.init_norm(d, bias=cfg.norm == "layernorm",
                                  dtype=dtype, lead=lead),
        "wq": common.dense_init(gen, d, h * hd, dtype, lead=lead),
        "wk": common.dense_init(gen, d, kvh * hd, dtype, lead=lead),
        "wv": common.dense_init(gen, d, kvh * hd, dtype, lead=lead),
        "wo": common.dense_init(gen, h * hd, d, dtype, lead=lead),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((n_layers, h * hd), dtype=dtype)
        p["bk"] = torch.zeros((n_layers, kvh * hd), dtype=dtype)
        p["bv"] = torch.zeros((n_layers, kvh * hd), dtype=dtype)
        p["bo"] = torch.zeros((n_layers, d), dtype=dtype)
    return p


def _split_heads(t, n_heads, hd):
    return t.reshape(t.shape[:-1] + (n_heads, hd))


def _merge_heads(t):
    return t.reshape(t.shape[:-2] + (t.shape[-2] * t.shape[-1],))


def attention_apply(p: Params, adapters: Optional[Params], x, *,
                    cfg: ModelConfig, mode: str, causal: bool, window: int,
                    rope: Optional[Tuple[Any, Any]] = None,
                    cache: Optional[Params] = None, memory=None,
                    mem_cache: Optional[Params] = None):
    """One attention sub-block (pre-norm, residual added by the caller).

    x: ([N,] B, S, d).  Returns (attn_out, new_cache).  rope: (cos, sin)
    of the tokens' positions (``common.rope_angles``) or None; q and k are
    rotated before any cache write, so the cache holds rotated keys.
    cache: {"k": (B, Smax, KVH, hd), "v": ..., "len": (B,)} for contiguous
    decode, or the paged form {"k": (n_pages, ps, KVH, hd), "v": ...,
    "pages": (B, P_max), "len": (B,)}; its k/v tensors are written in
    place."""
    if memory is not None or mem_cache is not None:
        raise NotImplementedError(
            "cross-attention (whisper) is not ported yet "
            f"({roadmap.FAMILIES})")
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = x.shape[-2]

    y = apply_norm(p["norm1"], x, kind=cfg.norm, eps=cfg.norm_eps)
    q = _split_heads(lora_apply(y, p["wq"], _ad(adapters, "q"), p.get("bq")),
                     h, hd)
    k = _split_heads(lora_apply(y, p["wk"], _ad(adapters, "k"), p.get("bk")),
                     kvh, hd)
    v = _split_heads(lora_apply(y, p["wv"], _ad(adapters, "v"), p.get("bv")),
                     kvh, hd)
    if rope is not None:
        cos, sin = rope
        q = common.apply_rope(q, cos, sin)
        k = common.apply_rope(k, cos, sin)

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
        _write_cache(cache["k"], k[:, 0], idx)
        _write_cache(cache["v"], v[:, 0], idx)
        o = decode_ops.decode_attention(q[:, 0].contiguous(), cache["k"],
                                        cache["v"], idx + 1, window=window)
        o = o[:, None]
        new_cache = {"k": cache["k"], "v": cache["v"], "len": idx + 1}
    else:
        lead = x.shape[:-2]           # ([N,] B): flatten clients into B
        o = flash_ops.flash_attention(
            q.reshape((-1,) + q.shape[-3:]), k.reshape((-1,) + k.shape[-3:]),
            v.reshape((-1,) + v.shape[-3:]), causal=causal, window=window)
        o = o.reshape(lead + o.shape[1:])
        if cache is not None:   # prefill: populate the cache
            _bulk_write(cache["k"], k)
            _bulk_write(cache["v"], v)
            new_cache = {"k": cache["k"], "v": cache["v"],
                         "len": cache["len"] + k.shape[-3]}

    out = lora_apply(_merge_heads(o), p["wo"], _ad(adapters, "o"),
                     p.get("bo"))
    return out, new_cache


def _write_cache(cache, kv_new, idx):
    """In place: cache (B, Smax, KVH, hd) [b, idx[b]] = kv_new[b].  A slot
    at idx >= Smax writes nothing, as in the reference."""
    smax = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    pos = torch.clamp(idx, 0, smax - 1).long()
    keep = (idx < smax)[:, None, None]
    cache[rows, pos] = torch.where(keep, kv_new.to(cache.dtype),
                                   cache[rows, pos])


def _bulk_write(cache, kv):
    """Prefill write, in place: kv (B, S, KVH, hd) into cache[:, :S]."""
    cache[:, :kv.shape[1]] = kv.to(cache.dtype)


# ---------------------------------------------------------------------------
# Dense MLP block


def init_mlp(gen: torch.Generator, cfg: ModelConfig, n_layers: int, *, dtype,
             d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    lead = (n_layers,)
    p: Params = {
        "norm2": common.init_norm(d, bias=cfg.norm == "layernorm",
                                  dtype=dtype, lead=lead),
        "w_in": common.dense_init(gen, d, ff, dtype, lead=lead),
        "w_out": common.dense_init(gen, ff, d, dtype, lead=lead),
    }
    if is_glu(cfg.activation):
        p["w_gate"] = common.dense_init(gen, d, ff, dtype, lead=lead)
    if cfg.mlp_bias:
        p["b_in"] = torch.zeros((n_layers, ff), dtype=dtype)
        p["b_out"] = torch.zeros((n_layers, d), dtype=dtype)
    return p


def mlp_apply(p: Params, adapters: Optional[Params], x, *, cfg: ModelConfig):
    y = apply_norm(p["norm2"], x, kind=cfg.norm, eps=cfg.norm_eps)
    hin = lora_apply(y, p["w_in"], _ad(adapters, "mlp_in"), p.get("b_in"))
    gate = None
    if "w_gate" in p:
        gate = lora_apply(y, p["w_gate"], _ad(adapters, "mlp_gate"))
    hmid = activate(hin, gate, cfg.activation)
    return lora_apply(hmid, p["w_out"], _ad(adapters, "mlp_out"),
                      p.get("b_out"))


# ---------------------------------------------------------------------------
# MoE block (token-choice top-k routing with per-group capacity)
#
# params: norm2{scale}, router (d, E), we_in/we_gate (E, d, ff), we_out
#         (E, ff, d); the shared expert ws_in/ws_gate (d, sf), ws_out (sf, d)


def init_moe(gen: torch.Generator, cfg: ModelConfig, n_layers: int, *,
             dtype) -> Params:
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    lead = (n_layers,)
    p: Params = {
        "norm2": common.init_norm(d, bias=False, dtype=dtype, lead=lead),
        "router": common.dense_init(gen, d, e, dtype, lead=lead),
        "we_in": common.dense_init(gen, d, ff, dtype, lead=lead + (e,)),
        "we_out": common.dense_init(gen, ff, d, dtype, lead=lead + (e,)),
    }
    if is_glu(cfg.activation):
        p["we_gate"] = common.dense_init(gen, d, ff, dtype, lead=lead + (e,))
    if cfg.num_shared_experts:
        sf = ff * cfg.num_shared_experts
        p["ws_in"] = common.dense_init(gen, d, sf, dtype, lead=lead)
        p["ws_out"] = common.dense_init(gen, sf, d, dtype, lead=lead)
        if is_glu(cfg.activation):
            p["ws_gate"] = common.dense_init(gen, d, sf, dtype, lead=lead)
    return p


MOE_GROUP_TOKENS = 4096    # the reference's routing-group size


def moe_capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per expert in a routing group of s tokens, in Python float
    arithmetic as the reference computes it; a decode token (s = 1) gets
    k, so it is never dropped."""
    k, e = cfg.moe_top_k, cfg.num_experts
    cap = max(int(k * s * cfg.moe_capacity_factor / e), 4 if s > 1 else k)
    return min(cap, s * k)


def moe_route(cfg: ModelConfig, yg, router):
    """Routing of groups yg (G, T, d): the router's fp32 probabilities
    (G, T, E), their top-k choices, and moe_queue's values, queue
    positions and cap for those choices."""
    probs = torch.softmax((yg @ router.to(yg.dtype)).float(), dim=-1)
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


def moe_apply(p: Params, adapters: Optional[Params], x, *, cfg: ModelConfig):
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
    probability (with gradient)."""
    e, k, d = cfg.num_experts, cfg.moe_top_k, cfg.d_model
    s = x.shape[-2]
    y = apply_norm(p["norm2"], x, kind=cfg.norm, eps=cfg.norm_eps)
    yg = y.reshape(-1, s, d)                                  # (G, T, d)
    if s > MOE_GROUP_TOKENS and s % MOE_GROUP_TOKENS == 0:
        yg = yg.reshape(-1, MOE_GROUP_TOKENS, d)
    g, s = yg.shape[0], yg.shape[1]
    probs, topv, topi, pos, cap = moe_route(cfg, yg, p["router"])
    keep = pos < cap
    wgt = topv * keep                                         # (G, T, k)

    # slot of each kept pair in the (E, G, C) buffer; dropped pairs all
    # write the spare row past the end, which is cut off.  A token picks
    # an expert once, so an expert's queue in a group holds at most s
    # pairs: C = min(cap, s) slots lose nothing (a decode tick's groups
    # of one token take 1 slot an expert, not the cap of k)
    c = min(cap, s)
    grp = torch.arange(g, device=x.device)[:, None, None]
    slot = torch.where(keep, (topi * g + grp) * c + pos, e * g * c)
    rows = yg[:, :, None, :].expand(g, s, k, d).reshape(-1, d)
    buf = yg.new_zeros((e * g * c + 1, d)).index_put(
        (slot.reshape(-1),), rows)
    xe = buf[:-1].reshape(e, g * c, d)
    hin = torch.bmm(xe, p["we_in"])
    gate = torch.bmm(xe, p["we_gate"]) if "we_gate" in p else None
    ye = torch.bmm(activate(hin, gate, cfg.activation), p["we_out"])
    # a dropped pair gathers row 0 at weight 0
    got = ye.reshape(-1, d).index_select(
        0, torch.where(keep, slot, 0).reshape(-1)).reshape(g, s, k, d)
    out = (got * wgt.to(got.dtype)[..., None]).sum(2)

    aux = 0.0
    if cfg.router_aux_loss:
        me = F.one_hot(topi, e).sum(2).float().mean(1)        # (G, E)
        pe = probs.mean(1)
        aux = cfg.router_aux_loss * e * torch.mean(torch.sum(me * pe, -1))

    if cfg.num_shared_experts:
        hin_s = lora_apply(y, p["ws_in"], _ad(adapters, "mlp_in"))
        gate_s = None
        if "ws_gate" in p:
            gate_s = lora_apply(y, p["ws_gate"], _ad(adapters, "mlp_gate"))
        shared = lora_apply(activate(hin_s, gate_s, cfg.activation),
                            p["ws_out"], _ad(adapters, "mlp_out"))
        return out.reshape(shared.shape) + shared, aux
    return out.reshape(y.shape), aux
