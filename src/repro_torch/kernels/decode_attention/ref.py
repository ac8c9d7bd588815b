"""Plain PyTorch versions of single-token decode attention over a KV cache.

Ports of the JAX oracles (src/repro/kernels/decode_attention/ref.py
``decode_attention`` and ``decode_attention_paged``) with the CUDA
kernel's contract (csrc/decode_attention.cu): q is scaled in fp32, scores
and softmax are fp32, and a row with ``cache_len = 0`` gives exact zeros
(the JAX oracle gives NaN there).

q: (B, H, hd); contiguous k/v: (B, S, KVH, hd); cache_len: (B,) int32.
Positions >= cache_len (and before cache_len - window, window > 0) are
masked.

A cache whose sequence is split into blocks (over the "model" ranks, as
``runtime.sharding.cache_specs`` places it) is attended block by block:
``decode_attention_partial`` over one block gives its normalised output
and log-sum-exp, and ``merge_partials`` weighs the blocks by their lse
into the whole cache's output.
"""

from __future__ import annotations

from typing import Optional

import torch


def _masked_scores(q, k, cache_len, seq_lo: int, scale, window: int):
    """(scaled fp32 scores (B, KVH, group, S) with the positions outside
    [cache_len - window, cache_len) at -inf, whether a row has any valid
    position); k holds global positions [seq_lo, seq_lo + S)."""
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = hd ** -0.5
    qg = (q.float() * scale).reshape(b, kvh, h // kvh, hd)
    scores = torch.einsum("bgkd,bsgd->bgks", qg, k.float())
    pos = seq_lo + torch.arange(s, device=q.device)[None, :]
    clen = cache_len.to(torch.int64)[:, None]
    valid = pos < clen
    if window > 0:
        valid &= pos >= clen - window
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    return scores, valid.any(-1)[:, None, None, None]


def _softmax_v(scores, live, v):
    probs = torch.softmax(scores, dim=-1).masked_fill(~live, 0.0)
    return torch.einsum("bgks,bsgd->bgkd", probs, v.float())


def decode_attention(q, k, v, cache_len, *, scale: Optional[float] = None,
                     window: int = 0):
    scores, live = _masked_scores(q, k, cache_len, 0, scale, window)
    return _softmax_v(scores, live, v).reshape(q.shape).to(q.dtype)


def decode_attention_partial(q, k_blk, v_blk, cache_len, seq_lo: int, *,
                             scale: Optional[float] = None, window: int = 0):
    """One block of a split cache: k_blk/v_blk (B, S_blk, KVH, hd) hold
    global positions [seq_lo, seq_lo + S_blk); cache_len (B,) and the
    window act on global positions.  Returns (o (B, H, hd) fp32, this
    block's softmax over its valid positions applied to v; lse (B, H)
    fp32, the natural log-sum-exp of its scaled scores).  A row with no
    valid position in the block gives o = 0 and lse = -inf."""
    scores, live = _masked_scores(q, k_blk, cache_len, int(seq_lo), scale,
                                  window)
    out = _softmax_v(scores, live, v_blk)
    lse = torch.logsumexp(scores, dim=-1)                    # -inf if none
    return out.reshape(q.shape), lse.reshape(q.shape[:2])


def merge_partials(outs, lses):
    """The blocks' (o, lse) of ``decode_attention_partial``, in block
    order, merged into the whole cache's output (fp32): each block
    weighed by exp(lse - max lse), summed in block order and divided by
    the weights' sum; a row no block saw is 0."""
    m = lses[0]
    for lse in lses[1:]:
        m = torch.maximum(m, lse)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    num = den = None
    for o, lse in zip(outs, lses):
        w = torch.exp(lse - m)
        part = o * w[..., None]
        num = part if num is None else num + part
        den = w if den is None else den + w
    return torch.where(den[..., None] > 0,
                       num / torch.clamp(den, min=1e-38)[..., None],
                       torch.zeros_like(num))


def decode_attention_paged(q, k_pool, v_pool, page_table, cache_len, *,
                           scale: Optional[float] = None, window: int = 0):
    """Paged cache: k_pool/v_pool (n_pages, ps, KVH, hd) addressed by
    page_table (B, P_max) int32; entry p holds positions [p*ps, (p+1)*ps).
    Entries past the valid prefix may hold anything: they are clipped into
    the pool and masked by cache_len."""
    n_pages = k_pool.shape[0]
    pt = page_table.long().clamp(0, n_pages - 1)
    k = k_pool[pt]                                   # (B, Pm, ps, KVH, hd)
    v = v_pool[pt]
    b, pm, ps, kvh, hd = k.shape
    return decode_attention(q, k.reshape(b, pm * ps, kvh, hd),
                            v.reshape(b, pm * ps, kvh, hd), cache_len,
                            scale=scale, window=window)
