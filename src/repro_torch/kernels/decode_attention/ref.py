"""Plain PyTorch versions of single-token decode attention over a KV cache.

Ports of the JAX oracles (src/repro/kernels/decode_attention/ref.py
``decode_attention`` and ``decode_attention_paged``) with the CUDA
kernel's contract (csrc/decode_attention.cu): q is scaled in fp32, scores
and softmax are fp32, and a row with ``cache_len = 0`` gives exact zeros
(the JAX oracle gives NaN there).

q: (B, H, hd); contiguous k/v: (B, S, KVH, hd); cache_len: (B,) int32.
Positions >= cache_len (and before cache_len - window, window > 0) are
masked.
"""

from __future__ import annotations

from typing import Optional

import torch


def decode_attention(q, k, v, cache_len, *, scale: Optional[float] = None,
                     window: int = 0):
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    if scale is None:
        scale = hd ** -0.5
    qg = (q.float() * scale).reshape(b, kvh, group, hd)
    scores = torch.einsum("bgkd,bsgd->bgks", qg, k.float())     # (B,KVH,grp,S)
    pos = torch.arange(s, device=q.device)[None, :]
    clen = cache_len.to(torch.int64)[:, None]
    valid = pos < clen
    if window > 0:
        valid &= pos >= clen - window
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    live = valid.any(-1)[:, None, None, None]
    probs = torch.softmax(scores, dim=-1).masked_fill(~live, 0.0)
    out = torch.einsum("bgks,bsgd->bgkd", probs, v.float())
    return out.reshape(b, h, hd).to(q.dtype)


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
