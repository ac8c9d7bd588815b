"""Public wrappers for flash-decode attention, contiguous and paged.

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
hand-written kernel (csrc/decode_attention.cu, one source with the page
indirection as a template flag) or raises.  Inference only.

The kernel splits each cache into 64-position chunks over CTAs and merges
them in one launch: it takes a workspace for the chunks' softmax states
(allocated per call) and a counter per (sequence, kv head), kept zeroed
between calls (``_build.counters``).  It takes head dims that are a
multiple of 8 up to 128.

``decode_attention_partial`` is the same kernel over one block of a
cache whose sequence is split over ranks (global positions from
seq_lo): it returns the block's fp32 output and log-sum-exp, which
``ref.merge_partials`` merges, and counts its own launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ref

MAX_HD = 128


def _check(name, q, k, v, cache_len, kv_lead):
    b, h, hd = q.shape
    kvh = k.shape[-2]
    want = kv_lead + (kvh, hd)
    for tname, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {tname} must match q's device and dtype")
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {tname} has shape {tuple(t.shape)}, "
                             f"want {want}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"{name}: H={h} not a multiple of KVH={kvh}")
    if cache_len.shape != (b,) or cache_len.dtype != torch.int32 \
            or cache_len.device != q.device:
        raise ValueError(f"{name}: cache_len must be ({b},) int32 on "
                         f"{q.device}")
    if not all(t.is_contiguous() for t in (q, k, v, cache_len)):
        raise ValueError(f"{name}: tensors must be contiguous")
    if hd % 8 or not 8 <= hd <= MAX_HD:
        raise ValueError(f"{name}: head dim {hd} not a multiple of 8 in "
                         f"8..{MAX_HD}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: k and v must start 16-byte aligned")
    return _build.dtype_code(q.dtype)


def _scratch(name, q, kvh, capacity):
    """(workspace, counters) of one call over `capacity` cache positions."""
    b, h, hd = q.shape
    lib = _build.library()
    work = torch.empty((lib.decode_attention_work(b, capacity, h, hd),),
                       dtype=torch.float32, device=q.device)
    return work, _build.counters(name, q.device, b * kvh)


def decode_attention(q, k, v, cache_len, *, scale: Optional[float] = None,
                     window: int = 0):
    """q (B,H,hd); k/v cache (B,S,KVH,hd); cache_len (B,) -> (B,H,hd)."""
    s = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, cache_len, scale=s,
                                    window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    b, h, hd = q.shape
    seq, kvh = k.shape[1], k.shape[2]
    code = _check("decode_attention", q, k, v, cache_len, (b, seq))
    out = torch.empty_like(q)
    work, ctr = _scratch("decode_attention", q, kvh, seq)
    err = _build.library().decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(),
        work.data_ptr(), ctr.data_ptr(), out.data_ptr(), b, seq, h, kvh, hd,
        int(window), s, code, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_partial(q, k, v, cache_len, seq_lo: int, *,
                             scale: Optional[float] = None, window: int = 0):
    """q (B,H,hd); k/v one block (B,S_blk,KVH,hd) of a split cache, global
    positions [seq_lo, seq_lo + S_blk); cache_len (B,) global -> (o
    (B,H,hd) fp32, lse (B,H) fp32), as ``ref.decode_attention_partial``."""
    s = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ref.decode_attention_partial(q, k, v, cache_len, seq_lo,
                                            scale=s, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_partial: unsupported device "
                         f"{q.device}")
    b, h, hd = q.shape
    seq, kvh = k.shape[1], k.shape[2]
    code = _check("decode_attention_partial", q, k, v, cache_len, (b, seq))
    if seq_lo < 0:
        raise ValueError(f"decode_attention_partial: seq_lo {seq_lo} < 0")
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    work, ctr = _scratch("decode_attention_partial", q, kvh, seq)
    err = _build.library().decode_attention_partial(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(),
        work.data_ptr(), ctr.data_ptr(), out.data_ptr(), lse.data_ptr(), b,
        seq, int(seq_lo), h, kvh, hd, int(window), s, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention_partial")
    decode_attention_partial.launches += 1
    return out, lse


decode_attention_partial.launches = 0


def decode_attention_paged(q, k_pool, v_pool, page_table, cache_len, *,
                           scale: Optional[float] = None, window: int = 0):
    """q (B,H,hd); k/v pool (n_pages, ps, KVH, hd); page_table (B, P_max)
    int32; cache_len (B,) -> (B,H,hd).  The kernel clips every table entry
    into [0, n_pages - 1] itself."""
    s = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ref.decode_attention_paged(q, k_pool, v_pool, page_table,
                                          cache_len, scale=s, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_paged: unsupported device "
                         f"{q.device}")
    b, h, hd = q.shape
    n_pages, ps, kvh = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    code = _check("decode_attention_paged", q, k_pool, v_pool, cache_len,
                  (n_pages, ps))
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or page_table.dtype != torch.int32 \
            or page_table.device != q.device \
            or not page_table.is_contiguous():
        raise ValueError(f"decode_attention_paged: page_table must be a "
                         f"contiguous ({b}, P_max) int32 tensor on {q.device}")
    out = torch.empty_like(q)
    p_max = page_table.shape[1]
    work, ctr = _scratch("decode_attention_paged", q, kvh, p_max * ps)
    err = _build.library().decode_attention_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), cache_len.data_ptr(), work.data_ptr(),
        ctr.data_ptr(), out.data_ptr(), b, n_pages, ps, p_max, h, kvh, hd,
        int(window), s, code, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention_paged")
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0
