"""Public wrappers for flash-decode attention, contiguous and paged.

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
hand-written kernel (csrc/decode_attention.cu, one source with the page
indirection as a template flag) or raises.  Inference only.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ref


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
    return _build.dtype_code(q.dtype)


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
    lib = _build.library()
    err = lib.decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               cache_len.data_ptr(), out.data_ptr(), b, seq,
                               h, kvh, hd, int(window), s, code,
                               torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


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
    lib = _build.library()
    err = lib.decode_attention_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), cache_len.data_ptr(), out.data_ptr(), b,
        n_pages, ps, page_table.shape[1], h, kvh, hd, int(window), s, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention_paged")
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0
