"""Public wrapper for the flash attention forward.

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
hand-written kernel (csrc/flash_fwd.cu) or raises.  There is no other
dispatch and no fallback.  Forward only: the backward kernel belongs to
the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (16, 32, 64)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None, q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,Sq,H,hd) x (B,Sk,KVH,hd) -> (out (B,Sq,H,hd), lse (B*H,Sq,1) fp32).

    Sq and Sk need not divide any block size: ragged tails are masked."""
    s = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ref.attention_fwd(q, k, v, causal=causal, window=window,
                                 scale=s, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} must match q's "
                             f"device and dtype")
        if t.shape != (b, sk, kvh, hd):
            raise ValueError(f"flash_attention: {name} has shape "
                             f"{tuple(t.shape)}, want {(b, sk, kvh, hd)}")
    if kvh < 1 or h % kvh:
        raise ValueError(f"flash_attention: H={h} not a multiple of KVH={kvh}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    code = _build.dtype_code(q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq, 1), dtype=torch.float32, device=q.device)
    lib = _build.library()
    err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), b, sq, sk, h, kvh,
                        hd, int(q_offset), int(bool(causal)), int(window), s,
                        code, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, q_offset: int = 0):
    """Attention output only: (B,Sq,H,hd) x (B,Sk,KVH,hd) -> (B,Sq,H,hd)."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               scale=scale, q_offset=q_offset)[0]
