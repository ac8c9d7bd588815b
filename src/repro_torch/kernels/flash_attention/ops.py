"""Public wrappers for flash attention, forward and backward.

A CPU tensor runs the plain versions (ref.py); a CUDA tensor launches the
hand-written kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu) or raises.
There is no other dispatch and no fallback.  ``flash_attention`` is a
``torch.autograd.Function`` (the reference's ``custom_vjp``): the forward
saves (q, k, v, out, lse) and the backward rebuilds dQ/dK/dV from them
with the backward kernel, without recomputing the forward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (16, 32, 64, 112, 128)


def _check(q, k, v, *others):
    """Shapes, dtypes, devices and contiguity the kernels take."""
    b, _, h, hd = q.shape
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
    for t in (q, k, v) + others:
        if t.device != q.device:
            raise ValueError("flash_attention: all tensors on one device")
        if not t.is_contiguous():
            raise ValueError("flash_attention: tensors must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(
            ("do", t) for t in others[2:]):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a "
                             f"16-byte boundary (the kernels stage it with "
                             f"16-byte copies)")
    return _build.dtype_code(q.dtype)


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
    code = _check(q, k, v)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b * h, sq, 1), dtype=torch.float32, device=q.device)
    err = _build.library().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, sk, h, kvh, hd, int(q_offset),
        int(bool(causal)), int(window), s, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        window: int = 0, scale: Optional[float] = None,
                        q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) like (q, k, v) from the forward's (out, lse) and the
    output gradient do (B,Sq,H,hd).  delta = rowsum(do * out) is one torch
    op in fp32, as in the reference's wrapper; the kernels do the rest."""
    s = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return ref.attention_bwd(q, k, v, out, lse, do, causal=causal,
                                 window=window, scale=s, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    code = _check(q, k, v, out, lse, do)
    if out.shape != q.shape or do.shape != q.shape \
            or out.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("flash_attention: out and do must be like q")
    if lse.shape != (b * h, sq, 1) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention: lse must be ({b * h}, {sq}, 1) "
                         f"float32")
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _build.library().flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, sq, sk, h, kvh, hd, int(q_offset),
        int(bool(causal)), int(window), s, code,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       scale=scale, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = dict(causal=causal, window=window, scale=scale,
                       q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g.contiguous(),
                                         **ctx.cfg)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, q_offset: int = 0):
    """Differentiable attention: (B,Sq,H,hd) x (B,Sk,KVH,hd) -> (B,Sq,H,hd)."""
    return _FlashAttention.apply(q, k, v, bool(causal), int(window), scale,
                                 int(q_offset))
