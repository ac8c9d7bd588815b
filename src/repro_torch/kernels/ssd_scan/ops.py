"""Public wrapper for the Mamba2 SSD chunked scan.

A CPU tensor runs the plain ``ref.ssd_chunked`` (differentiable through
autograd); a CUDA tensor launches the hand-written kernel
(csrc/ssd_scan.cu) or raises.  There is no other dispatch and no
fallback.

On the card the scan is a ``torch.autograd.Function``, the reference's
``custom_vjp``: the forward is the kernel and saves only its inputs; the
backward recomputes the plain ``ref.ssd_chunked`` under autograd and
returns its gradients.  The reference has no backward kernel either (its
backward is ``jax.vjp`` of its chunked oracle).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ref

MAX_HEAD_DIM = 64
MAX_STATE = 256


def _check(x, dt, a, bm, c, chunk):
    b, s, h, p = x.shape
    if dt.shape != (b, s, h) or a.shape != (h,) or bm.dim() != 4 \
            or bm.shape[:2] != (b, s) or c.shape != bm.shape:
        raise ValueError(f"ssd_scan: shapes x{tuple(x.shape)} "
                         f"dt{tuple(dt.shape)} a{tuple(a.shape)} "
                         f"B{tuple(bm.shape)} C{tuple(c.shape)} do not agree")
    g, n = bm.shape[2], bm.shape[3]
    if h % g:
        raise ValueError(f"ssd_scan: {g} groups do not divide {h} heads")
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    return b, s, h, p, g, n


def ssd_scan_fwd(x, dt, a, bm, c, *, chunk: int):
    """The kernel: x (B,S,H,P); dt (B,S,H) fp32; a (H,) fp32; bm/c
    (B,S,G,N) in x's dtype, all contiguous on one CUDA device -> y
    (B,S,H,P) in x's dtype.  S % chunk == 0."""
    b, s, h, p, g, n = _check(x, dt, a, bm, c, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_fwd: unsupported device {x.device}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError("ssd_scan_fwd: dt and A must be float32")
    if bm.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"ssd_scan_fwd: B {bm.dtype} and C {c.dtype} must "
                         f"have x's dtype {x.dtype}")
    if any(t.device != x.device for t in (dt, a, bm, c)):
        raise ValueError("ssd_scan_fwd: all tensors on one device")
    if not all(t.is_contiguous() for t in (x, dt, a, bm, c)):
        raise ValueError("ssd_scan_fwd: tensors must be contiguous")
    if p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd_scan_fwd: head dim {p} > {MAX_HEAD_DIM} or "
                         f"state {n} > {MAX_STATE}")
    code = _build.dtype_code(x.dtype)
    y = torch.empty_like(x)
    cum = torch.empty((b * h, s), dtype=torch.float32, device=x.device)
    states = torch.empty((b * h, s // chunk, p, n), dtype=torch.float32,
                         device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.library().ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
        c.data_ptr(), y.data_ptr(), cum.data_ptr(), states.data_ptr(), b, s,
        h, g, p, n, chunk, code, stream)
    _build.check(err, "ssd_scan_fwd")
    ssd_scan_fwd.launches += 1
    return y


ssd_scan_fwd.launches = 0


class _SSDScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dt, a, bm, c, chunk):
        ctx.save_for_backward(x, dt, a, bm, c)
        ctx.chunk = chunk
        return ssd_scan_fwd(x, dt, a, bm, c, chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:5]
        ins = [t.detach().requires_grad_(r)
               for t, r in zip(ctx.saved_tensors, need)]
        grads = iter(())
        if any(need):
            with torch.enable_grad():
                y = ref.ssd_chunked(*ins, chunk=ctx.chunk)
                grads = iter(torch.autograd.grad(
                    y, [t for t in ins if t.requires_grad], g))
        return tuple(next(grads) if r else None for r in need) + (None,)


def ssd_scan(x, dt, a, bm, c, *, chunk: int = 256):
    """x (B,S,H,P); dt (B,S,H); a (H,); bm/c (B,S,G,N) -> y (B,S,H,P).

    chunk is capped at S, as in the reference; S % chunk must be 0.  On
    the card dt and A are taken in fp32 and B/C in x's dtype, every input
    contiguous (the kernel's layout): anything else raises."""
    chunk = min(chunk, x.shape[1])
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, a, bm, c, chunk=chunk)
    return _SSDScan.apply(x, dt, a, bm, c, chunk)
