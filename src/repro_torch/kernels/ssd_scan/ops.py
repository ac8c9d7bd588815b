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

``return_state=True`` (prefill into a serving cache) runs the same
kernel, which then also writes the state after the last chunk
(``ssd_scan_fwd_state``, a launch counter of its own).  The reference
computes that state with its chunked oracle outside Pallas; on the card
the port's plain version stays off the path.
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


def _launch(x, dt, a, bm, c, chunk, final):
    """Check the inputs and launch the kernel; `final` is None or the
    (B, H, P, N) fp32 tensor that takes the state after the last chunk."""
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
    # the chunk states (B*H, S/Q, P, N), then the per-group C.B^T tiles
    # (B, G, S/Q, Q, Q)
    nc = s // chunk
    states = torch.empty((b * h * nc * p * n + b * g * nc * chunk * chunk,),
                         dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _build.library().ssd_scan_fwd(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
        c.data_ptr(), y.data_ptr(), cum.data_ptr(), states.data_ptr(),
        None if final is None else final.data_ptr(), b, s, h, g, p, n,
        chunk, code, stream)
    _build.check(err, "ssd_scan_fwd")
    return y


def ssd_scan_fwd(x, dt, a, bm, c, *, chunk: int):
    """The kernel: x (B,S,H,P); dt (B,S,H) fp32; a (H,) fp32; bm/c
    (B,S,G,N) in x's dtype, all contiguous on one CUDA device -> y
    (B,S,H,P) in x's dtype.  S % chunk == 0."""
    y = _launch(x, dt, a, bm, c, chunk, None)
    ssd_scan_fwd.launches += 1
    return y


ssd_scan_fwd.launches = 0


def ssd_scan_fwd_state(x, dt, a, bm, c, *, chunk: int):
    """The same kernel asked for the state after the last chunk as well
    (prefill into a serving cache) -> (y, state (B,H,P,N) fp32)."""
    b, _, h, p = x.shape
    final = torch.empty((b, h, p, bm.shape[-1]), dtype=torch.float32,
                        device=x.device)
    y = _launch(x, dt, a, bm, c, chunk, final)
    ssd_scan_fwd_state.launches += 1
    return y, final


ssd_scan_fwd_state.launches = 0


class _SSDScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dt, a, bm, c, chunk, return_state):
        ctx.save_for_backward(x, dt, a, bm, c)
        ctx.chunk = chunk
        if not return_state:
            return ssd_scan_fwd(x, dt, a, bm, c, chunk=chunk)
        y, state = ssd_scan_fwd_state(x, dt, a, bm, c, chunk=chunk)
        # the reference hands the state back in x's dtype
        return y, state.to(x.dtype)

    @staticmethod
    def backward(ctx, g, g_state=None):
        need = ctx.needs_input_grad[:5]
        ins = [t.detach().requires_grad_(r)
               for t, r in zip(ctx.saved_tensors, need)]
        grads = iter(())
        if any(need):
            with torch.enable_grad():
                y, state = ref.ssd_chunked(*ins, chunk=ctx.chunk,
                                           return_state=True)
                outs, cots = [y], [g]
                if g_state is not None:
                    outs.append(state)
                    cots.append(g_state)
                grads = iter(torch.autograd.grad(
                    outs, [t for t in ins if t.requires_grad], cots))
        return tuple(next(grads) if r else None for r in need) + (None,
                                                                  None)


def ssd_scan(x, dt, a, bm, c, *, chunk: int = 256,
             return_state: bool = False):
    """x (B,S,H,P); dt (B,S,H); a (H,); bm/c (B,S,G,N) -> y (B,S,H,P), and
    with return_state also the state after the last chunk (B,H,P,N) in
    x's dtype, as the reference's ssd_chunked(return_state=True).

    chunk is capped at S, as in the reference; S % chunk must be 0.  On
    the card dt and A are taken in fp32 and B/C in x's dtype, every input
    contiguous (the kernel's layout): anything else raises."""
    chunk = min(chunk, x.shape[1])
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, a, bm, c, chunk=chunk,
                               return_state=return_state)
    return _SSDScan.apply(x, dt, a, bm, c, chunk, return_state)
