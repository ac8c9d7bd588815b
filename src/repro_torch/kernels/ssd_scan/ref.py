"""Plain PyTorch versions of the Mamba2 SSD (state-space duality) scan.

Port of the JAX oracles (src/repro/kernels/ssd_scan/ref.py), and the
contract of the CUDA kernel (csrc/ssd_scan.cu).  Per head h, state size
N, head dim P:

  a_t = dt_t * A_h                        (A_h < 0: log-decay per step)
  h_t = exp(a_t) * h_{t-1} + dt_t * (x_t outer B_t)      h: (P, N)
  y_t = C_t . h_t                         (contract N)

  * ssd_sequential -- the literal per-timestep recurrence (ground truth);
  * ssd_chunked    -- the chunked algorithm: the intra-chunk quadratic
    part plus the inter-chunk state carry, what the kernel computes;
  * ssd_decode_step -- one token of the recurrence, for serving.

Shapes: x (B,S,H,P), dt (B,S,H) positive, A (H,) negative, Bm/C (B,S,G,N)
with G | H.  Everything runs in fp32; y comes back in x's dtype, and the
final state (B,H,P,N) too when asked for.

One difference from the reference's ssd_chunked: the intra-chunk decay
exp(cum_t - cum_i) is masked before the exponent (-inf above the
diagonal), not after it.  Above the diagonal cum_t - cum_i is positive,
and once a chunk's total decay passes ~88 its exponent is inf; the
reference's where(tri, exp(rel), 0) then gives the right forward value
but a backward of 0 * inf = NaN.  The masked form has the same forward
and finite gradients at any chunk length.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _expand_groups(t, h):
    """(B,S,G,N) -> (B,S,H,N) by repeating each group over its heads."""
    return torch.repeat_interleave(t, h // t.shape[2], dim=2)


def ssd_sequential(x, dt, a, bm, c, h0=None, *, return_state: bool = False):
    b, s, h, p = x.shape
    n = bm.shape[-1]
    bm = _expand_groups(bm, h).float()
    cm = _expand_groups(c, h).float()
    xf, dtf, af = x.float(), dt.float(), a.float()
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    ys = []
    for t in range(s):
        dtt = dtf[:, t]                                       # (B,H)
        decay = torch.exp(dtt * af)[..., None, None]
        upd = dtt[..., None, None] * xf[:, t, :, :, None] * \
            bm[:, t, :, None, :]
        state = decay * state + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, cm[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)
    if return_state:
        return y, state.to(x.dtype)
    return y


def _chunk_step(state, xc, dtc, bc, cc, cumc, heads_per_group: int):
    """One chunk.  state (B,H,P,N) fp32; xc (B,Q,H,P), dtc (B,Q,H),
    bc/cc (B,Q,G,N), cumc (B,Q,H) -> (state', y (B,Q,H,P))."""
    q = xc.shape[1]
    rep = lambda t: torch.repeat_interleave(t, heads_per_group, dim=2)  # noqa: E731
    ch = rep(cc)
    # inter-chunk: y_inter[t] = exp(cum[t]) * C_t . state
    y_inter = torch.einsum("bqhn,bhpn->bqhp", ch, state) * \
        torch.exp(cumc)[..., None]
    # intra-chunk: M[t,i] = (C_t . B_i) exp(cum[t] - cum[i]) dt_i, i <= t;
    # the exponent is masked to -inf above the diagonal (module docstring)
    rel = cumc[:, :, None, :] - cumc[:, None, :, :]           # (B,Q,Q,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=xc.device))[None, :, :, None]
    decay_m = torch.exp(torch.where(tri, rel, float("-inf")))
    cb = torch.repeat_interleave(torch.einsum("bqgn,bign->bqig", cc, bc),
                                 heads_per_group, dim=3)      # (B,Q,Q,H)
    m = cb * decay_m * dtc[:, None, :, :]
    y_intra = torch.einsum("bqih,bihp->bqhp", m, xc)
    # state carry:
    #   state' = exp(cum[-1]) state + sum_i exp(cum[-1] - cum[i]) dt_i x_i (x) B_i
    total = cumc[:, -1, :]                                    # (B,H)
    w = torch.exp(total[:, None, :] - cumc) * dtc             # (B,Q,H)
    upd = torch.einsum("bqhp,bqhn->bhpn", xc * w[..., None], rep(bc))
    state = torch.exp(total)[..., None, None] * state + upd
    return state, y_inter + y_intra


def ssd_chunked(x, dt, a, bm, c, h0=None, *, chunk: int = 256,
                return_state: bool = False):
    """SSD chunked algorithm; matches ssd_sequential to fp32 tolerance.

    Under autograd each chunk's body is recomputed in the backward
    (torch.utils.checkpoint, the reference's jax.checkpoint), so the
    O(Q^2) intra-chunk intermediates are not saved for every chunk."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    xs = x.float().reshape(b, nc, chunk, h, p)
    dts = dt.float().reshape(b, nc, chunk, h)
    bs = bm.float().reshape(b, nc, chunk, g, n)
    cs = c.float().reshape(b, nc, chunk, g, n)
    cum = torch.cumsum(dts * a.float(), dim=2)                # (B,NC,Q,H)

    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, a, bm, c, h0) if t is not None)
    ys = []
    for i in range(nc):
        args = (state, xs[:, i], dts[:, i], bs[:, i], cs[:, i], cum[:, i],
                h // g)
        if remat:
            state, y = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            state, y = _chunk_step(*args)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p).to(x.dtype)
    if return_state:
        return y, state.to(x.dtype)
    return y


def ssd_decode_step(state, xt, dtt, a, bt, ct):
    """One-token recurrence for serving.  state (B,H,P,N); xt (B,H,P);
    dtt (B,H); bt/ct (B,G,N) -> (y (B,H,P), state')."""
    h, g = xt.shape[1], bt.shape[1]
    bt = torch.repeat_interleave(bt, h // g, dim=1).float()
    ct = torch.repeat_interleave(ct, h // g, dim=1).float()
    sf = state.float()
    dtf = dtt.float()
    decay = torch.exp(dtf * a.float())
    upd = dtf[..., None, None] * xt.float()[..., :, None] * bt[..., None, :]
    sf = decay[..., None, None] * sf + upd
    y = torch.einsum("bhpn,bhn->bhp", sf, ct)
    return y.to(xt.dtype), sf.to(state.dtype)
