"""Plain PyTorch version of the smashed-activation int8 quantizers.

Port of the JAX oracle (src/repro/kernels/smashed_quant/ref.py), with
the CUDA kernel's contract (csrc/smashed_quant.cu), which is the same:

  x: (G, M, d) -- G messages (one per client), M tokens, d channels.
  quantize:   scale[g, c] = max(max_m |x[g, m, c]|, 1e-12) * fp32(1/127)
              (the reference's "/ 127" as XLA compiles it under jit);
              q = clip(round(x / scale), -127, 127) int8, a true division
              rounded half to even (torch.round, like jnp.round).
  dequantize: x_hat = q * scale in the requested dtype.
"""

from __future__ import annotations

import torch

EPS = 1e-12


def quantize(x):
    """x (G, M, d) -> (q (G, M, d) int8, scale (G, d) float32)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-2)                            # (G, d)
    scale = torch.clamp(amax, min=EPS) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None, :]), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q, scale, dtype=torch.float32):
    """(q (G, M, d) int8, scale (G, d)) -> x_hat (G, M, d) in `dtype`."""
    return (q.float() * scale[..., None, :]).to(dtype)


def roundtrip(x):
    """Wire round trip: dequantize(quantize(x)) in x.dtype."""
    q, scale = quantize(x)
    return dequantize(q, scale, x.dtype)
