"""Plain PyTorch versions of the LoRA projections.

Ports of the JAX oracles (src/repro/kernels/lora_matmul/ref.py and the
jnp backward of ops.py ``_jnp_bwd``) with the CUDA kernels' contracts
(csrc/lora_fused.cu, csrc/lora_indexed.cu): fp32 accumulation, the rank-r
intermediates ``xa = x @ A`` and ``gb = g @ B^T`` kept in fp32, one
rounding to the operand dtype at the end; indexed ids clamped into the
pool.
"""

from __future__ import annotations

import math

import torch


def lora_matmul_fwd(x, w, a, b, scale):
    """x (M, K); w (K, N); a (K, r); b (r, N); scale () fp32 ->
    (y = x @ W + scale * (x @ A) @ B in x's dtype, xa = x @ A (M, r) fp32)."""
    xf = x.float()
    xa = xf @ a.float()
    y = xf @ w.float() + scale.float() * (xa @ b.float())
    return y.to(x.dtype), xa


def lora_matmul_bwd(x, w, a, b, scale, g, xa):
    """The frozen-W backward for the cotangent g (M, N) and the forward's
    residual xa: (dx like x, dA like a, dB like b, dscale () fp32).

      gb = g @ B^T; dx = g @ W^T + s gb @ A^T; dA = s x^T gb;
      dB = s xa^T g; dscale = sum(xa * gb)."""
    gf, s = g.float(), scale.float()
    gb = gf @ b.float().T
    dx = gf @ w.float().T + s * (gb @ a.float().T)
    da = s * (x.float().T @ gb)
    db = s * (xa.T @ gf)
    return (dx.to(x.dtype), da.to(a.dtype), db.to(b.dtype),
            (xa * gb).sum())


def row_ids(ids, lead) -> torch.Tensor:
    """Per-row adapter ids for x of leading shape (B, ...): each slot's id
    repeated over its trailing dims."""
    reps = math.prod(lead[1:]) if len(lead) > 1 else 1
    ids = ids.to(torch.int32)
    return ids if reps == 1 else ids.repeat_interleave(reps)


def lora_matmul_indexed(x, w, a_pool, b_pool, scale, ids):
    """Multi-adapter projection: y[i] = x[i] @ W + s[ids[i]] *
    (x[i] @ A[ids[i]]) @ B[ids[i]].

    x: (B, ..., K); w: (K, N); a_pool: (P, K, r); b_pool: (P, r, N);
    scale: (P,); ids: (B,) int32, one adapter per leading row.  Rank
    heterogeneity rides masked rank slots in the pools."""
    lead = x.shape[:-1]
    if tuple(ids.shape) != tuple(lead[:1]):
        raise ValueError(f"lora_matmul_indexed: ids{tuple(ids.shape)} do "
                         f"not match x's leading axis {tuple(lead[:1])}")
    k_dim = x.shape[-1]
    x2 = x.reshape(-1, k_dim).float()
    rid = row_ids(ids, lead).long().clamp(0, a_pool.shape[0] - 1)
    base = x2 @ w.float()
    xa = torch.bmm(x2[:, None, :], a_pool.float()[rid])         # (M, 1, r)
    delta = torch.bmm(xa, b_pool.float()[rid])[:, 0]             # (M, N)
    y = base + scale.float()[rid][:, None] * delta
    return y.to(x.dtype).reshape(*lead, w.shape[1])
