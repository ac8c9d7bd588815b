"""Plain PyTorch versions of the LoRA projections.

Ports of the JAX oracles (src/repro/kernels/lora_matmul/ref.py).
``lora_matmul_indexed`` follows the CUDA kernel's contract
(csrc/lora_indexed.cu): fp32 accumulation, ``xa = x @ A[id]`` kept in
fp32, one rounding to x's dtype at the end, ids clamped into the pool.
"""

from __future__ import annotations

import math

import torch


def lora_matmul(x, w, a, b, scale):
    """y = x @ W + scale * (x @ A) @ B.  x: (..., K); w: (K, N);
    a: (K, r); b: (r, N); scale: scalar.

    The single-adapter path (row 6 of PERF.md's kernel table); its fused
    kernel is ported with the training slice, so this plain version is
    what runs until then."""
    base = x @ w
    delta = (x @ a) @ b
    return base + torch.as_tensor(scale, dtype=base.dtype,
                                  device=base.device) * delta


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
    k_dim = x.shape[-1]
    x2 = x.reshape(-1, k_dim).float()
    rid = row_ids(ids, lead).long().clamp(0, a_pool.shape[0] - 1)
    base = x2 @ w.float()
    xa = torch.bmm(x2[:, None, :], a_pool.float()[rid])         # (M, 1, r)
    delta = torch.bmm(xa, b_pool.float()[rid])[:, 0]             # (M, N)
    y = base + scale.float()[rid][:, None] * delta
    return y.to(x.dtype).reshape(*lead, w.shape[1])
