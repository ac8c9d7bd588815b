"""Plain PyTorch version of the flash attention forward.

Port of the JAX oracle (src/repro/kernels/flash_attention/ref.py
``attention``) with the CUDA kernel's contract: q (B, Sq, H, hd), k/v
(B, Sk, KVH, hd) with H % KVH == 0, fp32 scores, and a row that sees no
key gives zeros (the JAX oracle gives NaN there).  ``attention_fwd`` also
returns the kernel's logsumexp residual ``lse`` (B*H, Sq, 1) fp32, 0 for
empty rows.  Materializes the (Sq, Sk) score matrix: a test and CPU path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: Optional[float] = None,
                  q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    if scale is None:
        scale = hd ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(groups, dim=2)
    vf = v.float().repeat_interleave(groups, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)

    q_pos = torch.arange(sq, device=q.device) + int(q_offset)
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    scores = scores.masked_fill(~mask, float("-inf"))
    live = mask.any(-1)[:, None]                        # (Sq, 1)
    probs = torch.softmax(scores, dim=-1).masked_fill(~live, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
    lse = torch.logsumexp(scores, dim=-1).masked_fill(~live[:, 0], 0.0)
    return out, lse.reshape(b * h, sq, 1)


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: Optional[float] = None, q_offset: int = 0):
    """window > 0 -> sliding-window attention of that width; q_offset is
    the absolute position of q[0]."""
    return attention_fwd(q, k, v, causal=causal, window=window, scale=scale,
                         q_offset=q_offset)[0]
