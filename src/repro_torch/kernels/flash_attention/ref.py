"""Plain PyTorch versions of the flash attention forward and backward.

Port of the JAX oracle (src/repro/kernels/flash_attention/ref.py
``attention``) with the CUDA kernels' contract: q (B, Sq, H, hd), k/v
(B, Sk, KVH, hd) with H % KVH == 0, fp32 scores, and a row that sees no
key gives zeros (the JAX oracle gives NaN there).  ``attention_fwd`` also
returns the kernel's logsumexp residual ``lse`` (B*H, Sq, 1) fp32, 0 for
empty rows; ``attention_bwd`` rebuilds dQ/dK/dV from it, as
csrc/flash_bwd.cu does.  Both materialize the (Sq, Sk) score matrix: a
test and CPU path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: Optional[float] = None,
                  q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    b, sq, h, hd = q.shape
    groups = h // k.shape[2]
    if scale is None:
        scale = hd ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(groups, dim=2)
    vf = v.float().repeat_interleave(groups, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    mask = _mask(sq, k.shape[1], causal, window, q_offset, q.device)
    scores = scores.masked_fill(~mask, float("-inf"))
    live = mask.any(-1)[:, None]                        # (Sq, 1)
    probs = torch.softmax(scores, dim=-1).masked_fill(~live, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
    out = out.contiguous()                    # the kernel's layout
    lse = torch.logsumexp(scores, dim=-1).masked_fill(~live[:, 0], 0.0)
    return out, lse.reshape(b * h, sq, 1)


def attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                  window: int = 0, scale: Optional[float] = None,
                  q_offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's residuals (out, lse (B*H, Sq, 1))
    and the output gradient do, in the input dtypes:

      p = exp(s - lse) (0 where masked), dp = do v^T,
      ds = p (dp - rowsum(do * out)) scale,
      dq = ds k, dk = ds^T q (summed over the GQA group), dv = p^T do."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    groups = h // kvh
    if scale is None:
        scale = hd ** -0.5
    qf = q.float()
    kf = k.float().repeat_interleave(groups, dim=2)
    vf = v.float().repeat_interleave(groups, dim=2)
    dof = do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kf)
    mask = _mask(sq, sk, causal, window, q_offset, q.device)
    p = torch.exp(s - lse.reshape(b, h, sq, 1)).masked_fill(~mask, 0.0)
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, sk, kvh, groups, hd).sum(3)
    dv = dv.reshape(b, sk, kvh, groups, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _mask(sq, sk, causal, window, q_offset, device):
    """(Sq, Sk) bool: key kj is visible to query row qi."""
    q_pos = torch.arange(sq, device=device) + int(q_offset)
    k_pos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    return mask


def attention(q, k, v, *, causal: bool = True, window: int = 0,
              scale: Optional[float] = None, q_offset: int = 0):
    """window > 0 -> sliding-window attention of that width; q_offset is
    the absolute position of q[0]."""
    return attention_fwd(q, k, v, causal=causal, window=window, scale=scale,
                         q_offset=q_offset)[0]
