"""Shared model primitives: initializers, norms, activations, the
LoRA-aware dense projection and the loss.

Port of src/repro/models/common.py for one card: no sharding policy (there
is no mesh).
Parameters are nested dicts of tensors with the reference's names and
layouts (``W`` is (d_in, d_out), per-group stacks keep the leading layer
axis), so a JAX tree converted by ``repro_torch.bridge`` drops in as is.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.lora_matmul import ops as lora_ops

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers (drawn on the CPU from an explicit generator, so one seed
# gives the same weights on every device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, *, lead=()) -> torch.Tensor:
    scale = (1.0 / d_in) ** 0.5
    return (torch.randn(tuple(lead) + (d_in, d_out), generator=gen)
            * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen) * 0.02).to(dtype)


def init_norm(d: int, *, bias: bool, dtype=torch.float32, lead=()) -> Params:
    p = {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype)}
    if bias:
        p["bias"] = torch.zeros(tuple(lead) + (d,), dtype=dtype)
    return p


# ---------------------------------------------------------------------------
# Norms


def apply_norm(p: Params, x, *, kind: str, eps: float):
    """RMSNorm / LayerNorm in fp32 with rsqrt(var + eps), cast back."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations (jax.nn.gelu defaults to the tanh approximation)


def activate(x, gate, kind: str):
    """Apply activation. `gate` is the gate branch for GLU variants (or None)."""
    if kind == "swiglu":
        return F.silu(gate) * x
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * x
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    raise ValueError(kind)


def is_glu(kind: str) -> bool:
    return kind in ("swiglu", "geglu")


# ---------------------------------------------------------------------------
# LoRA-aware dense application
#
# adapter = {"A": (d_in, r), "B": (r, d_out), "scale": scalar} or None.


def lora_dense(x, w, b=None, adapter=None):
    """y = x @ W (+ b) (+ scale * (x @ A) @ B) through the fused LoRA
    kernel (its plain version on the CPU).  Base weights are frozen
    (LoRA fine-tuning), so W gets no gradient and dW is never computed."""
    if adapter is not None:
        y = lora_ops.lora_matmul(x, w, adapter["A"], adapter["B"],
                                 adapter["scale"])
    else:
        y = x @ w
    if b is not None:
        y = y + b
    return y


# ---------------------------------------------------------------------------
# Rotary position embeddings (plain elementwise torch, as the reference's
# are jnp outside any kernel)


def rope_angles(positions, head_dim: int, theta: float):
    """positions: (...,) int -> cos/sin of shape (..., head_dim // 2), fp32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., T, H, hd); cos/sin: (..., T, hd//2) broadcast over heads.
    The half-split layout (not interleaved), cast back to x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Loss


def cross_entropy(logits, labels, mask=None):
    """Mean next-token CE over (masked) positions, in fp32."""
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) - torch.gather(
        lf, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def token_accuracy(logits, labels, mask=None):
    hit = (torch.argmax(logits, dim=-1) == labels.long()).float()
    if mask is None:
        return hit.mean()
    mask = mask.float()
    return (hit * mask).sum() / torch.clamp(mask.sum(), min=1.0)
