"""Mamba2 (SSD) block: init and application in train, prefill and
decode mode.

Port of src/repro/models/ssm.py.  Block structure (arXiv:2405.21060):

  u -> norm -> in_proj -> [x (d_inner) | z (d_inner) | B (G*N) | C (G*N) | dt (H)]
  (x|B|C) -> causal depthwise conv (width W) -> silu
  dt -> softplus(dt + dt_bias);  A = -exp(A_log)  (per head)
  y = SSD_scan(x, dt, A, B, C) + D * x          (heads H = d_inner / P)
  y -> gated RMSNorm (y * silu(z)) -> out_proj -> residual

LoRA targets: "ssm_in" (in_proj) and "ssm_out" (out_proj).

Decode carries two cache pieces per layer, as in the reference:
  conv:  ([N,]B, W-1, d_conv_ch) rolling window of pre-conv activations
  state: ([N,]B, H, P, N_state) SSD recurrent state, fp32

Train mode runs the SSD scan through the hand-written kernel
(``kernels.ssd_scan.ops``; its plain version on the CPU); prefill with a
cache runs the same kernel, which then also returns the state after the
last chunk.  A decode step is the one-token recurrence
(``ssd_decode_step``, plain torch as in the reference, which has no
kernel for it).

One difference from the reference: a prefill of fewer than W - 1 tokens
keeps its conv window left-padded with zeros (the causal conv's own
padding).  The reference keeps ``xbc[..., -(W-1):, :]``, which has only
s rows then, and writes them at the start of the window, so its decode
after such a prompt differs from its own full forward.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import common
from repro_torch.models.common import apply_norm
from repro_torch.models.transformer import _ad, lora_apply

Params = Dict[str, Any]


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def in_proj_dim(cfg: ModelConfig) -> int:
    return 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads


def init_ssm(gen: torch.Generator, cfg: ModelConfig, n_layers: int, *,
             dtype) -> Params:
    """Random weights from `gen` (the reference's init scales; a torch
    generator gives other numbers than a JAX key)."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    lead = (n_layers,)
    return {
        "norm1": common.init_norm(d, bias=False, dtype=dtype, lead=lead),
        "in_proj": common.dense_init(gen, d, in_proj_dim(cfg), dtype,
                                     lead=lead),
        "conv_w": (torch.randn((n_layers, cfg.ssm_conv_width,
                                conv_channels(cfg)), generator=gen,
                               device=gen.device) * 0.1).to(dtype),
        "conv_b": torch.zeros((n_layers, conv_channels(cfg)), dtype=dtype),
        # A = -exp(0) = -1 and dt bias 0.5 at init, as in the reference
        "A_log": torch.zeros((n_layers, h), dtype=dtype),
        "D": torch.ones((n_layers, h), dtype=dtype),
        "dt_bias": torch.full((n_layers, h), 0.5, dtype=dtype),
        "gnorm": common.init_norm(di, bias=False, dtype=dtype, lead=lead),
        "out_proj": common.dense_init(gen, di, d, dtype, lead=lead),
    }


def _split_proj(cfg: ModelConfig, proj):
    di = cfg.d_inner
    gn = cfg.ssm_groups * cfg.ssm_state
    x = proj[..., :di]
    z = proj[..., di:2 * di]
    b = proj[..., 2 * di:2 * di + gn]
    c = proj[..., 2 * di + gn:2 * di + 2 * gn]
    dt = proj[..., 2 * di + 2 * gn:]
    return x, z, b, c, dt


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over ([N,]B, S, C); w (W, C).  A
    cross-correlation over the left-padded sequence, like the reference's
    lax.conv_general_dilated (outside any kernel there too)."""
    width = w.shape[0]
    lead, s, ch = xbc.shape[:-2], xbc.shape[-2], xbc.shape[-1]
    flat = xbc.reshape(-1, s, ch).transpose(1, 2)            # (M, C, S)
    out = F.conv1d(F.pad(flat, (width - 1, 0)),
                   w.to(flat.dtype).t()[:, None, :], groups=ch)
    out = out.transpose(1, 2) + b.to(out.dtype)
    return out.reshape(lead + (s, ch))


def ssm_apply(p: Params, adapters: Optional[Params], u, *, cfg: ModelConfig,
              mode: str, cache: Optional[Params] = None):
    """One SSD sub-block.  u ([N,]B,S,d) -> (out, new_cache).

    mode "decode" (S = 1) steps `cache` {"conv", "state"} by one token;
    otherwise the full sequence runs through the chunked scan, and with a
    cache (prefill) the new cache holds the last W - 1 pre-conv
    activations and the final state.  The new cache is returned, not
    written: the caller stores it."""
    h, ph = cfg.ssm_heads, cfg.ssm_head_dim
    g, ns, di = cfg.ssm_groups, cfg.ssm_state, cfg.d_inner

    y = apply_norm(p["norm1"], u, kind=cfg.norm, eps=cfg.norm_eps)
    proj = lora_apply(y, p["in_proj"], _ad(adapters, "ssm_in"))
    x, z, bmat, cmat, dt = _split_proj(cfg, proj)
    xbc = torch.cat([x, bmat, cmat], dim=-1)
    width = p["conv_w"].shape[0]
    new_cache = None
    if mode == "decode":
        if cache is None or u.shape[-2] != 1:
            raise ValueError("ssm_apply decode takes one token and a cache")
        # rolling conv window: shift in the new pre-conv activation
        wdt = torch.promote_types(cache["conv"].dtype, xbc.dtype)
        win = torch.cat([cache["conv"].to(wdt), xbc.to(wdt)], dim=-2)
        conv_out = torch.einsum("...wc,wc->...c", win,
                                p["conv_w"].to(win.dtype))
        conv_out = conv_out + p["conv_b"].to(conv_out.dtype)
        conv_out = F.silu(conv_out)[..., None, :]              # (...,1,C)
        new_conv = win[..., 1:, :]
    else:
        conv_out = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
        if cache is not None:
            # the last W-1 pre-conv activations, zeros before the prompt
            keep = xbc[..., -(width - 1):, :]
            short = width - 1 - keep.shape[-2]
            new_conv = F.pad(keep, (0, 0, short, 0)) if short else keep

    lead, s = u.shape[:-2], u.shape[-2]
    xh = conv_out[..., :di].reshape(lead + (s, h, ph))
    bh = conv_out[..., di:di + g * ns].reshape(lead + (s, g, ns))
    ch = conv_out[..., di + g * ns:].reshape(lead + (s, g, ns))
    dtp = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())

    if mode == "decode":
        st = cache["state"]
        yss, new_state = ssd_ref.ssd_decode_step(
            st.reshape((-1, h, ph, ns)), xh[..., 0, :, :].reshape((-1, h, ph)),
            dtp[..., 0, :].reshape((-1, h)), a,
            bh[..., 0, :, :].reshape((-1, g, ns)),
            ch[..., 0, :, :].reshape((-1, g, ns)))
        yss = yss.reshape(lead + (1, h, ph))
        new_cache = {"conv": new_conv, "state": new_state.reshape(st.shape)}
    else:
        chunk = min(cfg.ssm_chunk, s)
        pad = (-s) % chunk

        def padded(t):
            # zero-pad the seq axis (and make the kernel's contiguous
            # layout); dt = 0 there makes the padding a no-op on the state
            f = t.reshape((-1,) + t.shape[len(lead):])
            if pad:
                f = F.pad(f, (0, 0) * (f.dim() - 2) + (0, pad))
            return f.contiguous()

        args = (padded(xh), padded(dtp), a, padded(bh), padded(ch))
        if cache is not None:
            yflat, st = ssd_ops.ssd_scan(*args, chunk=chunk,
                                         return_state=True)
            new_cache = {"conv": new_conv,
                         "state": st.reshape(lead + (h, ph, ns))}
        else:
            yflat = ssd_ops.ssd_scan(*args, chunk=chunk)
        yss = yflat[:, :s].reshape(lead + (s, h, ph))
    yss = yss + p["D"].to(yss.dtype)[:, None] * xh
    yflat2 = yss.reshape(lead + (s, di))

    # gated RMSNorm then output projection
    gated = yflat2 * F.silu(z.to(yflat2.dtype))
    gated = apply_norm(p["gnorm"], gated, kind="rmsnorm", eps=cfg.norm_eps)
    return lora_apply(gated, p["out_proj"], _ad(adapters, "ssm_out")), \
        new_cache


def init_ssm_cache(cfg: ModelConfig, lead: Tuple[int, ...], dtype, *,
                   device=None) -> Params:
    """Per-layer decode cache for one SSM layer (leading dims = [N,]B):
    the conv window in `dtype`, the state in fp32."""
    return {
        "conv": torch.zeros(tuple(lead) + (cfg.ssm_conv_width - 1,
                                           conv_channels(cfg)),
                            dtype=dtype, device=device),
        "state": torch.zeros(tuple(lead) + (cfg.ssm_heads, cfg.ssm_head_dim,
                                            cfg.ssm_state),
                             dtype=torch.float32, device=device),
    }
