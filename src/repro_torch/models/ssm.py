"""Mamba2 (SSD) block: init and application in train, prefill and
decode mode.

Port of src/repro/models/ssm.py.  Block structure (arXiv:2405.21060):

  u -> norm -> in_proj -> [x (d_inner) | z (d_inner) | B (G*N) | C (G*N) | dt (H)]
  (x|B|C) -> causal depthwise conv (width W) -> silu
  dt -> softplus(dt + dt_bias);  A = -exp(A_log)  (per head)
  y = SSD_scan(x, dt, A, B, C) + D * x          (heads H = d_inner / P)
  y -> gated RMSNorm (y * silu(z)) -> out_proj -> residual

LoRA targets: "ssm_in" (in_proj) and "ssm_out" (out_proj).

Tensor parallelism (train mode, under a MeshShard's policy): a "model"
rank runs its contiguous block of the heads.  ``param_specs`` splits
A_log, D and dt_bias by heads and out_proj's rows (d_inner follows the
heads), but in_proj's columns and the conv's channels in contiguous
blocks that do not fall on head boundaries ([x | z | B | C | dt] and
[x | B | C]), so the layer gathers in_proj, conv_w and conv_b over
"model" (exactly; recomputed under remat, as the FSDP gather) and takes
its heads' x, z and dt columns and the B and C columns (one group,
which every head reads).  The gated RMSNorm's sum of squares
runs over all of d_inner: it is summed over the ranks
(``ShardingPolicy.sum_tp``).  out_proj is row-parallel and its partial
sums leave through reduce_from_tp.  Under sequence parallelism (off by
default for the SSM and hybrid families, as in the reference; on when
asked) the layer gathers the normed sequence first and reduce-scatters
its output back to the rank's block: the SSD scan needs the contiguous
sequence.

Serving on a MeshShard's cache blocks (``runtime.sharding.local_cache``):
the state's heads block is the rank's TP heads, so the state steps in
place; the conv window is split by ``cache_specs`` into contiguous
channel blocks, which are not the rank's columns (its heads' x channels
plus all of B and C).  A decode step therefore gathers the small window
and the new token's x channels over "model" in one collective, runs the
conv over its own columns and writes back its block of the shifted
window; a prefill gathers the x channels of the prompt's last W - 1
positions for the same block.  A channel count that "model" does not
divide leaves the window whole on every rank.

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

from repro_torch import roadmap
from repro_torch.config import ModelConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models import common
from repro_torch.models.common import NO_SHARDING, ShardingPolicy, apply_norm
from repro_torch.models.transformer import (_ad, adapter_blocks as
                                            _attn_blocks, lora_apply)

Params = Dict[str, Any]


def conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def in_proj_dim(cfg: ModelConfig) -> int:
    return 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads


def init_ssm(gen: torch.Generator, cfg: ModelConfig, n_layers: int, *,
             dtype, place=common.whole) -> Params:
    """Random weights from `gen` (the reference's init scales; a torch
    generator gives other numbers than a JAX key).  place: as in
    ``transformer.init_attention``."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    lead = (n_layers,)
    p = {"norm1": common.init_norm(d, bias=False, dtype=dtype, lead=lead,
                                   place=place)}
    p["in_proj"] = place("in_proj", common.dense_init(
        gen, d, in_proj_dim(cfg), dtype, lead=lead))
    p["conv_w"] = place("conv_w", (torch.randn(
        (n_layers, cfg.ssm_conv_width, conv_channels(cfg)), generator=gen,
        device=gen.device) * 0.1).to(dtype))
    p["conv_b"] = place("conv_b", torch.zeros((n_layers, conv_channels(cfg)),
                                              dtype=dtype))
    # A = -exp(0) = -1 and dt bias 0.5 at init, as in the reference
    p["A_log"] = place("A_log", torch.zeros((n_layers, h), dtype=dtype))
    p["D"] = place("D", torch.ones((n_layers, h), dtype=dtype))
    p["dt_bias"] = place("dt_bias", torch.full((n_layers, h), 0.5,
                                               dtype=dtype))
    p["gnorm"] = common.init_norm(di, bias=False, dtype=dtype, lead=lead,
                                  place=place)
    p["out_proj"] = place("out_proj", common.dense_init(gen, di, d, dtype,
                                                        lead=lead))
    return p


def _split_proj(proj, di: int, gn: int):
    """[x (di) | z (di) | B (gn) | C (gn) | dt] of a projection (all of
    them, or a "model" rank's heads and groups)."""
    x = proj[..., :di]
    z = proj[..., di:2 * di]
    b = proj[..., 2 * di:2 * di + gn]
    c = proj[..., 2 * di + gn:2 * di + 2 * gn]
    dt = proj[..., 2 * di + 2 * gn:]
    return x, z, b, c, dt


def _tp_columns(cfg: ModelConfig, h_lo: int, hl: int, device):
    """in_proj's columns and the conv's channels of heads [h_lo, h_lo + hl)
    and of B and C (one group, which every head reads), in the layouts'
    order."""
    if cfg.ssm_groups != 1:
        raise NotImplementedError(
            f"{cfg.ssm_groups} SSM groups: tensor-parallel SSM layers take "
            f"one B/C group ({roadmap.PARAM_SHARDING})")
    ph, di = cfg.ssm_head_dim, cfg.d_inner
    x = torch.arange(h_lo * ph, (h_lo + hl) * ph, device=device)
    bc = torch.arange(2 * cfg.ssm_state, device=device)
    dt = torch.arange(h_lo, h_lo + hl, device=device)
    cols = torch.cat([x, di + x, 2 * di + bc, 2 * di + bc.numel() + dt])
    chans = torch.cat([x, di + bc])
    return cols, chans


def adapter_blocks(cfg: ModelConfig, p: Params,
                   policy: ShardingPolicy = NO_SHARDING) -> Dict[str, Any]:
    """``transformer.adapter_blocks`` of a layer that may hold SSM
    leaves: where A_log holds a "model" block of the heads, ssm_in's B
    takes in_proj's columns of those heads and of B and C
    (``_tp_columns``) and ssm_out's A out_proj's rows of the heads."""
    out = _attn_blocks(cfg, p, policy)
    if "A_log" not in p or policy.adapters_at_blocks:
        return out
    hl = p["A_log"].shape[-1]
    h_lo = policy.block(cfg.ssm_heads, hl)
    if h_lo is not None:
        ph = cfg.ssm_head_dim
        out["ssm_in"] = (_tp_columns(cfg, h_lo, hl, p["A_log"].device)[0],
                         None)
        out["ssm_out"] = (None, (h_lo * ph, hl * ph))
    return out


def _whole(policy: ShardingPolicy, w, full: int):
    """A leaf whose last dim "model" split (param_specs' contiguous
    blocks), whole on every rank; as it is when whole already."""
    return w if w.shape[-1] == full else policy.tp_gather(w, -1)


def _whole_window(policy: ShardingPolicy, cfg: ModelConfig, conv, x, bmat,
                  cmat):
    """(the whole conv window, the whole pre-conv rows [x | B | C]) on
    every "model" rank from this rank's: its block of the window's
    channels (``cache_specs``; None or whole: nothing to gather) and its
    heads' x channels of the rows (B and C are every rank's), gathered
    in one collective, exactly."""
    parts = [(x, -1)]
    split = conv is not None and conv.shape[-1] != conv_channels(cfg)
    if split:
        parts.append((conv, -1))
    got = policy.fill(parts, ("model",))
    return (got[1] if split else conv,
            torch.cat([got[0], bmat, cmat], dim=-1))


def _window_block(policy: ShardingPolicy, cfg: ModelConfig, window, like):
    """This rank's block of a whole conv window, shaped as its cache leaf
    `like` (the whole window where ``cache_specs`` leaves it whole)."""
    n = like.shape[-1]
    return (window if n == conv_channels(cfg)
            else policy.keep(window, -1, n, ("model",)))


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
              mode: str, cache: Optional[Params] = None,
              policy: ShardingPolicy = NO_SHARDING):
    """One SSD sub-block.  u ([N,]B,S,d) -> (out, new_cache).

    mode "decode" (S = 1) steps `cache` {"conv", "state"} by one token;
    otherwise the full sequence runs through the chunked scan, and with a
    cache (prefill) the new cache holds the last W - 1 pre-conv
    activations and the final state.  The new cache is returned, not
    written: the caller stores it.

    policy: when A_log holds a "model" block of the heads (a MeshShard's),
    the layer runs those heads (the module docstring):
    the input enters through ``policy.enter`` (copy_to_tp; under a
    forced sequence parallelism u is the rank's sequence block, normed
    there and gathered, since the SSD scan needs the contiguous
    sequence), in_proj and the conv are gathered whole and narrowed to
    the heads' columns (the adapter's B to the same columns), the gated
    norm's sum of squares is summed over the ranks and out_proj's
    partial sums leave through ``policy.leave`` (reduce_from_tp, or the
    reduce-scatter back to the block).  The cache then holds the rank's
    blocks (``cache_specs``): the state of its heads and a contiguous
    channel block of the conv window (``_whole_window``)."""
    h, ph = cfg.ssm_heads, cfg.ssm_head_dim
    g, ns, di = cfg.ssm_groups, cfg.ssm_state, cfg.d_inner
    gn = g * ns
    hl = p["A_log"].shape[-1]
    h_lo = policy.block(h, hl)
    ad_in = _ad(adapters, "ssm_in")
    w_in, conv_w, conv_b = p["in_proj"], p["conv_w"], p["conv_b"]

    y = apply_norm(p["norm1"], u, kind=cfg.norm, eps=cfg.norm_eps)
    if h_lo is not None:
        y = policy.enter(y, True)
        cols, chans = _tp_columns(cfg, h_lo, hl, y.device)
        w_in = _whole(policy, w_in, in_proj_dim(cfg)).index_select(-1, cols)
        conv_w = _whole(policy, conv_w, conv_channels(cfg)).index_select(
            -1, chans)
        conv_b = _whole(policy, conv_b, conv_channels(cfg)).index_select(
            -1, chans)
        h, di = hl, hl * ph
    blocks = adapter_blocks(cfg, p, policy)
    proj = lora_apply(y, w_in, ad_in, block=blocks.get("ssm_in"))
    x, z, bmat, cmat, dt = _split_proj(proj, di, gn)
    xbc = torch.cat([x, bmat, cmat], dim=-1)
    width = conv_w.shape[0]
    new_cache = None
    if mode == "decode":
        if cache is None or u.shape[-2] != 1:
            raise ValueError("ssm_apply decode takes one token and a cache")
        # rolling conv window: shift in the new pre-conv activation
        conv, new_xbc = cache["conv"], xbc
        if h_lo is not None:
            conv, new_xbc = _whole_window(policy, cfg, conv, x, bmat, cmat)
        wdt = torch.promote_types(conv.dtype, xbc.dtype)
        win = torch.cat([conv.to(wdt), new_xbc.to(wdt)], dim=-2)
        new_conv = win[..., 1:, :]
        if h_lo is not None:
            new_conv = _window_block(policy, cfg, new_conv, cache["conv"])
            win = win.index_select(-1, chans)
        conv_out = torch.einsum("...wc,wc->...c", win,
                                conv_w.to(win.dtype))
        conv_out = conv_out + conv_b.to(conv_out.dtype)
        conv_out = F.silu(conv_out)[..., None, :]              # (...,1,C)
    else:
        conv_out = F.silu(_causal_conv(xbc, conv_w, conv_b))
        if cache is not None:
            # the last W-1 pre-conv activations, zeros before the prompt
            keep = xbc[..., -(width - 1):, :]
            if h_lo is not None:
                _, keep = _whole_window(policy, cfg, None,
                                        *(t[..., -(width - 1):, :]
                                          for t in (x, bmat, cmat)))
            short = width - 1 - keep.shape[-2]
            new_conv = F.pad(keep, (0, 0, short, 0)) if short else keep
            if h_lo is not None:
                new_conv = _window_block(policy, cfg, new_conv,
                                         cache["conv"])

    lead, s = y.shape[:-2], y.shape[-2]
    xh = conv_out[..., :di].reshape(lead + (s, h, ph))
    bh = conv_out[..., di:di + gn].reshape(lead + (s, g, ns))
    ch = conv_out[..., di + gn:].reshape(lead + (s, g, ns))
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

    # gated RMSNorm over all of d_inner, then the output projection: under
    # TP each rank's heads' share of the mean square is summed over the
    # ranks (the factor is 1.0 unsharded: apply_norm's arithmetic)
    gated = yflat2 * F.silu(z.to(yflat2.dtype))
    lo = (h_lo or 0) * ph
    gf = gated.float()
    var = policy.sum_tp(torch.mean(gf * gf, dim=-1, keepdim=True)
                        * (di / cfg.d_inner))
    gated = (gf * torch.rsqrt(var + cfg.norm_eps)
             * p["gnorm"]["scale"].narrow(-1, lo, di).float()
             ).to(gated.dtype)
    w_out = p["out_proj"]
    if w_out.shape[-2] != di:
        w_out = w_out.narrow(-2, lo, di)
    out = lora_apply(gated, w_out, _ad(adapters, "ssm_out"),
                     block=blocks.get("ssm_out"))
    return policy.leave(out, h_lo is not None), new_cache


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
