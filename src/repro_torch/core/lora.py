"""LoRA adapter trees and the per-layer rank policy (the paper's C2).

Port of src/repro/core/lora.py (``init_adapters``, ``effective_ranks``,
``rank_masks_for_group``, ``scales_for_group``, ``mask_adapters``).  Adapters are allocated at the
maximum rank (r_others); an adapter's effective rank is a multiplicative
mask that zeroes A columns / B rows past it, so heterogeneous ranks are
data and every pool row has the same shape.

Tree layout: {group: {target: {"A": (Lg, [N,] d_in, r_max),
                                "B": (Lg, [N,] r_max, d_out)}}}
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import LoRAConfig
from repro_torch.models.model import Model

Params = Dict[str, Any]


def init_adapters(model: Model, generator: torch.Generator, *,
                  num_clients: int = 0, dtype=torch.float32) -> Params:
    """A ~ N(0, 1/r), B = 0 (adapter starts as identity) at max rank,
    drawn from `generator` on the CPU and moved to the model's device."""
    r = model.arch.lora.r_others
    tree: Params = {}
    for gname, targets in model.adapter_spec().items():
        lg = model.group_by_name[gname].size
        lead = (lg, num_clients) if num_clients else (lg,)
        tree[gname] = {}
        for tname, (din, dout) in targets.items():
            a = torch.randn(lead + (din, r), generator=generator) \
                * (1.0 / r) ** 0.5
            tree[gname][tname] = {
                "A": a.to(dtype).to(model.device),
                "B": torch.zeros(lead + (r, dout), dtype=dtype,
                                 device=model.device)}
    return tree


def effective_ranks(flat_layers: int, cuts, lora: LoRAConfig, r_cut=None):
    """cuts ([N,]) int -> ranks ([N,] M) int32, on cuts' device.

    Layer m-1 is the client-side cut layer (rank r_cut); with two_side_cut
    layer m (the first server layer) is reduced too.  r_cut: optional
    per-client ([N,]) rank-at-cut override of LoRAConfig.r_cut."""
    cuts = torch.as_tensor(cuts)
    layers = torch.arange(flat_layers, device=cuts.device)
    c = cuts[..., None]
    is_cut = layers == c - 1
    if lora.two_side_cut:
        is_cut = is_cut | (layers == c)
    rc = torch.as_tensor(lora.r_cut if r_cut is None else r_cut,
                         dtype=torch.int32, device=cuts.device)
    if rc.dim():
        rc = rc[..., None]
    others = torch.full(is_cut.shape, lora.r_others, dtype=torch.int32,
                        device=cuts.device)
    return torch.where(is_cut, rc, others)


def rank_masks_for_group(model: Model, gname: str, ranks) -> torch.Tensor:
    """ranks ([N,] M) -> (Lg, [N,] r_max) {0,1} float column mask."""
    g = model.group_by_name[gname]
    ranks = torch.as_tensor(ranks, device=model.device)
    ids = torch.as_tensor(g.layer_ids, device=model.device)
    sub = torch.movedim(ranks.index_select(-1, ids), -1, 0)   # (Lg, [N])
    iota = torch.arange(model.arch.lora.r_others, device=model.device)
    return (iota < sub[..., None]).float().contiguous()


def scales_for_group(model: Model, gname: str, ranks) -> torch.Tensor:
    """LoRA scaling alpha / r_eff per (layer[, client]) -> (Lg, [N])."""
    g = model.group_by_name[gname]
    ranks = torch.as_tensor(ranks, device=model.device)
    ids = torch.as_tensor(g.layer_ids, device=model.device)
    sub = torch.movedim(ranks.index_select(-1, ids), -1, 0).float()
    return (model.arch.lora.alpha / torch.clamp(sub, min=1.0)).contiguous()


def mask_adapters(model: Model, adapters: Params, ranks) -> Params:
    """Attach rank masks and scales: the apply-ready tree
    {group:{target:{"A" masked, "B" masked, "scale"}}}."""
    out: Params = {}
    for gname, targets in adapters.items():
        cmask = rank_masks_for_group(model, gname, ranks)    # (Lg,[N],r)
        scale = scales_for_group(model, gname, ranks)        # (Lg,[N])
        out[gname] = {}
        for tname, ad in targets.items():
            out[gname][tname] = {
                "A": ad["A"] * cmask[..., None, :].to(ad["A"].dtype),
                "B": ad["B"] * cmask[..., :, None].to(ad["B"].dtype),
                "scale": scale,
            }
    return out
