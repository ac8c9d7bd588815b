"""Client-side LoRA FedAvg (paper b1-b4), mask- and membership-aware.

Port of src/repro/core/aggregation.py for the flat path.  For (group g,
target t, layer l):

    agg[l] = sum_i mu_i(l) * X[i, l] / sum_i mu_i(l)
    mu_i(l) = w_i * active_i * client_mask_i(l)

so only clients that are active this round and own layer l contribute.
After aggregation every client's row is refreshed: owned layers get the
aggregate (paper b3), dormant rows mirror the server adapters (b4).

With per-client effective ranks (the co-controller's rank_cut), each
rank column is averaged only over the clients whose rank covers it.
Step normalization (local-steps engine), staleness discounts (async) and
two-tier aggregation raise until their slices are ported.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import roadmap
from repro_torch.core import lora as lora_lib
from repro_torch.core.split import client_layer_masks, group_masks
from repro_torch.models.model import Model
from repro_torch.tree import tree_map

Params = Dict[str, Any]

_LATER = roadmap.ENGINE_OPTIONS


def fedavg(model: Model, client_adapters: Params, cuts, weights, active,
           steps=None, staleness=None, staleness_power: float = 0.5,
           ranks=None, edge_assign=None, num_edges: int = 1) -> Params:
    """Aggregate: returns the per-layer tree without the client axis.

    ranks: optional (N, M) per-client effective ranks.  Each rank column
    is then averaged only over the clients whose rank covers it, each
    column with its own denominator; a column no active client owns
    falls back to the layer average (zeroing it would kill the column for
    good: B = 0 at init gives a zeroed A column no gradient)."""
    for name, val in (("steps", steps), ("staleness", staleness),
                      ("edge_assign", edge_assign)):
        if val is not None:
            raise NotImplementedError(
                f"fedavg({name}=...) is not ported yet ({_LATER})")
    if num_edges > 1:
        raise NotImplementedError(
            f"two-tier aggregation is not ported yet ({_LATER})")
    dev = model.device
    masks = client_layer_masks(model.num_flat_layers, cuts).to(dev)
    w = (torch.as_tensor(weights, dtype=torch.float32, device=dev)
         * torch.as_tensor(active, dtype=torch.float32, device=dev))
    out: Params = {}
    for gname, targets in client_adapters.items():
        g = model.group_by_name[gname]
        ids = torch.as_tensor(g.layer_ids, device=dev)
        mu = masks.index_select(1, ids).T * w                 # (Lg, N)
        denom = torch.clamp(mu.sum(1), min=1e-9)[:, None, None]
        if ranks is not None:
            cmask = lora_lib.rank_masks_for_group(model, gname, ranks)
            mu_col = mu[..., None] * cmask                    # (Lg, N, r)
            col_sum = mu_col.sum(1)                           # (Lg, r)
            col_denom = torch.clamp(col_sum, min=1e-9)
            owned = col_sum > 1e-9
        out[gname] = {}
        for tname, ad in targets.items():
            agg_a = torch.einsum("ln,ln...->l...", mu, ad["A"]) / denom
            agg_b = torch.einsum("ln,ln...->l...", mu, ad["B"]) / denom
            if ranks is not None:
                col_a = torch.einsum("lnr,lndr->ldr", mu_col, ad["A"]) \
                    / col_denom[:, None, :]
                col_b = torch.einsum("lnr,lnrd->lrd", mu_col, ad["B"]) \
                    / col_denom[:, :, None]
                agg_a = torch.where(owned[:, None, :], col_a, agg_a)
                agg_b = torch.where(owned[:, :, None], col_b, agg_b)
            out[gname][tname] = {"A": agg_a, "B": agg_b}
    return out


def broadcast_after_agg(model: Model, client_adapters: Params,
                        aggregated: Params, server_adapters: Params,
                        cuts) -> Params:
    """Refresh every client row: owned layers <- aggregate (b3); dormant
    layers <- the server adapters (b4)."""
    masks = client_layer_masks(model.num_flat_layers, cuts)
    gmasks = group_masks(model, masks.to(model.device))
    out: Params = {}
    for gname, targets in client_adapters.items():
        m = gmasks[gname]                                     # (Lg,N,1,1)
        out[gname] = {
            tname: {k: m * aggregated[gname][tname][k][:, None]
                    + (1 - m) * server_adapters[gname][tname][k][:, None]
                    for k in ("A", "B")}
            for tname in targets}
    return out


def adapter_delta(new: Params, old: Params) -> Params:
    return tree_map(lambda a, b: a - b, new, old)


def apply_delta(base: Params, delta: Params) -> Params:
    return tree_map(lambda a, b: a + b, base, delta)
