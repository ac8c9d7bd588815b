"""Client-side LoRA FedAvg (paper b1-b4), mask- and membership-aware.

Port of src/repro/core/aggregation.py for the flat path.  For (group g,
target t, layer l):

    agg[l] = sum_i mu_i(l) * X[i, l] / sum_i mu_i(l)
    mu_i(l) = w_i * active_i * client_mask_i(l)

so only clients that are active this round and own layer l contribute.
After aggregation every client's row is refreshed: owned layers get the
aggregate (paper b3), dormant rows mirror the server adapters (b4).

Step normalization (local-steps engine), staleness discounts (async),
per-rank-column averaging (co-controller) and two-tier aggregation raise
until their slices are ported.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.split import client_layer_masks, group_masks
from repro_torch.models.model import Model
from repro_torch.tree import tree_map

Params = Dict[str, Any]

_LATER = "ROADMAP.md Queue A, item 2"


def fedavg(model: Model, client_adapters: Params, cuts, weights, active,
           steps=None, staleness=None, staleness_power: float = 0.5,
           ranks=None, edge_assign=None, num_edges: int = 1) -> Params:
    """Aggregate: returns the per-layer tree without the client axis."""
    for name, val in (("steps", steps), ("staleness", staleness),
                      ("ranks", ranks), ("edge_assign", edge_assign)):
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
        out[gname] = {
            tname: {k: torch.einsum("ln,ln...->l...", mu, ad[k]) / denom
                    for k in ("A", "B")}
            for tname, ad in targets.items()}
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
