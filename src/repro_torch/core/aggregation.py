"""Client-side LoRA FedAvg (paper b1-b4), mask- and membership-aware.

Port of src/repro/core/aggregation.py.  For (group g, target t, layer l):

    agg[l] = sum_i mu_i(l) * X[i, l] / sum_i mu_i(l)
    mu_i(l) = w_i * active_i * client_mask_i(l) / steps_i
              * (1 + staleness_i)^-power

so only clients that are active this round and own layer l contribute.
`steps_i` (the local-steps engine's effective step counts) divides the
weight FedNova-style; `staleness_i` (the async engine's version lag)
discounts it FedBuff-style.  After aggregation every client's row is
refreshed: owned layers get the aggregate (paper b3), dormant rows
mirror the server adapters (b4); under async only the buffered clients
receive the broadcast.

With per-client effective ranks (the co-controller's rank_cut), each
rank column is averaged only over the clients whose rank covers it.  With
edge groups (``num_edges > 1``) the average runs in two tiers, clients
to edges to the server, which telescopes to the flat average.  Under a
split cohort (runtime.sharding.Cohort) each sum over clients is a
rank-local partial sum followed by one all-reduce SUM, and
``broadcast_after_agg`` writes the aggregate into the rank's own rows.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import lora as lora_lib
from repro_torch.core.split import client_layer_masks, group_masks
from repro_torch.models.model import Model
from repro_torch.runtime.sharding import UNSHARDED, Cohort
from repro_torch.tree import tree_map

Params = Dict[str, Any]


def staleness_discount(staleness, *, power: float = 0.5):
    """FedBuff's staleness weight (1 + s)^-power in fp32: 1 at s = 0, in
    (0, 1], non-increasing in s; power 0 disables it."""
    s = torch.clamp(torch.as_tensor(staleness, dtype=torch.float32),
                    min=0.0)
    return (1.0 + s) ** torch.tensor(-power, dtype=torch.float32)


def _on(x, dev):
    return torch.as_tensor(x, dtype=torch.float32).to(dev)


def fedavg(model: Model, client_adapters: Params, cuts, weights, active,
           steps=None, staleness=None, staleness_power: float = 0.5,
           ranks=None, edge_assign=None, num_edges: int = 1,
           cohort: Cohort = UNSHARDED) -> Params:
    """Aggregate: returns the per-layer tree without the client axis.

    steps: optional (N,) effective local-step counts (weights divided by
    them); staleness: optional (N,) version lags (weights multiplied by
    staleness_discount).  ranks: optional (N, M) per-client effective
    ranks.  Each rank column is then averaged only over the clients whose
    rank covers it, each column with its own denominator; a column no
    active client owns falls back to the layer average (zeroing it would
    kill the column for good: B = 0 at init gives a zeroed A column no
    gradient).  edge_assign/num_edges: the two-tier mode
    (`_fedavg_two_tier`); num_edges <= 1 or no assignment is the flat
    path verbatim.  cohort: a runtime.sharding.Cohort whose rank holds
    a block of the client axis of every per-client argument; each sum
    over clients is then this rank's partial sum, summed over the ranks
    in one all-reduce, and every rank returns the whole aggregate."""
    dev = model.device
    masks = client_layer_masks(model.num_flat_layers, cuts).to(dev)
    w = _on(weights, dev) * _on(active, dev)
    if steps is not None:
        w = w / torch.clamp(_on(steps, dev), min=1.0)
    if staleness is not None:
        w = w * staleness_discount(staleness,
                                   power=staleness_power).to(dev)
    if edge_assign is not None and num_edges > 1:
        return _fedavg_two_tier(model, client_adapters, masks, w,
                                ranks=ranks, edge_assign=edge_assign,
                                num_edges=num_edges, cohort=cohort)
    part: Dict[Any, torch.Tensor] = {}       # this rank's partial sums
    for gname, targets in client_adapters.items():
        g = model.group_by_name[gname]
        ids = torch.as_tensor(g.layer_ids, device=dev)
        mu = masks.index_select(1, ids).T * w                 # (Lg, N)
        part[gname] = mu.sum(1)
        if ranks is not None:
            cmask = lora_lib.rank_masks_for_group(model, gname, ranks)
            mu_col = mu[..., None] * cmask                    # (Lg, N, r)
            part[gname, "col"] = mu_col.sum(1)                # (Lg, r)
        for tname, ad in targets.items():
            for k in ("A", "B"):
                part[gname, tname, k] = torch.einsum("ln,ln...->l...", mu,
                                                     ad[k])
            if ranks is not None:
                part[gname, tname, "cA"] = torch.einsum(
                    "lnr,lndr->ldr", mu_col, ad["A"])
                part[gname, tname, "cB"] = torch.einsum(
                    "lnr,lnrd->lrd", mu_col, ad["B"])
    tot = cohort.sum_dict(part)
    out: Params = {}
    for gname, targets in client_adapters.items():
        denom = torch.clamp(tot[gname], min=1e-9)[:, None, None]
        if ranks is not None:
            col_sum = tot[gname, "col"]
            col_denom = torch.clamp(col_sum, min=1e-9)
            owned = col_sum > 1e-9
        out[gname] = {}
        for tname in targets:
            agg_a = tot[gname, tname, "A"] / denom
            agg_b = tot[gname, tname, "B"] / denom
            if ranks is not None:
                col_a = tot[gname, tname, "cA"] / col_denom[:, None, :]
                col_b = tot[gname, tname, "cB"] / col_denom[:, :, None]
                agg_a = torch.where(owned[:, None, :], col_a, agg_a)
                agg_b = torch.where(owned[:, :, None], col_b, agg_b)
            out[gname][tname] = {"A": agg_a, "B": agg_b}
    return out


def _fedavg_two_tier(model: Model, client_adapters: Params, masks, w, *,
                     ranks, edge_assign, num_edges: int,
                     cohort: Cohort = UNSHARDED) -> Params:
    """Hierarchical aggregation: clients -> edge groups -> server.

    Tier 1 averages within each edge with the flat path's weights mu;
    tier 2 averages the edge aggregates weighted by each edge's mass
    denom_e = sum_{n in e} mu_n.  An edge with no active owner of a layer
    has denom_e ~ 0 and drops out; a layer nobody owns keeps its previous
    value as in the flat path.  The math telescopes to the flat average;
    the point is the system: the server ingests E adapter streams instead
    of N, which the speed model prices in the adapter-sync phase.  The
    edge sums over clients are partial sums under a cohort (fedavg)."""
    dev = model.device
    ea = torch.as_tensor(edge_assign).long() % num_edges
    onehot = torch.nn.functional.one_hot(ea, num_edges).float().to(dev)
    part: Dict[Any, torch.Tensor] = {}
    for gname, targets in client_adapters.items():
        g = model.group_by_name[gname]
        ids = torch.as_tensor(g.layer_ids, device=dev)
        mu = masks.index_select(1, ids).T * w                 # (Lg, N)
        mu_e = torch.einsum("ln,ne->lne", mu, onehot)         # (Lg, N, E)
        part[gname] = mu_e.sum(1)                             # (Lg, E)
        if ranks is not None:
            cmask = lora_lib.rank_masks_for_group(model, gname, ranks)
            mu_col = mu[..., None] * cmask                    # (Lg, N, r)
            col_e = torch.einsum("lnr,ne->lner", mu_col, onehot)
            part[gname, "col"] = col_e.sum(1)                 # (Lg, E, r)
        for tname, ad in targets.items():
            for k in ("A", "B"):
                part[gname, tname, k] = torch.einsum(
                    "lne,ln...->le...", mu_e, ad[k])          # (Lg,E,..)
            if ranks is not None:
                part[gname, tname, "cA"] = torch.einsum(
                    "lner,lndr->ledr", col_e, ad["A"])
                part[gname, tname, "cB"] = torch.einsum(
                    "lner,lnrd->lerd", col_e, ad["B"])
    tot = cohort.sum_dict(part)
    out: Params = {}
    for gname, targets in client_adapters.items():
        denom_e = tot[gname]
        safe_e = torch.clamp(denom_e, min=1e-9)
        denom = torch.clamp(denom_e.sum(1), min=1e-9)         # (Lg,)
        if ranks is not None:
            col_sum_e = tot[gname, "col"]
            col_safe_e = torch.clamp(col_sum_e, min=1e-9)
            col_sum = col_sum_e.sum(1)                        # (Lg, r)
            col_denom = torch.clamp(col_sum, min=1e-9)
            owned = col_sum > 1e-9
        out[gname] = {}
        for tname in targets:
            tier = {}
            for k in ("A", "B"):
                edge = tot[gname, tname, k] / safe_e[:, :, None, None]
                tier[k] = torch.einsum("le,le...->l...", denom_e, edge) \
                    / denom[:, None, None]
            if ranks is not None:
                ecol_a = tot[gname, tname, "cA"] / col_safe_e[:, :, None, :]
                ecol_b = tot[gname, tname, "cB"] / col_safe_e[:, :, :, None]
                col_a = torch.einsum("ler,ledr->ldr", col_sum_e, ecol_a) \
                    / col_denom[:, None, :]
                col_b = torch.einsum("ler,lerd->lrd", col_sum_e, ecol_b) \
                    / col_denom[:, :, None]
                tier["A"] = torch.where(owned[:, None, :], col_a, tier["A"])
                tier["B"] = torch.where(owned[:, :, None], col_b, tier["B"])
            out[gname][tname] = tier
    return out


def broadcast_after_agg(model: Model, client_adapters: Params,
                        aggregated: Params, server_adapters: Params,
                        cuts, recv_mask=None) -> Params:
    """Refresh client rows: owned layers <- aggregate (b3); dormant
    layers <- the server adapters (b4).  recv_mask: optional (N,) {0, 1},
    the clients that receive the broadcast (the async engine refreshes
    only the buffered ones; the others keep their rows)."""
    masks = client_layer_masks(model.num_flat_layers, cuts)
    gmasks = group_masks(model, masks.to(model.device))
    rm = (None if recv_mask is None
          else _on(recv_mask, model.device).reshape(1, -1, 1, 1) > 0)
    out: Params = {}
    for gname, targets in client_adapters.items():
        m = gmasks[gname]                                     # (Lg,N,1,1)
        out[gname] = {}
        for tname, ad in targets.items():
            new = {k: m * aggregated[gname][tname][k][:, None]
                   + (1 - m) * server_adapters[gname][tname][k][:, None]
                   for k in ("A", "B")}
            if rm is not None:
                new = {k: torch.where(rm, new[k], ad[k]) for k in new}
            out[gname][tname] = new
    return out


def adapter_delta(new: Params, old: Params) -> Params:
    return tree_map(lambda a, b: a - b, new, old)


def apply_delta(base: Params, delta: Params) -> Params:
    return tree_map(lambda a, b: a + b, base, delta)
