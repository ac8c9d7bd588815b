"""The split boundary (paper C1) as a soft, mask-based structure.

Port of src/repro/core/split.py.  A client with cut m owns flat layers
[0, m); the server owns [m, M).  The effective adapter used at layer l for
client i's batch is

    eff[i, l] = client_mask[i, l] ? client_adapters[i, l]
                                  : server_adapters[l]

computed with masks over stacked trees, so heterogeneous per-client cuts
and adaptive movement are data.  The cuts are host data in the port (the
round engine keeps them on the CPU); the masks built from them are moved
to the model's device.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import lora as lora_lib
from repro_torch.models.model import Model
from repro_torch.runtime.sharding import UNSHARDED, Cohort

Params = Dict[str, Any]


def client_layer_masks(flat_layers: int, cuts):
    """cuts (N,) -> (N, M) float32 {1 = client-side, 0 = server-side}."""
    cuts = torch.as_tensor(cuts)
    layers = torch.arange(flat_layers, device=cuts.device)
    return (layers[None, :] < cuts[:, None]).float()


def group_masks(model: Model, masks):
    """(N, M) -> {group: (Lg, N, 1, 1)} broadcast-ready masks."""
    out = {}
    for g in model.groups:
        ids = torch.as_tensor(g.layer_ids, device=masks.device)
        sub = masks.index_select(1, ids)                      # (N, Lg)
        out[g.name] = sub.T[..., None, None].contiguous()
    return out


def _grad_scaled(x, scale):
    """Per-client gradient scaling on axis 1, forward-preserving:
    a*x + (1-a)*x.detach() has gradient a*g and the value of x up to
    rounding; at a == 1 it is x bit for bit (1*x = x, 0*x is a zero of
    x's sign, and x + that zero = x), so the gradient is g bit for bit
    too."""
    a = torch.as_tensor(scale, dtype=x.dtype).to(x.device)
    a = a.reshape((1, -1) + (1,) * (x.dim() - 2))
    return a * x + (1.0 - a) * x.detach()


def merge_adapters(model: Model, client_adapters: Params,
                   server_adapters: Params, cuts, rank_cut=None,
                   server_scale=None) -> Params:
    """The apply-ready effective adapter tree for a SplitFT step.

    client_adapters: rank-max tree with client axis (Lg, N, din, r);
    server_adapters: the same without the client axis (Lg, din, r).  The
    output leaves carry the client axis and are rank-masked and scaled by
    the per-client rank policy.  rank_cut: optional (N,) per-client
    rank-at-cut (the co-controller's state["rank_cut"], host data like
    the cuts); None keeps LoRAConfig.r_cut.

    server_scale: optional (N,) per-client gradient scale on the SERVER
    adapters' contribution (forward unchanged, see _grad_scaled).  The
    local-steps and async engines pass 1/K_i, so a client running K_i
    inner steps pushes the same gradient mass into the shared server
    adapters as a one-step client; all ones is the plain gradient bit
    for bit."""
    masks = client_layer_masks(model.num_flat_layers, cuts)
    gmasks = group_masks(model, masks.to(model.device))
    ranks = lora_lib.effective_ranks(model.num_flat_layers, cuts,
                                     model.arch.lora, r_cut=rank_cut)
    merged: Params = {}
    for gname, targets in client_adapters.items():
        m = gmasks[gname]                                     # (Lg,N,1,1)
        merged[gname] = {}
        for tname, ad in targets.items():
            srv = server_adapters[gname][tname]
            srv_a, srv_b = srv["A"][:, None], srv["B"][:, None]
            if server_scale is not None:
                srv_a = _grad_scaled(srv_a, server_scale)
                srv_b = _grad_scaled(srv_b, server_scale)
            merged[gname][tname] = {
                "A": m * ad["A"] + (1.0 - m) * srv_a,
                "B": m * ad["B"] + (1.0 - m) * srv_b,
            }
    return lora_lib.mask_adapters(model, merged, ranks)


def serve_adapters(model: Model, client_adapters: Params,
                   server_adapters: Params, cuts, weights,
                   rank_cut=None, cohort: Cohort = UNSHARDED) -> Params:
    """Global-model adapters for evaluation and serving (paper b4).

    Per flat layer: the FedAvg-weighted mix of the client copies (for
    clients that own the layer) and the server copy (for the rest).  The
    serving rank of a layer is the weighted mean rank, truncated to an
    integer in fp32 as in the reference.  rank_cut: optional (N,)
    per-client rank-at-cut (see merge_adapters).  cohort: a
    runtime.sharding.Cohort whose rank holds a block of the client axis
    of the client adapters, cuts, weights and rank_cut; each sum over
    clients is then summed over the ranks, in one all-reduce."""
    dev = model.device
    masks = client_layer_masks(model.num_flat_layers, cuts).to(dev)
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    w = w / torch.clamp(cohort.sum(w.sum()), min=1e-9)
    ranks = lora_lib.effective_ranks(model.num_flat_layers, cuts,
                                     model.arch.lora, r_cut=rank_cut)
    part = {"ranks": (w[:, None] * ranks.to(dev)).sum(0)}      # (M,)
    for gname, targets in client_adapters.items():
        g = model.group_by_name[gname]
        ids = torch.as_tensor(g.layer_ids, device=dev)
        m = masks.index_select(1, ids).T                      # (Lg, N)
        wm = m * w[None, :]                                   # client share
        part[gname] = ((1.0 - m) * w[None, :]).sum(1)         # server share
        for tname, ad in targets.items():
            for k in ("A", "B"):
                part[gname, tname, k] = torch.einsum("ln,ln...->l...", wm,
                                                     ad[k])
    part = cohort.sum_dict(part)
    out: Params = {}
    for gname, targets in client_adapters.items():
        ws = part[gname][:, None, None]
        out[gname] = {}
        for tname in targets:
            srv = server_adapters[gname][tname]
            out[gname][tname] = {k: part[gname, tname, k] + ws * srv[k]
                                 for k in ("A", "B")}
    return lora_lib.mask_adapters(model, out,
                                  part["ranks"].to(torch.int32))
