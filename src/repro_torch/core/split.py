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

from repro_torch import roadmap
from repro_torch.core import lora as lora_lib
from repro_torch.models.model import Model

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


def merge_adapters(model: Model, client_adapters: Params,
                   server_adapters: Params, cuts,
                   server_scale=None) -> Params:
    """The apply-ready effective adapter tree for a SplitFT step.

    client_adapters: rank-max tree with client axis (Lg, N, din, r);
    server_adapters: the same without the client axis (Lg, din, r).  The
    output leaves carry the client axis and are rank-masked and scaled by
    the per-client rank policy.  server_scale (the local-steps and async
    engines' 1/K_i server-gradient scale) is not ported yet."""
    if server_scale is not None:
        raise NotImplementedError(
            "server_scale belongs to the local-steps and async engines, "
            f"which are not ported yet ({roadmap.ENGINE_OPTIONS})")
    masks = client_layer_masks(model.num_flat_layers, cuts)
    gmasks = group_masks(model, masks.to(model.device))
    ranks = lora_lib.effective_ranks(model.num_flat_layers, cuts,
                                     model.arch.lora)
    merged: Params = {}
    for gname, targets in client_adapters.items():
        m = gmasks[gname]                                     # (Lg,N,1,1)
        merged[gname] = {}
        for tname, ad in targets.items():
            srv = server_adapters[gname][tname]
            merged[gname][tname] = {
                "A": m * ad["A"] + (1.0 - m) * srv["A"][:, None],
                "B": m * ad["B"] + (1.0 - m) * srv["B"][:, None],
            }
    return lora_lib.mask_adapters(model, merged, ranks)


def serve_adapters(model: Model, client_adapters: Params,
                   server_adapters: Params, cuts, weights) -> Params:
    """Global-model adapters for evaluation and serving (paper b4).

    Per flat layer: the FedAvg-weighted mix of the client copies (for
    clients that own the layer) and the server copy (for the rest).  The
    serving rank of a layer is the weighted mean rank, truncated to an
    integer in fp32 as in the reference."""
    dev = model.device
    masks = client_layer_masks(model.num_flat_layers, cuts).to(dev)
    w = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    w = w / torch.clamp(w.sum(), min=1e-9)
    ranks = lora_lib.effective_ranks(model.num_flat_layers, cuts,
                                     model.arch.lora)
    mean_ranks = (w[:, None] * ranks.to(dev)).sum(0)          # (M,)

    out: Params = {}
    for gname, targets in client_adapters.items():
        g = model.group_by_name[gname]
        ids = torch.as_tensor(g.layer_ids, device=dev)
        m = masks.index_select(1, ids).T                      # (Lg, N)
        wm = m * w[None, :]                                   # client share
        ws = ((1.0 - m) * w[None, :]).sum(1)[:, None, None]   # server share
        out[gname] = {}
        for tname, ad in targets.items():
            srv = server_adapters[gname][tname]
            out[gname][tname] = {
                "A": torch.einsum("ln,ln...->l...", wm, ad["A"])
                + ws * srv["A"],
                "B": torch.einsum("ln,ln...->l...", wm, ad["B"])
                + ws * srv["B"],
            }
    return lora_lib.mask_adapters(model, out, mean_ranks.to(torch.int32))
