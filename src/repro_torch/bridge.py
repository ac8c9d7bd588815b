"""Hand the JAX package's trees to the port, name for name, and back.

The reference builds parameters, adapter pools, decode caches and
round-engine state as nested dicts of JAX arrays; given as numpy arrays
(``np.asarray`` on every leaf), the same trees become the port's tensors
here, with the same keys and layouts (``W`` (d_in, d_out), leading
per-group layer axis, pool leaves (Lg, P, ...), client adapters (Lg, N,
...), cache leaves (Lg, B, ...)).  Tests start both
packages from the same weights and state this way, since ``jax.random``
and ``torch.Generator`` draw different numbers from one seed.  This
module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.tree import tree_map

Tree = Dict[str, Any]

# round-engine state leaves that are host data in the port
# (repro_torch.core.rounds), with their dtypes
HOST_STATE = {"cuts": np.int32, "round": np.int32, "rank_cut": np.int32,
              "smashed_choice": np.int32, "topk_frac": np.float32,
              "step_budgets": np.int32, "buffer_mask": np.float32,
              "buffer_steps": np.float32, "adapter_version": np.int32,
              "global_version": np.int32, "edge_assign": np.int32}


def _leaf_to_torch(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":          # ml_dtypes bfloat16
        t = torch.from_numpy(np.array(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))       # a writable copy
    return t.to(device)


def params_from_numpy(tree: Tree, device: DeviceLike) -> Tree:
    """The reference's parameter tree as the port's tensors on `device`."""
    return tree_map(lambda a: _leaf_to_torch(a, device), tree)


def pool_from_numpy(tree: Tree, device: DeviceLike) -> Tree:
    """The reference's adapter pool {group:{target:{"A":(Lg,P,din,r),
    "B":(Lg,P,r,dout),"scale":(Lg,P)}}} as the port's tensors; scales are
    fp32 as the indexed LoRA kernel takes them."""
    out = params_from_numpy(tree, device)
    for targets in out.values():
        for leaves in targets.values():
            missing = {"A", "B", "scale"} - set(leaves)
            if missing:
                raise ValueError(f"adapter pool leaf lacks {sorted(missing)}")
            leaves["scale"] = leaves["scale"].float()
    return out


def state_from_numpy(state: Tree, device: DeviceLike) -> Tree:
    """The reference's round-engine state (``repro.core.rounds.
    init_state`` and its successors) as the port's: adapters and optimizer
    slots on `device`; ``cuts``, ``round`` and the per-client policy and
    bookkeeping leaves (co-controller, step budgets, async buffer, edge
    groups) as host tensors."""
    out = params_from_numpy(
        {k: v for k, v in state.items() if k not in HOST_STATE}, device)
    for k, dtype in HOST_STATE.items():
        if k in state:
            out[k] = torch.from_numpy(np.array(state[k], dtype=dtype))
    return out


def cache_from_numpy(cache: Tree, device: DeviceLike) -> Tree:
    """The reference's decode cache (``Model.init_cache`` and what prefill
    and decode return) as the port's: "len" int32, each attention group's
    "k"/"v" and each SSM group's "conv" window in their own dtype, its
    "state" in fp32."""
    out = params_from_numpy(cache, device)
    out["len"] = out["len"].to(torch.int32)
    for entry in out.values():
        if isinstance(entry, dict) and "state" in entry:
            entry["state"] = entry["state"].float()
    return out


def to_numpy(tree: Tree) -> Tree:
    """Back to numpy, name for name (bf16 leaves come back as float32);
    takes parameters, pools and round-engine state alike."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(leaf, tree)
