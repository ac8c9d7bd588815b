"""Hand the JAX package's trees to the port, name for name.

The reference builds parameters and adapter pools as nested dicts of JAX
arrays; given as numpy arrays (``np.asarray`` on every leaf), the same
trees become the port's tensors here, with the same keys and layouts
(``W`` (d_in, d_out), leading per-group layer axis, pool leaves
(Lg, P, ...)).  Tests feed both packages the same weights this way, since
``jax.random`` and ``torch.Generator`` draw different numbers from one
seed.  This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike

Tree = Dict[str, Any]


def _leaf_to_torch(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":          # ml_dtypes bfloat16
        t = torch.from_numpy(np.array(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))       # a writable copy
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Tree, device: DeviceLike) -> Tree:
    """The reference's parameter tree as the port's tensors on `device`."""
    return _map(tree, lambda a: _leaf_to_torch(a, device))


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


def to_numpy(tree: Tree) -> Tree:
    """Back to numpy, name for name (bf16 leaves come back as float32)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return _map(tree, leaf)
