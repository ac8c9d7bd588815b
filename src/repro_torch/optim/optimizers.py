"""Optimizers as pure (init, update) pairs over trees of tensors.

Port of src/repro/optim/optimizers.py.  ``update(grads, state, params,
lr)`` returns (new_params, new_state) and changes nothing in place;
``norm_sum`` sums the clip's squared norm over the ranks that each hold
a block of a client-stacked tree.  The
step counter ``state["count"]`` is an int32 tensor on the parameters'
device: a scalar when every parameter takes the same number of steps
(the sync path), or a per-client (N,) vector that the local-steps and
async round engines attach (``rounds.with_per_client_opt_steps``), where
client i may take fewer optimizer steps than client j in one round.
AdamW's bias correction then uses each client's own count, broadcast on
the client axis, which is axis 1 of a client-stacked (Lg, N, ...) leaf;
a 1-D leaf is indexed by client already.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


def _count(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd(momentum: float = 0.0, weight_decay: float = 0.0,
        grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        state = {"count": _count(params)}
        if momentum:
            state["mu"] = tree_map(torch.zeros_like, params)
        return state

    def update(grads, state, params, lr, *, norm_sum=None):
        grads = _clip(grads, grad_clip, norm_sum)
        new_state = {"count": state["count"] + 1}
        step = grads
        if momentum:
            step = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            new_state["mu"] = step
        new_params = tree_map(lambda p, s: p - lr * (s + weight_decay * p),
                              params, step)
        return new_params, new_state

    return Optimizer(init, update)


def adamw(beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        zeros = lambda: tree_map(                              # noqa: E731
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        return {"m": zeros(), "v": zeros(), "count": _count(params)}

    def update(grads, state, params, lr, *, norm_sum=None):
        grads = _clip(grads, grad_clip, norm_sum)
        cnt = state["count"] + 1
        m = tree_map(lambda m_, g: beta1 * m_ + (1 - beta1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: beta2 * v_ + (1 - beta2) * g.float() ** 2,
                     state["v"], grads)
        one = torch.ones((), dtype=torch.float32, device=cnt.device)
        bc1 = 1 - (one * beta1) ** cnt.float()
        bc2 = 1 - (one * beta2) ** cnt.float()

        def step(p, m_, v_):
            b1, b2 = _bc_broadcast(bc1, m_), _bc_broadcast(bc2, m_)
            upd = (m_ / b1) / (torch.sqrt(v_ / b2) + eps)
            return (p - lr * (upd + weight_decay * p.float()).to(p.dtype)
                    ).to(p.dtype)

        return tree_map(step, params, m, v), {"m": m, "v": v, "count": cnt}

    return Optimizer(init, update)


def _bc_broadcast(bc, leaf):
    """A bias-correction factor aligned with a parameter leaf: a scalar
    count broadcasts as is; a per-client (N,) count goes on axis 1 of a
    client-stacked leaf."""
    if bc.dim() == 0 or leaf.dim() <= 1:
        return bc
    return bc.reshape((1, -1) + (1,) * (leaf.dim() - 2))


def _clip(grads, clip: float, norm_sum=None):
    """Scale the whole tree to global norm <= clip: one norm over every
    leaf, so in a client-stacked tree all clients share the scale.
    norm_sum, when the tree holds one rank's rows of the cohort, sums
    the squared norm over the ranks (Cohort.sum)."""
    if not clip:
        return grads
    gsq = sum(g.float().square().sum() for g in tree_leaves(grads))
    if norm_sum is not None:
        gsq = norm_sum(gsq)
    scale = torch.clamp(clip / torch.clamp(torch.sqrt(gsq), min=1e-12),
                        max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)


def make_optimizer(name: str, *, weight_decay: float = 0.0,
                   beta1: float = 0.9, beta2: float = 0.999,
                   eps: float = 1e-8, grad_clip: float = 0.0) -> Optimizer:
    if name == "adamw":
        return adamw(beta1, beta2, eps, weight_decay, grad_clip)
    if name == "sgd":
        return sgd(0.0, weight_decay, grad_clip)
    if name == "sgdm":
        return sgd(0.9, weight_decay, grad_clip)
    raise ValueError(f"unknown optimizer {name!r}")
