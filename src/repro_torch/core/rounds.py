"""The SplitFT round engine: Algorithm 1, one synchronous round per call.

Port of src/repro/core/rounds.py (``init_state``, the sync path of
``make_train_step`` and ``make_eval_step``).  One ``train_step`` call is
one global round:

  f1-f5  client forward to the cut, server forward and backward on the
         smashed activations, gradient return, client backward: one
         autograd pass over (client_adapters, server_adapters), because
         the cut is the mask switch in the merged adapter tree
  b1-b3  FedAvg of the client adapters (weighted, masked, survivor-aware)
  b4     dormant rows re-synced to the server adapters

Base parameters stay frozen: they are an input, never an output, and the
optimizer holds state only for adapters.

State layout, as the reference's: {"client_adapters", "server_adapters",
"opt_c", "opt_s", "cuts", "round"}.  Adapters and optimizer slots live on
the model's device; ``cuts`` ((N,) int32) and ``round`` (() int32) are
host data on the CPU, because the host decides from them which layers
compress (repro_torch.core.smashed) and the controller rewrites the cuts
between rounds.

Only the paper's sync path is ported: max_local_steps=1, microbatch=1,
compress="none", agg_every=1, one compressor for every client and no
error feedback.  Every other option raises NotImplementedError naming its
ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import roadmap
from repro_torch.core import aggregation, lora as lora_lib, smashed, split
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.tree import tree_leaves, tree_unflatten

Params = Dict[str, Any]

_LATER = roadmap.ENGINE_OPTIONS
_CO = f"the co-controller's slice of {roadmap.ENGINE_OPTIONS}"


def init_state(model: Model, generator: torch.Generator, *,
               num_clients: int, dtype=torch.float32) -> Params:
    """Round-engine state (everything that changes across rounds)."""
    arch = model.arch
    cad = lora_lib.init_adapters(model, generator, num_clients=num_clients,
                                 dtype=dtype)
    sad = lora_lib.init_adapters(model, generator, num_clients=0, dtype=dtype)
    opt = _optimizer_of(arch)
    return {
        "client_adapters": cad,
        "server_adapters": sad,
        "opt_c": opt.init(cad),
        "opt_s": opt.init(sad),
        "cuts": torch.full((num_clients,), arch.split.cut_layer,
                           dtype=torch.int32),
        "round": torch.zeros((), dtype=torch.int32),
    }


def _optimizer_of(arch):
    t = arch.train
    return make_optimizer(t.optimizer, weight_decay=t.weight_decay,
                          beta1=t.beta1, beta2=t.beta2, eps=t.eps,
                          grad_clip=t.grad_clip)


def _unported(**opts) -> None:
    """Raise for the first option that leaves the ported sync path."""
    defaults = dict(remat="none", ce_chunk=0, agg_every=1, compress="none",
                    microbatch=1, compressor_buckets=None, max_local_steps=1,
                    async_buffer=False, num_edges=1)
    for name, value in opts.items():
        if value != defaults[name]:
            where = (_CO if name in ("compressor_buckets", "num_edges")
                     else _LATER)
            raise NotImplementedError(
                f"make_train_step({name}={value!r}) is not ported yet "
                f"({where}); the sync path takes {name}={defaults[name]!r}")


def _check_state(state: Params) -> None:
    extra = set(state) - {"client_adapters", "server_adapters", "opt_c",
                          "opt_s", "cuts", "round"}
    if extra:
        raise NotImplementedError(
            f"state leaves {sorted(extra)} belong to engines that are not "
            f"ported yet ({_CO})")


def make_train_step(model: Model, *, remat: str = "none", ce_chunk: int = 0,
                    agg_every: int = 1, compress: str = "none",
                    microbatch: int = 1, smashed_compress: str = "none",
                    smashed_topk_frac: float = 0.1,
                    compressor_buckets=None, max_local_steps: int = 1,
                    async_buffer: bool = False, num_edges: int = 1):
    """Build the round step.

    step(base_params, state, batch, weights, active, lr_c, lr_s)
      -> (state', metrics)

    batch: {"tokens", "labels"[, "loss_mask"]}, each (N, B, S), numpy or
    tensors (moved to the model's device); weights: (N,) combined FedAvg x
    C3 weights; active: (N,) {0,1} survivor mask; lr_c, lr_s: floats.
    smashed_compress selects the cut-boundary compressor (none | int8 |
    fp8 | topk); the f4 gradient return is compressed by the same
    compressor through the straight-through backward."""
    _unported(remat=remat, ce_chunk=ce_chunk, agg_every=agg_every,
              compress=compress, microbatch=microbatch,
              compressor_buckets=compressor_buckets,
              max_local_steps=max_local_steps, async_buffer=async_buffer,
              num_edges=num_edges)
    opt = _optimizer_of(model.arch)
    smasher = smashed.make_compressor(smashed_compress,
                                      topk_frac=smashed_topk_frac)
    dev = model.device

    def step(base_params, state, batch, weights, active, lr_c, lr_s):
        _check_state(state)
        cad, sad = state["client_adapters"], state["server_adapters"]
        cuts = state["cuts"]
        weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
        active = torch.as_tensor(active, dtype=torch.float32, device=dev)
        total, metrics, g_cad, g_sad = round_grads(
            model, base_params, state, batch, weights * active,
            boundary=smashed.make_boundary(smasher, cuts))
        with torch.no_grad():
            new_cad, opt_c = opt.update(g_cad, state["opt_c"], cad, lr_c)
            new_sad, opt_s = opt.update(g_sad, state["opt_s"], sad, lr_s)
            agg = aggregation.fedavg(model, new_cad, cuts, weights, active)
            new_cad = aggregation.broadcast_after_agg(model, new_cad, agg,
                                                      new_sad, cuts)
        new_state = dict(state)
        new_state.update(client_adapters=new_cad, server_adapters=new_sad,
                         opt_c=opt_c, opt_s=opt_s,
                         round=state["round"] + 1)
        metrics["total"] = total
        return new_state, metrics

    return step


def round_grads(model: Model, base_params, state: Params, batch, weights,
                boundary=None):
    """f1-f5 of one round: the weighted round loss and its gradients.

    weights: (N,) survivor-masked FedAvg x C3 weights, normalized here.
    Returns (total, per-client metrics, client-adapter grads,
    server-adapter grads), all detached; grads have the adapters' trees."""
    cad, sad = state["client_adapters"], state["server_adapters"]
    batch = {k: torch.as_tensor(v, device=model.device)
             for k, v in batch.items()}
    wl = torch.as_tensor(weights, dtype=torch.float32, device=model.device)
    wl = wl / torch.clamp(wl.sum(), min=1e-9)
    leaves = [t.detach().requires_grad_(True)
              for t in tree_leaves(cad) + tree_leaves(sad)]
    n_c = len(tree_leaves(cad))
    with torch.enable_grad():
        eff = split.merge_adapters(
            model, tree_unflatten(cad, leaves[:n_c]),
            tree_unflatten(sad, leaves[n_c:]), state["cuts"])
        per_loss, metrics = model.loss(base_params, eff, batch,
                                       per_client=True, boundary=boundary)
        total = (wl * per_loss).sum()
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (total.detach(), metrics, tree_unflatten(cad, grads[:n_c]),
            tree_unflatten(sad, grads[n_c:]))


def make_eval_step(model: Model):
    """Evaluate the GLOBAL model (paper b4) on per-client eval batches.

    step(base_params, state, batch, weights) -> (per-client loss (N,),
    metrics): the inputs to the C3 rule.  The global adapters are shared
    (rank-2) leaves, so every q/k/v/o projection runs the fused LoRA
    kernel over all N * B * S tokens at once."""
    dev = model.device

    @torch.no_grad()
    def step(base_params, state, batch, weights):
        _check_state(state)
        eff = split.serve_adapters(model, state["client_adapters"],
                                   state["server_adapters"], state["cuts"],
                                   weights)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        return model.loss(base_params, eff, batch, per_client=True)

    return step
