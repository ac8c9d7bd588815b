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
"opt_c", "opt_s", "cuts", "round"}, plus the co-controller's per-client
policy leaves "rank_cut" ((N,) int32), "smashed_choice" ((N,) int32) and
"topk_frac" ((N,) float32) when ``prepare_state`` attaches them.
Adapters and optimizer slots live on the model's device; ``cuts``,
``round`` and the policy leaves are host data on the CPU, because the
host decides from them which layers compress with what
(repro_torch.core.smashed) and the controller rewrites them between
rounds.

Ported: the sync path (max_local_steps=1, compress="none", agg_every=1,
no error feedback) with the memory knobs remat, ce_chunk and microbatch
and the co-controller's per-client cut, rank and compressor.  Every
other option raises NotImplementedError naming its ROADMAP item.
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
# the co-controller's per-client policy leaves (see prepare_state)
POLICY = ("rank_cut", "smashed_choice", "topk_frac")


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
    defaults = dict(agg_every=1, compress="none", max_local_steps=1,
                    async_buffer=False, num_edges=1)
    for name, value in opts.items():
        if value != defaults[name]:
            raise NotImplementedError(
                f"make_train_step({name}={value!r}) is not ported yet "
                f"({_LATER}); the sync path takes {name}={defaults[name]!r}")


def _check_state(state: Params) -> None:
    extra = set(state) - {"client_adapters", "server_adapters", "opt_c",
                          "opt_s", "cuts", "round", *POLICY}
    if extra:
        raise NotImplementedError(
            f"state leaves {sorted(extra)} belong to engines that are not "
            f"ported yet ({_LATER})")


def _cut_boundary(smasher, buckets, choice, cuts, topk_frac=None):
    """The cut-boundary hook: the per-client bucket selector when the
    co-controller is on (buckets + state["smashed_choice"]), else the one
    configured compressor.  topk_frac ((N,) from state["topk_frac"],
    bucket path only) makes the topk bucket's keep fraction per client."""
    if buckets is not None:
        if choice is None:
            raise ValueError(
                "compressor_buckets needs state['smashed_choice'] "
                "((N,) int32 bucket indices; see prepare_state)")
        return smashed.make_multi_boundary(buckets, cuts, choice,
                                           topk_frac=topk_frac)
    if topk_frac is not None:
        raise ValueError(
            "state['topk_frac'] (the continuous topk knob) needs the "
            "co-controller's compressor buckets; the single-compressor "
            "path keeps its static topk_frac")
    return smashed.make_boundary(smasher, cuts)


def _state_ranks(model: Model, state: Params, cuts):
    """(N, M) effective ranks when the state carries the co-controller's
    "rank_cut"; None under the static LoRAConfig policy."""
    rank_cut = state.get("rank_cut")
    if rank_cut is None:
        return None
    return lora_lib.effective_ranks(model.num_flat_layers, cuts,
                                    model.arch.lora, r_cut=rank_cut)


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
    compressor through the straight-through backward.

    remat and ce_chunk: the model's memory knobs (models/model.py).
    microbatch=A > 1 accumulates the gradients of A slices of each
    client's batch before the optimizer step: activation memory scales by
    1/A, the gradient buffer stays adapter-sized.

    compressor_buckets (a tuple of compressor names) is the
    co-controller's search space: the state must then carry
    "smashed_choice" (see prepare_state), and each client's cut boundary
    runs its chosen bucket.  If the state carries "rank_cut", each
    client's rank at the cut is read from it in merge, eval and FedAvg."""
    if max_local_steps < 1:
        raise ValueError(f"max_local_steps must be >= 1, got "
                         f"{max_local_steps}")
    if max_local_steps > 1 and microbatch > 1:
        raise ValueError("the local-steps engine does not compose with "
                         "microbatch accumulation yet")
    if async_buffer:
        if max_local_steps > 1 or microbatch > 1:
            raise ValueError("the async engine runs one local step per "
                             "event tick; it does not compose with "
                             "max_local_steps or microbatch")
        if compress != "none":
            raise ValueError("adapter-delta compression (topk/int8) is "
                             "not yet composed with async buffering; use "
                             "compress='none'")
        if agg_every != 1:
            raise ValueError("async buffering replaces agg_every: the "
                             "buffer fill decides when to aggregate")
    _unported(agg_every=agg_every, compress=compress,
              max_local_steps=max_local_steps, async_buffer=async_buffer,
              num_edges=num_edges)
    opt = _optimizer_of(model.arch)
    smasher = smashed.make_compressor(smashed_compress,
                                      topk_frac=smashed_topk_frac)
    buckets = None
    if compressor_buckets is not None:
        buckets = tuple(
            smashed.make_compressor(nm, topk_frac=smashed_topk_frac)
            for nm in compressor_buckets)
    dev = model.device

    def step(base_params, state, batch, weights, active, lr_c, lr_s):
        if "smashed_ef" in state and microbatch > 1:
            raise ValueError("smashed error feedback does not compose "
                             "with microbatch accumulation")
        _check_state(state)
        cad, sad = state["client_adapters"], state["server_adapters"]
        cuts = state["cuts"]
        weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
        active = torch.as_tensor(active, dtype=torch.float32, device=dev)
        boundary = _cut_boundary(smasher, buckets,
                                 state.get("smashed_choice"), cuts,
                                 topk_frac=state.get("topk_frac"))
        total, metrics, g_cad, g_sad = round_grads(
            model, base_params, state, batch, weights * active,
            boundary=boundary, remat=remat, ce_chunk=ce_chunk,
            microbatch=microbatch)
        with torch.no_grad():
            new_cad, opt_c = opt.update(g_cad, state["opt_c"], cad, lr_c)
            new_sad, opt_s = opt.update(g_sad, state["opt_s"], sad, lr_s)
            agg = aggregation.fedavg(model, new_cad, cuts, weights, active,
                                     ranks=_state_ranks(model, state, cuts))
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
                boundary=None, *, remat: str = "none", ce_chunk: int = 0,
                microbatch: int = 1):
    """f1-f5 of one round: the weighted round loss and its gradients.

    weights: (N,) survivor-masked FedAvg x C3 weights, normalized here.
    The state's "rank_cut", if any, sets each client's rank at the cut.
    microbatch=A > 1 sums the loss, metrics and gradients of A slices of
    each client's batch (rows [a B/A, (a+1) B/A) in slice a), then scales
    each by 1/A, as the reference's scan does.  Returns (total,
    per-client metrics, client-adapter grads, server-adapter grads), all
    detached; grads have the adapters' trees."""
    cad, sad = state["client_adapters"], state["server_adapters"]
    batch = {k: torch.as_tensor(v, device=model.device)
             for k, v in batch.items()}
    wl = torch.as_tensor(weights, dtype=torch.float32, device=model.device)
    wl = wl / torch.clamp(wl.sum(), min=1e-9)
    leaves = [t.detach().requires_grad_(True)
              for t in tree_leaves(cad) + tree_leaves(sad)]
    n_c = len(tree_leaves(cad))
    parts = [batch]
    if microbatch > 1:
        parts = [{k: v.reshape((v.shape[0], microbatch, -1) + v.shape[2:])
                  [:, a] for k, v in batch.items()}
                 for a in range(microbatch)]
    total = metrics = grads = None
    for mb in parts:
        with torch.enable_grad():
            eff = split.merge_adapters(
                model, tree_unflatten(cad, leaves[:n_c]),
                tree_unflatten(sad, leaves[n_c:]), state["cuts"],
                rank_cut=state.get("rank_cut"))
            per_loss, met = model.loss(base_params, eff, mb, remat=remat,
                                       ce_chunk=ce_chunk, per_client=True,
                                       boundary=boundary)
            t = (wl * per_loss).sum()
            g = torch.autograd.grad(t, leaves, allow_unused=True)
        g = [torch.zeros_like(x) if gi is None else gi
             for x, gi in zip(leaves, g)]
        met = {k: v.detach() for k, v in met.items()}
        if total is None:
            total, metrics, grads = t.detach(), met, g
        else:
            total = total + t.detach()
            metrics = {k: metrics[k] + met[k] for k in metrics}
            grads = [a + b for a, b in zip(grads, g)]
    if microbatch > 1:
        scale = 1.0 / microbatch
        total = total * scale
        metrics = {k: v * scale for k, v in metrics.items()}
        grads = [g * scale for g in grads]
    return (total, metrics, tree_unflatten(cad, grads[:n_c]),
            tree_unflatten(sad, grads[n_c:]))


def make_eval_step(model: Model, *, ce_chunk: int = 0):
    """Evaluate the GLOBAL model (paper b4) on per-client eval batches.

    step(base_params, state, batch, weights) -> (per-client loss (N,),
    metrics): the inputs to the C3 rule.  The global adapters are shared
    (rank-2) leaves, so every q/k/v/o projection runs the fused LoRA
    kernel over all N * B * S tokens at once; the state's "rank_cut", if
    any, sets the serving ranks."""
    dev = model.device

    @torch.no_grad()
    def step(base_params, state, batch, weights):
        _check_state(state)
        eff = split.serve_adapters(model, state["client_adapters"],
                                   state["server_adapters"], state["cuts"],
                                   weights, rank_cut=state.get("rank_cut"))
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        return model.loss(base_params, eff, batch, ce_chunk=ce_chunk,
                          per_client=True)

    return step


def with_rank_cut(state: Params, r_cut: int) -> Params:
    """Attach the co-controller's per-client rank at the cut ((N,) int32
    on the host, initialized to r_cut): the engine then reads ranks from
    the state, and the controller moves them between rounds."""
    n = state["cuts"].shape[0]
    return dict(state, rank_cut=torch.full((n,), int(r_cut),
                                           dtype=torch.int32))


def with_smashed_choice(state: Params, index: int = 0) -> Params:
    """Attach the co-controller's per-client compressor-bucket index
    ((N,) int32 on the host, into make_train_step's compressor_buckets)."""
    n = state["cuts"].shape[0]
    return dict(state, smashed_choice=torch.full((n,), int(index),
                                                 dtype=torch.int32))


def with_topk_frac(state: Params, frac: float) -> Params:
    """Attach the co-controller's per-client topk keep fraction ((N,)
    float32 on the host, initialized uniform): the bucket boundary runs
    its topk bucket at each client's own fraction."""
    n = state["cuts"].shape[0]
    return dict(state, topk_frac=torch.full((n,), float(frac),
                                            dtype=torch.float32))


def prepare_state(state: Params, *, max_local_steps: int = 1,
                  async_buffer: bool = False, rank_cut=None,
                  smashed_choice=None, topk_frac=None,
                  edge_groups: int = 1) -> Params:
    """Attach every scheduler-conditional state leaf in one place, the
    engine's state template (the reference's prepare_state).

    rank_cut / smashed_choice / topk_frac: the co-controller's initial
    per-client rank at the cut, compressor-bucket index and topk keep
    fraction (None leaves the static policy and its template).  The
    step-budget, async-buffer and edge-group leaves belong to engines
    that are not ported yet and raise."""
    for bad, what in ((max_local_steps > 1,
                       f"max_local_steps={max_local_steps}"),
                      (async_buffer, "async_buffer=True"),
                      (edge_groups > 1, f"edge_groups={edge_groups}")):
        if bad:
            raise NotImplementedError(
                f"prepare_state({what}) attaches leaves of an engine that "
                f"is not ported yet ({_LATER})")
    if rank_cut is not None:
        state = with_rank_cut(state, rank_cut)
    if smashed_choice is not None:
        state = with_smashed_choice(state, smashed_choice)
    if topk_frac is not None:
        state = with_topk_frac(state, topk_frac)
    return state
