"""The SplitFT round engine: Algorithm 1, one round (or one event tick)
per call.

Port of src/repro/core/rounds.py.  One sync ``train_step`` call is one
global round:

  f1-f5  client forward to the cut, server forward and backward on the
         smashed activations, gradient return, client backward: one
         autograd pass over (client_adapters, server_adapters), because
         the cut is the mask switch in the merged adapter tree
  b1-b3  FedAvg of the client adapters (weighted, masked, survivor-aware,
         step-normalized, optionally top-k + error feedback or int8
         compressed, flat or two-tier, every `agg_every` rounds)
  b4     dormant rows re-synced to the server adapters

The engine is policy-free: which clients run, and how many local steps
each takes, comes from a RoundScheduler as data (the `active` mask and
state["step_budgets"]).  ``max_local_steps`` K > 1 selects the
local-steps engine (K inner steps, client i frozen after budgets[i]);
``async_buffer`` the FedBuff engine, where one call is one event tick of
the host's event queue and aggregation fires when the server buffer
fills.

Base parameters stay frozen: they are an input, never an output, and the
optimizer holds state only for adapters.

State layout, as the reference's: {"client_adapters", "server_adapters",
"opt_c", "opt_s", "cuts", "round"}, plus what ``prepare_state`` and the
``with_*`` helpers attach: "ef" (adapter error feedback), "smashed_ef"
((N, B, S, d) smashed error feedback), "step_budgets", the async buffer
("buffer_mask", "buffer_steps", "adapter_version", "global_version"),
"edge_assign" and the co-controller's "rank_cut", "smashed_choice" and
"topk_frac".  Adapters, optimizer slots and residuals live on the
model's device.  The per-client policy and bookkeeping leaves (cuts,
round, budgets, buffer, versions, edge groups, the co-controller's
leaves; ``repro_torch.bridge.HOST_STATE``) are host tensors on the CPU:
the host decides from them which layers compress, how many inner steps
run, whether a tick aggregates and whether this round runs FedAvg, so no
decision waits on the device.  Where the reference scans or conds on the
device, the port loops and branches on the host: the local-steps loop
stops after the last inner step in which some client is active, since
the reference's later inner steps select every leaf back unchanged.

Sharding (``shard``, a runtime.sharding.MeshShard or ClientShard): each
rank holds its block of the cohort's rows, over the mesh's "data" axis,
of every client-axis leaf, and each step takes the full (N,) weights
and mask and the full batch, and keeps its rows of them (``shard_state``,
``shard_client_batch``), as the reference's engines pin the state and
batch to the mesh's "data" axis on entry and exit.  Every sum over
clients is a rank-local partial sum followed by an all-reduce: the
weight normalization, the round loss, the server adapters' gradients
(before their optimizer step, so every rank takes the same one), the
clip norm of the client tree, FedAvg and the eval adapters; top-k
adapter compression gathers the rows, int8 takes a MAX of the amax.
Every host decision that reads the cohort (whether an inner step or a
tick has an active client, the buffer fill) is taken on cohort-wide
values, and per-client metrics come back as (N,) on every rank.  The
MoE router loss is a mean over the cohort's routing groups (every
sequence of every client is one), so each rank adds its own mean times
1 / world.  Any random draw of the state is made for the whole cohort
and then sliced, so no result depends on the world size.  Under a
MeshShard the model runs on the rank's blocks of the base weights
(models/common.ShardingPolicy), and an adapter gradient that a rank
computed a part of is summed over "model" first (``round_grads``);
where the loss split each client's batch rows over "pod", every
gradient is summed over "pod" too.  The cut's compressor sees each
client's whole message on every rank (``ShardingPolicy.whole_message``),
so a smashed residual is whole and equal on every "pod" and "model"
rank.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core import aggregation, lora as lora_lib, smashed, split
from repro_torch.models.common import NO_SHARDING, ShardingPolicy
from repro_torch.models.model import Model
from repro_torch.optim.compression import (ErrorFeedback, int8_dequantize,
                                           int8_quantize)
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.runtime.sharding import (UNSHARDED, Cohort, cohort_of,
                                          shard_client_batch, shard_state)
from repro_torch.tree import (tree_leaves, tree_leaves_with_path, tree_map,
                              tree_unflatten)

Params = Dict[str, Any]

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


def _host(x, dtype=torch.float32):
    """A per-client mask or count as a host tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", dtype)
    return torch.as_tensor(x, dtype=dtype)


def _cut_boundary(smasher, buckets, choice, cuts, residual=None,
                  topk_frac=None):
    """The cut-boundary hook: the per-client bucket selector when the
    co-controller is on (buckets + state["smashed_choice"]), else the one
    configured compressor, with error feedback when the state carries a
    smashed residual.  topk_frac ((N,) from state["topk_frac"], bucket
    path only) makes the topk bucket's keep fraction per client."""
    if buckets is not None:
        if choice is None:
            raise ValueError(
                "compressor_buckets needs state['smashed_choice'] "
                "((N,) int32 bucket indices; see prepare_state)")
        if residual is not None:
            raise ValueError("smashed error feedback does not compose "
                             "with per-client compressor buckets")
        return smashed.make_multi_boundary(buckets, cuts, choice,
                                           topk_frac=topk_frac)
    if topk_frac is not None:
        raise ValueError(
            "state['topk_frac'] (the continuous topk knob) needs the "
            "co-controller's compressor buckets; the single-compressor "
            "path keeps its static topk_frac")
    return smashed.make_boundary(smasher, cuts, residual=residual)


def _state_ranks(model: Model, state: Params, cuts):
    """(N, M) effective ranks when the state carries the co-controller's
    "rank_cut"; None under the static LoRAConfig policy."""
    rank_cut = state.get("rank_cut")
    if rank_cut is None:
        return None
    return lora_lib.effective_ranks(model.num_flat_layers, cuts,
                                    model.arch.lora, r_cut=rank_cut)


def _cohort_of(shard, weights) -> Cohort:
    """The cohort of the host's full (N,) weights under `shard`."""
    n = weights.shape[0] if hasattr(weights, "shape") else len(weights)
    return cohort_of(shard, int(n))


def _local(cohort: Cohort, x, device=None):
    """This rank's rows of a full (N,) host vector, as a float tensor."""
    return cohort.rows(torch.as_tensor(x, dtype=torch.float32,
                                       device=device))


def _replicated_rows(state, key, cohort: Cohort):
    """This rank's rows of a replicated per-client leaf (the
    co-controller's topk_frac, which state_specs does not shard)."""
    x = state.get(key)
    return None if x is None else cohort.rows(x)


def _any_per_row(mask, cohort: Cohort):
    """(K, N) host mask -> K bools: whether row k holds a nonzero entry
    anywhere in the cohort (one MAX over the ranks)."""
    local = (mask > 0).any(dim=1).to(torch.int32)
    return [bool(v) for v in cohort.max(local)]


def _gather_metrics(metrics, cohort: Cohort):
    """Per-client metrics ((N_local,) rows) gathered to (N,)."""
    if not cohort.split:
        return metrics
    keys = [k for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and v.dim() >= 1
            and v.shape[0] == cohort.n_local]
    full = cohort.gather_rows_many([metrics[k] for k in keys],
                                   [0] * len(keys))
    return dict(metrics, **dict(zip(keys, full)))


def _weighted_total(wn, ce, aux, cohort: Cohort):
    """The cohort's weights-averaged loss sum_i wn_i (ce_i + aux), wn
    normalized over the cohort, aux (the router loss) cohort-wide."""
    if not cohort.split:
        return (wn * (ce + aux)).sum()
    return cohort.sum((wn * ce).sum()) + cohort.sum(wn.sum()) * aux


def _keep_rows(active, new, old):
    """new where the client (axis 0) was active, old elsewhere: a client
    that sent nothing keeps its smashed residual."""
    m = active.reshape((-1,) + (1,) * (new.dim() - 1)) > 0
    return torch.where(m, new, old)


def make_train_step(model: Model, *, remat: str = "none", ce_chunk: int = 0,
                    agg_every: int = 1, compress: str = "none",
                    topk_frac: float = 0.05, microbatch: int = 1,
                    smashed_compress: str = "none",
                    smashed_topk_frac: float = 0.1,
                    compressor_buckets=None, max_local_steps: int = 1,
                    async_buffer: bool = False, buffer_size: int = 2,
                    staleness_power: float = 0.5, num_edges: int = 1,
                    server_step_norm: bool = True,
                    all_inner_steps: bool = False, shard=None):
    """Build the round step.

    step(base_params, state, batch, weights, active, lr_c, lr_s)
      -> (state', metrics)

    batch: {"tokens", "labels"[, "loss_mask"]}, each (N, B, S) (with a
    leading (K,) step axis under the local-steps engine), numpy or
    tensors (moved to the model's device); weights: (N,) combined FedAvg
    x C3 weights; active: (N,) {0,1} survivor mask (under async: the
    clients finishing at this tick); lr_c, lr_s: floats.

    smashed_compress selects the cut-boundary compressor (none | int8 |
    fp8 | topk); the f4 gradient return is compressed by the same
    compressor through the straight-through backward.  If the state
    carries "smashed_ef" (with_smashed_ef) the compressor runs with error
    feedback.  compress (none | topk | int8) compresses the adapter
    deltas before FedAvg (topk needs state["ef"], with_error_feedback);
    agg_every > 1 runs FedAvg only when (round + 1) % agg_every == 0.

    remat and ce_chunk: the model's memory knobs (models/model.py).
    microbatch=A > 1 accumulates the gradients of A slices of each
    client's batch before the optimizer step.

    compressor_buckets (a tuple of compressor names) is the
    co-controller's search space: the state must then carry
    "smashed_choice" (see prepare_state), and each client's cut boundary
    runs its chosen bucket.  If the state carries "rank_cut", each
    client's rank at the cut is read from it in merge, eval and FedAvg.

    max_local_steps=K > 1: the local-steps engine (state needs
    "step_budgets"; client i's adapters, optimizer slots and smashed
    residual advance only for inner steps k < budgets[i]; FedAvg divides
    each weight by the client's step count).  all_inner_steps=True runs
    all K inner steps even after every budget is spent, as the
    reference's scan does (the tests' check that those steps change
    nothing).

    async_buffer=True: the FedBuff tick engine (state needs the buffer
    leaves and per-client optimizer counts; with_async_buffer,
    with_per_client_opt_steps): aggregation fires in the tick that fills
    the buffer to `buffer_size`, discounting each buffered update by
    staleness_discount(staleness, power=staleness_power).

    num_edges > 1: two-tier FedAvg over state["edge_assign"]
    (with_edge_assign).  server_step_norm scales each client's server
    gradient by 1/K_i under local steps (1/(steps in buffer) under
    async); exactly 1 at K_i = 1, where the step is bitwise unchanged.

    shard: a runtime.sharding.ClientShard or MeshShard; the step then
    returns this rank's rows of the state (see the module docstring)."""
    if max_local_steps < 1:
        raise ValueError(f"max_local_steps must be >= 1, got "
                         f"{max_local_steps}")
    if max_local_steps > 1 and microbatch > 1:
        raise ValueError("the local-steps engine does not compose with "
                         "microbatch accumulation yet")
    opt = _optimizer_of(model.arch)
    smasher = smashed.make_compressor(smashed_compress,
                                      topk_frac=smashed_topk_frac)
    buckets = None
    if compressor_buckets is not None:
        buckets = tuple(
            smashed.make_compressor(nm, topk_frac=smashed_topk_frac)
            for nm in compressor_buckets)
    policy = ShardingPolicy.for_model(shard, model.arch)
    common = dict(remat=remat, ce_chunk=ce_chunk, buckets=buckets,
                  num_edges=num_edges, server_step_norm=server_step_norm,
                  shard=shard, policy=policy)
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
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got "
                             f"{buffer_size}")
        return _make_async_step(model, opt, smasher,
                                buffer_size=buffer_size,
                                staleness_power=staleness_power, **common)
    agg = dict(agg_every=agg_every, compress=compress, topk_frac=topk_frac)
    if max_local_steps > 1:
        return _make_local_steps_step(model, opt, smasher,
                                      max_local_steps=max_local_steps,
                                      all_inner_steps=all_inner_steps,
                                      **agg, **common)
    dev = model.device

    def step(base_params, state, batch, weights, active, lr_c, lr_s):
        cohort = _cohort_of(shard, weights)
        state = shard_state(state, cohort)
        batch = shard_client_batch(batch, cohort)
        sm_ef = state.get("smashed_ef")
        if sm_ef is not None and microbatch > 1:
            raise ValueError("smashed error feedback does not compose "
                             "with microbatch accumulation")
        cad, sad = state["client_adapters"], state["server_adapters"]
        cuts = state["cuts"]
        weights = _local(cohort, weights, device=dev)
        active = _local(cohort, active, device=dev)
        boundary = _cut_boundary(smasher, buckets,
                                 state.get("smashed_choice"), cuts,
                                 residual=sm_ef,
                                 topk_frac=_replicated_rows(
                                     state, "topk_frac", cohort))
        total, metrics, g_cad, g_sad = round_grads(
            model, base_params, state, batch, weights * active,
            boundary=boundary, remat=remat, ce_chunk=ce_chunk,
            microbatch=microbatch, cohort=cohort, policy=policy)
        new_sm_ef = metrics.pop("smashed_ef", None)
        with torch.no_grad():
            if new_sm_ef is not None:
                new_sm_ef = _keep_rows(active, new_sm_ef, sm_ef)
            new_cad, opt_c = opt.update(g_cad, state["opt_c"], cad, lr_c,
                                        norm_sum=cohort.sum)
            new_sad, opt_s = opt.update(g_sad, state["opt_s"], sad, lr_s)
            new_cad, ef = _round_aggregate(
                model, **agg, cad_start=cad, new_cad=new_cad,
                new_sad=new_sad, cuts=cuts, weights=weights, active=active,
                ef=state.get("ef"), round_idx=state["round"],
                ranks=_state_ranks(model, state, cuts),
                edge_assign=state.get("edge_assign"), num_edges=num_edges,
                cohort=cohort)
        new_state = dict(state)
        new_state.update(client_adapters=new_cad, server_adapters=new_sad,
                         opt_c=opt_c, opt_s=opt_s,
                         round=state["round"] + 1)
        if ef is not None:
            new_state["ef"] = ef
        if new_sm_ef is not None:
            new_state["smashed_ef"] = new_sm_ef
        metrics["total"] = total
        return new_state, _gather_metrics(metrics, cohort)

    return step


def round_grads(model: Model, base_params, state: Params, batch, weights,
                boundary=None, *, remat: str = "none", ce_chunk: int = 0,
                microbatch: int = 1, server_scale=None,
                cohort: Cohort = UNSHARDED,
                policy: ShardingPolicy = NO_SHARDING):
    """f1-f5 of one round: the weighted round loss and its gradients.

    weights: (N,) survivor-masked FedAvg x C3 weights, normalized here.
    The state's "rank_cut", if any, sets each client's rank at the cut;
    server_scale ((N,), the local-steps and async engines' 1/K_i) scales
    each client's gradient into the server adapters.  microbatch=A > 1
    sums the loss, metrics and gradients of A slices of each client's
    batch (rows [a B/A, (a+1) B/A) in slice a), then scales each by 1/A,
    as the reference's scan does.  Returns (total, per-client metrics
    (with a stateful boundary's new residual as "smashed_ef"),
    client-adapter grads, server-adapter grads), all detached; grads
    have the adapters' trees.

    cohort: the state, batch and weights hold this rank's rows of a
    split cohort.  The weights are then normalized over the cohort, the
    total and the router loss ("aux") are the cohort's, and the server
    grads are summed over the ranks; the per-client metrics and the
    client grads are this rank's rows.

    policy: the base weights are a MeshShard's blocks; the adapters are
    whole on every "model" rank (adapter_specs), so a leaf whose gradient
    this rank computed a part of is summed over "model"
    (``ShardingPolicy.partial_targets``) before the sums over clients.
    Where the loss split each client's batch rows over "pod"
    (``ShardingPolicy.split_rows``: per microbatch, since each slice's
    rows are split alike), every gradient is this rank's rows' part and
    is summed over "pod"; the loss and metrics are already the
    clients' (the loss sums over "pod" itself)."""
    cad, sad = state["client_adapters"], state["server_adapters"]
    batch = {k: torch.as_tensor(v, device=model.device)
             for k, v in batch.items()}
    wl = torch.as_tensor(weights, dtype=torch.float32, device=model.device)
    wl = wl / torch.clamp(cohort.sum(wl.sum()), min=1e-9)
    # under a split cohort each rank's term carries its share of the
    # router loss: its own groups' mean / world (equal groups per rank)
    w_aux = cohort.sum(wl.sum()) / cohort.world if cohort.split else None
    leaves = [t.detach().requires_grad_(True)
              for t in tree_leaves(cad) + tree_leaves(sad)]
    n_c = len(tree_leaves(cad))
    parts = [batch]
    if microbatch > 1:
        parts = [{k: v.reshape((v.shape[0], microbatch, -1) + v.shape[2:])
                  [:, a] for k, v in batch.items()}
                 for a in range(microbatch)]
    total = metrics = grads = None
    pod_rows = policy.split_rows(parts[0])[1].rows
    for mb in parts:
        with torch.enable_grad():
            eff = split.merge_adapters(
                model, tree_unflatten(cad, leaves[:n_c]),
                tree_unflatten(sad, leaves[n_c:]), state["cuts"],
                rank_cut=state.get("rank_cut"), server_scale=server_scale)
            per_loss, met = model.loss(base_params, eff, mb, remat=remat,
                                       ce_chunk=ce_chunk, per_client=True,
                                       boundary=boundary, policy=policy)
            t = ((wl * per_loss).sum() if w_aux is None
                 else (wl * met["ce"]).sum() + w_aux * met["aux"])
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
    tp_parts = policy.partial_targets(model.cfg, base_params)
    paths = [*tree_leaves_with_path(cad), *tree_leaves_with_path(sad)]
    idx = [i for i, (keys, _) in enumerate(paths)
           if tuple(keys[:2]) in tp_parts]
    for i, g in zip(idx, policy.tp_sum_many([grads[i] for i in idx])):
        grads[i] = g
    if pod_rows:
        grads = policy.pod_sum_many(grads)
    if cohort.active:
        # every rank takes the same server step: its gradient is the
        # cohort's sum, and so are the total and the router loss
        g_srv = cohort.sum_many(grads[n_c:] + [total, metrics["aux"]])
        grads[n_c:], total, aux = g_srv[:-2], g_srv[-2], g_srv[-1]
        metrics["aux"] = aux / cohort.world if cohort.split else aux
    return (total, metrics, tree_unflatten(cad, grads[:n_c]),
            tree_unflatten(sad, grads[n_c:]))


def _round_aggregate(model: Model, *, compress, topk_frac, agg_every,
                     cad_start, new_cad, new_sad, cuts, weights, active,
                     ef, round_idx, steps=None, ranks=None,
                     edge_assign=None, num_edges: int = 1,
                     cohort: Cohort = UNSHARDED):
    """b1-b3 at the round boundary, shared by the sync and local-steps
    engines: optional adapter-delta compression (top-k + error feedback,
    or int8), survivor- and step-normalized FedAvg (flat or two-tier),
    then the b3/b4 broadcast.  The host's round index decides agg_every:
    a round that does not aggregate returns its inputs.  Returns
    (client_adapters', ef')."""
    if agg_every > 1 and (int(round_idx) + 1) % agg_every != 0:
        return new_cad, ef
    cad_for_agg = new_cad
    if compress == "topk":
        delta = aggregation.adapter_delta(new_cad, cad_start)
        dense, ef, _ = ErrorFeedback.apply(delta, ef, topk_frac, cohort)
        cad_for_agg = aggregation.apply_delta(cad_start, dense)
    elif compress == "int8":
        delta = aggregation.adapter_delta(new_cad, cad_start)
        deq = int8_dequantize(int8_quantize(delta, cohort))
        deq = tree_map(lambda d, ref: d.to(ref.dtype), deq, delta)
        cad_for_agg = aggregation.apply_delta(cad_start, deq)
    agg = aggregation.fedavg(model, cad_for_agg, cuts, weights, active,
                             steps=steps, ranks=ranks,
                             edge_assign=edge_assign, num_edges=num_edges,
                             cohort=cohort)
    return aggregation.broadcast_after_agg(model, cad_for_agg, agg, new_sad,
                                           cuts), ef


# ---------------------------------------------------------------------------
# local-steps engine (scheduler == "local_steps")


def _select_clients(step_act, any_act: bool, new_tree, old_tree):
    """Per-leaf `where` keeping old values for clients inactive in this
    inner step: the client axis is axis 1 of a stacked (Lg, N, ...)
    leaf, axis 0 of a (N,) leaf (a per-client optimizer count); a scalar
    leaf (a shared count) advances while anyone is active.  step_act:
    (N,) on the leaves' device; any_act: the host's any(step_act)."""
    def sel(n, o):
        if n.dim() == 0:
            return n if any_act else o
        if n.dim() == 1:
            return torch.where(step_act > 0, n, o)
        m = step_act.reshape((1, -1) + (1,) * (n.dim() - 2)) > 0
        return torch.where(m, n, o)

    return tree_map(sel, new_tree, old_tree)


def _select_any(any_act: bool, new_tree, old_tree):
    """The whole tree advances only while some client is active."""
    return new_tree if any_act else old_tree


def _make_local_steps_step(model: Model, opt, smasher, *, remat, ce_chunk,
                           agg_every, compress, topk_frac,
                           max_local_steps: int, buckets=None,
                           num_edges: int = 1, server_step_norm: bool = True,
                           all_inner_steps: bool = False, shard=None,
                           policy: ShardingPolicy = NO_SHARDING):
    """The K-inner-step engine (see make_train_step).

    batch leaves carry a leading (K,) step axis; state carries
    "step_budgets" (host).  One inner step is one local step on every
    client at once, masked so that client i freezes after budgets[i]
    steps.  The host builds the (K, N) masks from the budgets; the loop
    ends after the last inner step in which some active client has
    budget left (all K with all_inner_steps).  Reported metrics are the
    FIRST inner step's (the round-start loss), keeping loss curves
    comparable across schedulers."""
    K = max_local_steps
    dev = model.device

    def step(base_params, state, batch, weights, active, lr_c, lr_s):
        cohort = _cohort_of(shard, weights)
        state = shard_state(state, cohort)
        batch = shard_client_batch(batch, cohort, step_axis=True)
        cad, sad = state["client_adapters"], state["server_adapters"]
        cuts = state["cuts"]
        choice = state.get("smashed_choice")
        tfrac = _replicated_rows(state, "topk_frac", cohort)
        budgets = _host(state["step_budgets"])
        act_h = _local(cohort, _host(active))
        acts_h = torch.stack([act_h * (k < budgets).float()
                              for k in range(K)])             # (K, N)
        live = _any_per_row(acts_h, cohort)
        n_steps = K if all_inner_steps else max(1, sum(live))
        acts = acts_h[:n_steps].to(dev)
        weights = _local(cohort, weights, device=dev)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        # 1/K_i server-gradient normalization: exactly 1.0 where
        # budgets == 1 (bitwise the sync step's gradient)
        srv_scale = (1.0 / torch.clamp(budgets, 1.0, float(K))
                     if server_step_norm else None)
        cad_c, sad_c = cad, sad
        opt_c, opt_s = state["opt_c"], state["opt_s"]
        ef_c = state.get("smashed_ef")
        metrics = total = None
        for k in range(n_steps):
            sa = acts[k]
            boundary = _cut_boundary(smasher, buckets, choice, cuts,
                                     residual=ef_c, topk_frac=tfrac)
            t, met, g_cad, g_sad = round_grads(
                model, base_params, dict(state, client_adapters=cad_c,
                                         server_adapters=sad_c),
                {key: v[k] for key, v in batch.items()}, weights * sa,
                boundary=boundary, remat=remat, ce_chunk=ce_chunk,
                server_scale=srv_scale, cohort=cohort, policy=policy)
            new_ef = met.pop("smashed_ef", None)
            if k == 0:
                metrics, total = met, t
            with torch.no_grad():
                new_cad, new_opt_c = opt.update(g_cad, opt_c, cad_c, lr_c,
                                                norm_sum=cohort.sum)
                cad_c = _select_clients(sa, live[k], new_cad, cad_c)
                opt_c = _select_clients(sa, live[k], new_opt_c, opt_c)
                new_sad, new_opt_s = opt.update(g_sad, opt_s, sad_c, lr_s)
                sad_c = _select_any(live[k], new_sad, sad_c)
                opt_s = _select_any(live[k], new_opt_s, opt_s)
                if new_ef is not None:
                    ef_c = _keep_rows(sa, new_ef, ef_c)

        # b1-b3: aggregate at the round boundary, step-normalized
        with torch.no_grad():
            eff_steps = torch.clamp(budgets, 1.0, float(K))
            new_cad, ef = _round_aggregate(
                model, compress=compress, topk_frac=topk_frac,
                agg_every=agg_every, cad_start=cad, new_cad=cad_c,
                new_sad=sad_c, cuts=cuts, weights=weights,
                active=act_h.to(dev), ef=state.get("ef"),
                round_idx=state["round"], steps=eff_steps,
                ranks=_state_ranks(model, state, cuts),
                edge_assign=state.get("edge_assign"), num_edges=num_edges,
                cohort=cohort)
        new_state = dict(state)
        new_state.update(client_adapters=new_cad, server_adapters=sad_c,
                         opt_c=opt_c, opt_s=opt_s,
                         round=state["round"] + 1)
        if ef is not None:
            new_state["ef"] = ef
        if ef_c is not None:
            new_state["smashed_ef"] = ef_c
        metrics["total"] = total
        return new_state, _gather_metrics(metrics, cohort)

    return step


# ---------------------------------------------------------------------------
# async buffered engine (scheduler == "async", FedBuff-style)


def _make_async_step(model: Model, opt, smasher, *, remat, ce_chunk,
                     buffer_size: int, staleness_power: float, buckets=None,
                     num_edges: int = 1, server_step_norm: bool = True,
                     shard=None, policy: ShardingPolicy = NO_SHARDING):
    """One event tick of the buffered asynchronous engine.

    step(base_params, state, batch, weights, active, lr_c, lr_s)
      -> (state', metrics)

    active: (N,) {0,1}, the clients whose local step COMPLETES at this
    simulated instant (the host event queue's tick).  Their adapter rows
    and optimizer slots advance one step; everyone else is frozen.  The
    completions join the server buffer; when fill >= buffer_size the
    buffered rows are FedAvg'd with weights w_i (1 + staleness_i)^-p /
    steps_i and only the buffered clients are re-synced.  The buffer and
    version leaves are host tensors, so the host decides whether the
    tick aggregates without waiting on the device.

    Extra metrics (all before aggregation): "buffer_fill", "buffer_mask",
    "staleness", "aggregated" (whether this tick closed a round) and
    "fleet_total", the weights-averaged loss over the whole fleet (every
    client's batch against its current, possibly stale, row), which the
    records use so that loss curves compare across schedulers.
    state["round"] counts aggregations, not ticks."""
    M = buffer_size
    dev = model.device

    def step(base_params, state, batch, weights, active, lr_c, lr_s):
        cohort = _cohort_of(shard, weights)
        state = shard_state(state, cohort)
        batch = shard_client_batch(batch, cohort)
        cad, sad = state["client_adapters"], state["server_adapters"]
        cuts = state["cuts"]
        n = _host(active).shape[0]
        if M > n:
            raise ValueError(
                f"buffer_size={M} can never fill: only {n} distinct "
                "clients exist; clamp it to the fleet size")
        act_h = _local(cohort, _host(active))
        any_act = _any_per_row(act_h[None], cohort)[0]
        act = act_h.to(dev)
        sm_ef = state.get("smashed_ef")
        weights = _local(cohort, weights, device=dev)
        boundary = _cut_boundary(smasher, buckets,
                                 state.get("smashed_choice"), cuts,
                                 residual=sm_ef,
                                 topk_frac=_replicated_rows(
                                     state, "topk_frac", cohort))
        # this tick is the finisher's (buffer_steps + 1)-th local step
        # since its last flush: exactly 1.0 right after a flush
        srv_scale = (1.0 / (_host(state["buffer_steps"]) + 1.0)
                     if server_step_norm else None)
        total, metrics, g_cad, g_sad = round_grads(
            model, base_params, state, batch, weights * act,
            boundary=boundary, remat=remat, ce_chunk=ce_chunk,
            server_scale=srv_scale, cohort=cohort, policy=policy)
        new_sm_ef = metrics.pop("smashed_ef", None)
        with torch.no_grad():
            wf = weights / torch.clamp(cohort.sum(weights.sum()), min=1e-9)
            fleet_total = _weighted_total(wf, metrics["ce"], metrics["aux"],
                                          cohort)
            if new_sm_ef is not None:
                new_sm_ef = _keep_rows(act, new_sm_ef, sm_ef)
            # only the finishing clients' rows and slots advance; the
            # server side advances whenever anyone finishes
            new_cad, opt_c = opt.update(g_cad, state["opt_c"], cad, lr_c,
                                        norm_sum=cohort.sum)
            new_cad = _select_clients(act, any_act, new_cad, cad)
            opt_c = _select_clients(act, any_act, opt_c, state["opt_c"])
            new_sad, opt_s = opt.update(g_sad, state["opt_s"], sad, lr_s)
            new_sad = _select_any(any_act, new_sad, sad)
            opt_s = _select_any(any_act, opt_s, state["opt_s"])

            # buffer bookkeeping, on the host
            buf = torch.clamp(_host(state["buffer_mask"]) + act_h, 0.0, 1.0)
            bsteps = _host(state["buffer_steps"]) + act_h
            fill = cohort.sum(buf.sum())
            staleness = (state["global_version"]
                         - state["adapter_version"]).float()
            aggregate = bool(fill >= M)
            ver, gver = state["adapter_version"], state["global_version"]
            new_buf, new_bsteps = buf, bsteps
            if aggregate:
                agg = aggregation.fedavg(
                    model, new_cad, cuts, weights, buf,
                    steps=torch.clamp(bsteps, min=1.0), staleness=staleness,
                    staleness_power=staleness_power,
                    ranks=_state_ranks(model, state, cuts),
                    edge_assign=state.get("edge_assign"),
                    num_edges=num_edges, cohort=cohort)
                new_cad = aggregation.broadcast_after_agg(
                    model, new_cad, agg, new_sad, cuts, recv_mask=buf)
                gver = gver + 1
                ver = torch.where(buf > 0, gver, ver)
                new_buf = torch.zeros_like(buf)
                new_bsteps = bsteps * (1.0 - buf)

        new_state = dict(state)
        new_state.update(client_adapters=new_cad, server_adapters=new_sad,
                         opt_c=opt_c, opt_s=opt_s, buffer_mask=new_buf,
                         buffer_steps=new_bsteps, adapter_version=ver,
                         global_version=gver,
                         round=state["round"] + int(aggregate))
        if new_sm_ef is not None:
            new_state["smashed_ef"] = new_sm_ef
        metrics.update(total=total, fleet_total=fleet_total,
                       buffer_fill=fill, buffer_mask=buf,
                       staleness=staleness,
                       aggregated=torch.tensor(aggregate))
        return new_state, _gather_metrics(metrics, cohort)

    return step


def make_eval_step(model: Model, *, ce_chunk: int = 0, shard=None):
    """Evaluate the GLOBAL model (paper b4) on per-client eval batches.

    step(base_params, state, batch, weights) -> (per-client loss (N,),
    metrics): the inputs to the C3 rule.  The global adapters are shared
    (rank-2) leaves, so every q/k/v/o projection runs the fused LoRA
    kernel over all N * B * S tokens at once; the state's "rank_cut", if
    any, sets the serving ranks.  shard: each rank evaluates its rows of
    the cohort, and the losses and metrics come back as (N,); a MeshShard
    also runs the model on its blocks of the base weights."""
    dev = model.device
    policy = ShardingPolicy.for_model(shard, model.arch)

    @torch.no_grad()
    def step(base_params, state, batch, weights):
        cohort = _cohort_of(shard, weights)
        state = shard_state(state, cohort)
        batch = shard_client_batch(batch, cohort)
        eff = split.serve_adapters(model, state["client_adapters"],
                                   state["server_adapters"], state["cuts"],
                                   _local(cohort, weights, device=dev),
                                   rank_cut=state.get("rank_cut"),
                                   cohort=cohort)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, met = model.loss(base_params, eff, batch, ce_chunk=ce_chunk,
                               per_client=True, policy=policy)
        if not cohort.split:
            return loss, met
        met = _gather_metrics(met, cohort)
        met["aux"] = cohort.sum(met["aux"]) / cohort.world
        return met["ce"] + met["aux"], met

    return step


# ---------------------------------------------------------------------------
# state templates


def _n(state: Params) -> int:
    return state["cuts"].shape[0]


def with_error_feedback(state: Params) -> Params:
    """Attach zeroed adapter EF residuals (needed before compress='topk')."""
    return dict(state, ef=ErrorFeedback.init(state["client_adapters"]))


def with_step_budgets(state: Params) -> Params:
    """Attach the per-client local-step budgets ((N,) int32 on the host,
    needed before max_local_steps > 1).  The scheduler overwrites them
    each round; they live in state so checkpoints round-trip them."""
    return dict(state, step_budgets=torch.ones((_n(state),),
                                               dtype=torch.int32))


def with_async_buffer(state: Params) -> Params:
    """Attach the FedBuff buffer and version leaves (host tensors, needed
    before async_buffer=True): an empty buffer, every client on global
    version 0.  They live in state so checkpoints round-trip a
    mid-buffer snapshot bit for bit."""
    n = _n(state)
    return dict(state,
                buffer_mask=torch.zeros((n,), dtype=torch.float32),
                buffer_steps=torch.zeros((n,), dtype=torch.float32),
                adapter_version=torch.zeros((n,), dtype=torch.int32),
                global_version=torch.zeros((), dtype=torch.int32))


def with_per_client_opt_steps(state: Params) -> Params:
    """One client-optimizer step count per client ((N,), advanced under
    each client's own mask), so Adam's bias correction follows each
    client's actual steps.  Required by the async engine; fixes the
    shared count's over-correction for small-budget clients under local
    steps."""
    opt_c = dict(state["opt_c"])
    cnt = opt_c.get("count")
    if cnt is not None and cnt.dim() == 0:
        opt_c["count"] = torch.full((_n(state),), int(cnt),
                                    dtype=torch.int32, device=cnt.device)
    return dict(state, opt_c=opt_c)


def with_rank_cut(state: Params, r_cut: int) -> Params:
    """Attach the co-controller's per-client rank at the cut ((N,) int32
    on the host, initialized to r_cut): the engine then reads ranks from
    the state, and the controller moves them between rounds."""
    return dict(state, rank_cut=torch.full((_n(state),), int(r_cut),
                                           dtype=torch.int32))


def with_edge_assign(state: Params, num_edges: int) -> Params:
    """Attach the edge-group assignment ((N,) int32 on the host, client i
    -> edge i % num_edges) for two-tier aggregation."""
    return dict(state, edge_assign=torch.arange(_n(state), dtype=torch.int32)
                % int(num_edges))


def with_smashed_choice(state: Params, index: int = 0) -> Params:
    """Attach the co-controller's per-client compressor-bucket index
    ((N,) int32 on the host, into make_train_step's compressor_buckets)."""
    return dict(state, smashed_choice=torch.full((_n(state),), int(index),
                                                 dtype=torch.int32))


def with_topk_frac(state: Params, frac: float) -> Params:
    """Attach the co-controller's per-client topk keep fraction ((N,)
    float32 on the host, initialized uniform): the bucket boundary runs
    its topk bucket at each client's own fraction."""
    return dict(state, topk_frac=torch.full((_n(state),), float(frac),
                                            dtype=torch.float32))


def with_smashed_ef(state: Params, model: Model) -> Params:
    """Attach the zeroed smashed-channel EF residual ((N, B, S, d_model)
    on the model's device, needed for smashed topk with error
    feedback)."""
    t = model.arch.train
    return dict(state, smashed_ef=torch.zeros(
        (_n(state), t.batch_size, t.seq_len, model.arch.model.d_model),
        dtype=torch.float32, device=model.device))


def prepare_state(state: Params, *, max_local_steps: int = 1,
                  async_buffer: bool = False, rank_cut=None,
                  smashed_choice=None, topk_frac=None,
                  edge_groups: int = 1) -> Params:
    """Attach every scheduler-conditional state leaf in one place, the
    engine's state template (the reference's prepare_state).

    rank_cut / smashed_choice / topk_frac: the co-controller's initial
    per-client rank at the cut, compressor-bucket index and topk keep
    fraction (None leaves the static policy and its template)."""
    if max_local_steps > 1:
        state = with_step_budgets(state)
    if async_buffer:
        state = with_async_buffer(state)
    if max_local_steps > 1 or async_buffer:
        # clients take unequal step counts inside a round: Adam's bias
        # correction must follow each client's own count
        state = with_per_client_opt_steps(state)
    if rank_cut is not None:
        state = with_rank_cut(state, rank_cut)
    if smashed_choice is not None:
        state = with_smashed_choice(state, smashed_choice)
    if topk_frac is not None:
        state = with_topk_frac(state, topk_frac)
    if edge_groups > 1:
        state = with_edge_assign(state, edge_groups)
    return state
