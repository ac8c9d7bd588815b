"""The cases of parameter sharding in the MoE, SSM and hybrid families'
training round (expert parallelism over "model" with the experts' ff dim
over "data", tensor parallelism over the SSM heads), run on every rank of
a process group (tests/test_torch_param_sharding_families.py spawns the
ranks).

This module imports torch and the port only, so each spawned rank starts
without JAX.  ``rank_main`` runs every case under a ``MeshShard`` of the
mesh it is given, then each rank runs its share of the same cases
without a shard, and writes what it found into the output directory:

  sharded_<mesh>_<case>.pt  rank 0: the gathered state after each round,
                            the history and the MoE layers' routing
  bytes_<mesh>_<case>_<r>.pt  rank r: {leaf path: bytes} of its blocks
  mutant_<mesh>_<case>.pt   rank 0: an SSM case run with the gated norm's
                            "model" sum skipped
  shared_<mesh>.pt          rank 0: the shared expert's adapter gradients
                            with and without their "model" sum, and
                            unsharded
  plain_<case>.pt           the unsharded run of the case
  raised_<mesh>.pt          rank 0: what SplitFTSystem said of each config
                            that the mesh does not execute
  serve_<mesh>_<case>_<r>.pt  rank r: a SERVE_CASES case's serving after
                            its rounds (torch_mesh_serving_cases.serve);
                            the plain_<case>.pt run holds its own

Every case starts from the JAX reference's weights when the output
directory holds them (``ref_<case>.pt``), so the reference's losses
compare too.

The cases, 4 clients x batch 2 x seq 32, 4 layers, d_model 64, SGD, no
smashed compression:
  kimi_moe      kimi-k2's shape: 8 experts, top-2, one shared expert
                (swiglu), 4 heads of 16 over 2 KV heads, capacity 1.25
                (pairs are dropped), the router loss
  llama4_moe    llama4's shape: top-1, 20 heads of 16 over 4 KV heads
                (GQA 5:1; 4 and 2 divide 20), capacity 1.25
  mamba2_ssm    mamba2's shape: 8 SSM heads of 16, state 16, chunk 16 (2
                chunks); in_proj's 296 columns and the conv's 160
                channels split off head boundaries
  zamba2_hybrid zamba2's shape: SSM layers with an attention layer at 1
                (4 heads of 16, gelu MLP), the SSM and attention LoRA
                targets

Routing: every MoE layer's top-k choices and drops are recorded on each
rank, gathered over "data" after each round, checked equal on every rank
(``MeshShard.check_agree``) and saved, to be held equal to the unsharded
run's.
"""

from __future__ import annotations

import contextlib
import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.config import MeshConfig, reduced
from repro_torch.configs import get_config
from repro_torch.core.system import SplitFTSystem, SystemConfig
from repro_torch.models import transformer
from repro_torch.models.common import ShardingPolicy
from repro_torch.runtime import agreement
from repro_torch.runtime.sharding import (MeshShard, gather_state,
                                          local_params, shard_state)
from repro_torch.tree import tree_leaves_with_path, tree_map
from torch_param_sharding_cases import refusal

import torch_mesh_serving_cases as mesh_serving

ROUNDS = 2
N_CLIENTS = 4
SYS = dict(num_samples=48, eval_samples=16)
TRAIN = dict(optimizer="sgd", lr_client=0.05, lr_server=0.05)
CAPACITY = 1.25

# name -> (config, ModelConfig fields, LoRA targets)
CASES = {
    "kimi_moe": ("kimi-k2-1t-a32b", dict(moe_capacity_factor=CAPACITY),
                 None),
    "llama4_moe": ("llama4-maverick-400b-a17b",
                   dict(num_heads=20, num_kv_heads=4, head_dim=16,
                        moe_capacity_factor=CAPACITY), None),
    "mamba2_ssm": ("mamba2-780m", {}, None),
    "zamba2_hybrid": ("zamba2-1.2b", {}, None),
}
MOE_CASES = ("kimi_moe", "llama4_moe")
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}

# what a mesh of more than one rank refuses: SSM heads the "model" axis
# does not divide, and a decode step with a client axis (its cache of
# lead (N, B) runs on one card, as the reference's)
# (torch_param_sharding_cases.refusal)
REFUSED = {"mamba2-780m (3 SSM heads)": "ValueError",
           "mamba2-780m (client axis) decode_step": "NotImplementedError"}
# the cases that serve after their rounds (tests/torch_mesh_serving_cases)
SERVE_CASES = ("kimi_moe", "mamba2_ssm", "zamba2_hybrid")


def case_arch(name: str, reduced=reduced, get_config=get_config):
    """A case's model (either package's config functions)."""
    cfg, model_kw, targets = CASES[name]
    arch = reduced(get_config(cfg), layers=4, d_model=64, vocab=512,
                   experts=8, seq_len=32, batch=2)
    lora = arch.lora
    if targets is not None:
        lora = dataclasses.replace(lora, targets=targets)
    return arch.replace(
        model=dataclasses.replace(arch.model, **model_kw), lora=lora,
        data=dataclasses.replace(arch.data, num_clients=N_CLIENTS),
        train=dataclasses.replace(arch.train, **TRAIN),
        split=dataclasses.replace(arch.split, smashed_compress="none"))


def refused_arch(label: str):
    name = label.split(" ")[0]
    three = label.endswith("(3 SSM heads)")
    # d_model 64: 8 SSM heads of 16, which every mesh divides
    arch = reduced(get_config(name), layers=2, d_model=48 if three else 64,
                   vocab=256)
    if three:
        # d_inner 96 over heads of 32
        arch = arch.replace(model=dataclasses.replace(
            arch.model, ssm_head_dim=32))
    return arch.replace(data=dataclasses.replace(arch.data,
                                                 num_clients=N_CLIENTS))


def build(name: str, shard, out: Path, device="cpu") -> SplitFTSystem:
    system = SplitFTSystem(case_arch(name), SystemConfig(**SYS), seed=0,
                           device=device, policy=shard)
    ref = out / f"ref_{name}.pt"
    if ref.exists():
        params, state = torch.load(ref, weights_only=False)
        system.state = shard_state(bridge.state_from_numpy(state, device),
                                   system.cohort)
    else:
        params = _numpy(system.model.init_params(
            torch.Generator().manual_seed(0)))
    params = bridge.params_from_numpy(params, device)
    if shard is not None:
        params = local_params(params, shard.mesh, shard)
    system.base_params = params
    return system


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else np.asarray(t), tree)


@contextlib.contextmanager
def recorded_routing():
    """While open, every MoE layer's routing (transformer.moe_route) adds
    its top-k choices and drop flags, (G, T, 2k) int64, to the yielded
    list."""
    calls = []
    route = transformer.moe_route

    def recording(cfg, yg, router, **kw):
        got = route(cfg, yg, router, **kw)
        _, _, topi, pos, cap = got
        calls.append(torch.cat([topi, (pos >= cap).long()], -1).cpu())
        return got

    transformer.moe_route = recording
    try:
        yield calls
    finally:
        transformer.moe_route = route


def gathered_routing(calls, system, shard, tag: str) -> list:
    """One round's recorded calls, each (G, T, 2k) with every "data"
    rank's groups (the cohort's rows are the groups' leading factor, one
    all-reduce for all), the same on every rank (check_agree raises on
    every rank otherwise)."""
    cohort = system.cohort
    if cohort.split:
        calls = cohort.gather_rows_many(
            [c.reshape((cohort.n_local, -1) + c.shape[1:]) for c in calls],
            [0] * len(calls))
        calls = [c.reshape((-1,) + c.shape[2:]) for c in calls]
    calls = [c.numpy() for c in calls]
    if shard is not None:
        shard.check_agree(tag, *calls)
    return calls


def run_case(name: str, shard, out: Path, device="cpu") -> dict:
    """ROUNDS rounds of a case: the gathered state after each round (a
    collective under a shard), the history and each round's routing."""
    system = build(name, shard, out, device)
    states, routes = [], []
    for r in range(ROUNDS):
        with recorded_routing() as calls:
            system.run(1, log_every=0)
        routes.append(gathered_routing(calls, system, shard,
                                       f"{name} routing round {r}"))
        states.append(_numpy(gather_state(system.state, system.cohort)))
    res = {"states": states, "history": [dict(h) for h in system.history],
           "sim_clock": system.sim_clock, "routes": routes,
           "base": system.base_params}
    if name in SERVE_CASES:
        with recorded_routing() as calls:
            res["serve"] = mesh_serving.serve(system, device)
        res["serve"]["routes"] = [c.numpy() for c in calls]
    return res


def base_bytes(params) -> dict:
    return {"/".join(k): x.numel() * x.element_size()
            for k, x in tree_leaves_with_path(params)}


def mutant_no_norm_sum(name: str, shard, out: Path) -> dict:
    """A case run with the gated RMSNorm's "model" sum skipped: each rank
    normalises by its own heads."""
    keep = ShardingPolicy.sum_tp
    ShardingPolicy.sum_tp = lambda self, x: x
    try:
        return run_case(name, shard, out)
    finally:
        ShardingPolicy.sum_tp = keep


SHARED_TARGETS = ("mlp_in", "mlp_gate", "mlp_out")


def shared_expert_grads(shard, out: Path) -> dict:
    """kimi_moe's model with adapters on the shared expert (the configs'
    adapter_spec gives an MoE group none, so they are added here): the
    gradients of one loss over the cohort of every LoRA leaf, unsharded
    (every rank holds the whole cohort here), and under the shard with
    the partial targets' "model" sum and without the shared expert's."""
    system = build("kimi_moe", shard, out)
    model = system.model
    cfg = model.cfg
    gen = torch.Generator().manual_seed(5)
    sf = cfg.moe_d_ff * cfg.num_shared_experts
    lg = model.group_by_name["dec"].size
    shapes = {"q": (64, cfg.num_heads * cfg.head_dim),
              "mlp_in": (64, sf), "mlp_gate": (64, sf), "mlp_out": (sf, 64)}
    adapters = {"dec": {t: {"A": 0.1 * torch.randn(lg, i, 4, generator=gen),
                            "B": 0.1 * torch.randn(lg, 4, o, generator=gen),
                            "scale": torch.full((lg,), 2.0)}
                        for t, (i, o) in shapes.items()}}
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (N_CLIENTS, 2, 32)), dtype=torch.int32)}
    batch["labels"] = torch.roll(batch["tokens"], -1, -1)
    full = bridge.params_from_numpy(
        torch.load(out / "ref_kimi_moe.pt", weights_only=False)[0]
        if (out / "ref_kimi_moe.pt").exists()
        else _numpy(model.init_params(torch.Generator().manual_seed(0))),
        "cpu")

    def grads(params, rows, policy):
        leaves = {(t, m): adapters["dec"][t][m].detach().requires_grad_(True)
                  for t in shapes for m in ("A", "B")}
        ad = {"dec": {t: {"A": leaves[(t, "A")], "B": leaves[(t, "B")],
                          "scale": adapters["dec"][t]["scale"]}
                      for t in shapes}}
        b = {k: v.narrow(0, rows[0], rows[1]) for k, v in batch.items()}
        with torch.enable_grad():
            loss, _ = model.loss(params, ad, b, policy=policy)
            g = torch.autograd.grad(loss, list(leaves.values()))
        return dict(zip(leaves, g))

    want = grads(full, (0, N_CLIENTS), ShardingPolicy())
    policy = ShardingPolicy.for_model(shard, system.arch)
    parts = policy.partial_targets(cfg, system.base_params)
    # the cohort's rows over "data": a rank's loss is its rows' mean
    n_local = N_CLIENTS // shard.data_size
    got = grads(system.base_params, (shard.data_rank * n_local, n_local),
                policy)
    keys = list(got)
    summed_model = dict(zip(keys, policy.tp_sum_many(
        [got[k] for k in keys])))
    kept = {k: (summed_model[k] if ("dec", k[0]) in parts
                and k[0] not in SHARED_TARGETS else got[k]) for k in keys}
    res = {}
    for tag, g in (("summed", summed_model), ("unsummed", kept)):
        vals = shard.all_reduce([g[k] / shard.data_size for k in keys],
                                "sum", axis="data")
        res[tag] = {f"{t}/{m}": v.numpy() for (t, m), v in zip(keys, vals)}
    res["plain"] = {f"{t}/{m}": v.numpy() for (t, m), v in want.items()}
    res["partial"] = sorted(t for g, t in parts)
    return res


def rank_main(rank: int, world: int, out: str, mesh_name: str):
    out = Path(out)
    mesh = MeshConfig(MESHES[mesh_name], ("data", "model"))
    shard = MeshShard(mesh, device="cpu")
    for name in CASES:
        res = run_case(name, shard, out)
        base = res.pop("base")
        if name in SERVE_CASES:
            torch.save(res.pop("serve"),
                       out / f"serve_{mesh_name}_{name}_{rank}.pt")
        if rank == 0:
            torch.save(res, out / f"sharded_{mesh_name}_{name}.pt")
        torch.save(base_bytes(base),
                   out / f"bytes_{mesh_name}_{name}_{rank}.pt")
    res = mutant_no_norm_sum("mamba2_ssm", shard, out)
    res.pop("base")
    if rank == 0:
        torch.save(res, out / f"mutant_{mesh_name}_mamba2_ssm.pt")
    res = shared_expert_grads(shard, out)
    if rank == 0:
        torch.save(res, out / f"shared_{mesh_name}.pt")
    raised = {label: refusal(label, refused_arch(label), shard)
              for label in REFUSED}
    if rank == 0:
        torch.save(raised, out / f"raised_{mesh_name}.pt")
    # the unsharded runs, shared out over the ranks, once (first mesh)
    if mesh_name == next(iter(MESHES)):
        for i, name in enumerate(CASES):
            if i % world == rank:
                res = run_case(name, None, out)
                res.pop("base")
                torch.save(res, out / f"plain_{name}.pt")


# the cases of tests/test_torch_cuda.py, on the card: the flash kernels
# take head dims of 16 to 128, which the cases' 16 is
CARD_CASES = ("kimi_moe", "zamba2_hybrid")


def card_rank(rank: int, world: int, out: str):
    """CARD_CASES under a gloo MeshShard of ranks that share the card on a
    (1, world) mesh, then the same cases unsharded, shared out over the
    ranks."""
    out = Path(out)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    shard = MeshShard(MeshConfig((1, world), ("data", "model")),
                      device=dev, backend="gloo")
    for name in CARD_CASES:
        res = run_case(name, shard, out, dev)
        res.pop("base")
        if rank == 0:
            torch.save(res, out / f"card_sharded_{name}.pt")
    for i, name in enumerate(CARD_CASES):
        if i % world == rank:
            res = run_case(name, None, out, dev)
            res.pop("base")
            torch.save(res, out / f"card_plain_{name}.pt")


# ---------------------------------------------------------------------------
# the comparisons (repro_torch.runtime.agreement), at
# tests/torch_param_sharding_cases.py's tolerances: the router's logits
# are gathered exactly, so every rank routes as the unsharded run does
# (the routing is held equal), and what moves is the order of the sums
# over "model" (the routed and shared experts' partial outputs, the SSM's
# out_proj and gated-norm sum of squares, the adapters' gradients) and
# over "data" (the experts' ff blocks)

RTOL, ATOL_OF_MAX, LOSS_RTOL = 1e-5, 1e-5, 1e-6
# on the card, as tests/torch_param_sharding_cases.py's
CARD_ATOL_OF_MAX, CARD_LOSS_RTOL = 1e-4, 1e-5


def held(got, want, atol_of_max=ATOL_OF_MAX, loss_rtol=LOSS_RTOL):
    """Returns the largest |diff| / max|leaf| over the rounds' leaves."""
    gaps = [agreement.check_state(a, b, rtol=RTOL, atol_of_max=atol_of_max)
            for a, b in zip(got["states"], want["states"], strict=True)]
    agreement.check_history(got["history"], want["history"],
                            loss_rtol=loss_rtol)
    assert got["sim_clock"] == want["sim_clock"]
    return max(v for g in gaps for v, _ in g.values())


def same_routing(got, want):
    """Every round's choices and drops equal; returns the dropped
    pairs' count over the run."""
    dropped = 0
    for ra, rb in zip(got["routes"], want["routes"], strict=True):
        for a, b in zip(ra, rb, strict=True):
            np.testing.assert_array_equal(a, b)
            dropped += int(a[..., a.shape[-1] // 2:].sum())
    return dropped


def same_bits(got, want):
    agreement.same_bits({k: got[k] for k in ("states", "history")},
                        {k: want[k] for k in ("states", "history")})
    same_routing(got, want)
