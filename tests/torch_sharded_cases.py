"""The cases of the client-sharded round engine, run on every rank of a
process group (tests/test_torch_sharded_engine.py spawns the ranks).

This module imports torch and the port only, so each spawned rank starts
without JAX.  ``rank_main`` runs every case under a ``ClientShard`` of the
world's ranks, then each rank runs its share of the same cases without a
shard, and writes what it found into the output directory:

  sharded_<case>.pt  rank 0: the gathered state, the history and, in
                     population mode, the store
  rows_<case>_<r>.pt rank r: the client-axis rows it holds
  plain_<case>.pt    the unsharded run of the case
  digest_<r>.pt, ckpt_4to1.pt, ckpt_1to4.pt, moe.pt: the digest
                     check, the checkpoints across world sizes and an
                     MoE round's gradients

The model is gpt2-small reduced to 4 layers, d_model 64, vocab 512, seq
32, batch 2 (the reference's tests/test_population.py ``small_arch``),
on 80 samples.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.config import reduced
from repro_torch.configs import get_config
from repro_torch.core import rounds
from repro_torch.core.system import SplitFTSystem, SystemConfig
from repro_torch.launch.mesh import make_client_mesh
from repro_torch.models.model import build_model
from repro_torch.runtime import agreement
from repro_torch.runtime.sharding import (ClientShard, cohort_of,
                                          gather_state, shard_client_batch,
                                          shard_state, state_client_axis)
from repro_torch.tree import tree_leaves_with_path, tree_map

ROUNDS = 2
SYS = dict(num_samples=80, eval_samples=16)
# SGD: a sum taken in another order moves each update by the same
# rounding.  The ADAMW_CASES train with the configs' default, AdamW with
# grad_clip 1.0 (BOUNDS says what that costs in tolerance); the clip binds
# in "local_steps_adamw" (client gradient norms up to 1.4), not in
# "sync_adamw" (0.81 and 0.62).
TRAIN = dict(optimizer="sgd", lr_client=0.05, lr_server=0.05)
ADAMW_CASES = ("sync_adamw", "local_steps_adamw")
CO = dict(controller="co", rank_buckets=(2, 4),
          compressor_buckets=("none", "int8", "fp8", "topk"),
          continuous_topk=True, smashed_ef=False, straggler_sim=True,
          jitter_sigma=0.0)

# name -> (clients, SystemConfig fields, train-step options)
CASES = {
    "sync": (4, {}, {}),
    "sync_adamw": (4, {}, {}),
    "sync_n8": (8, {}, {}),
    "int8_smashed": (4, dict(smashed_compress="int8"), {}),
    "topk": (4, dict(compress="topk"), {}),
    "int8": (4, dict(compress="int8"), {}),
    "two_tier": (4, dict(edge_groups=2), {}),
    "microbatch2": (4, {}, dict(microbatch=2)),
    "co_controller": (4, CO, {}),
    "local_steps": (4, dict(scheduler="local_steps", max_local_steps=3,
                            straggler_sim=True), {}),
    "local_steps_adamw": (4, dict(scheduler="local_steps",
                                  max_local_steps=3, straggler_sim=True),
                          {}),
    "async": (4, dict(scheduler="async", buffer_size=2,
                      straggler_sim=True), {}),
    "population": (4, dict(population=12), {}),
    # 5 does not divide 4 ranks: every rank holds the whole cohort
    "n5": (5, {}, {}),
}
# the case that starts from the JAX reference's weights, when the output
# directory holds them (REF_WEIGHTS: the numpy trees of its base
# parameters and round state)
REF_CASE = "sync"
REF_WEIGHTS = "ref_weights.pt"


def small_arch(n: int, reduced=reduced, get_config=get_config,
               train=TRAIN):
    """The cases' model (either package's config functions)."""
    arch = reduced(get_config("gpt2-small"), layers=4, d_model=64,
                   vocab=512, seq_len=32, batch=2)
    return arch.replace(data=dataclasses.replace(arch.data, num_clients=n),
                        train=dataclasses.replace(arch.train, **train))


def build(name: str, policy, out: Path, device="cpu",
          **sys_kw) -> SplitFTSystem:
    n, kw, step_kw = CASES[name]
    arch = small_arch(n, train={} if name in ADAMW_CASES else TRAIN)
    system = SplitFTSystem(arch, SystemConfig(**SYS, **kw, **sys_kw),
                           seed=0, device=device, policy=policy)
    if step_kw:
        system.train_step = rounds.make_train_step(
            system.model, smashed_compress=system.smashed_compress,
            shard=policy, **step_kw)
    if name == REF_CASE and (out / REF_WEIGHTS).exists():
        params, state = torch.load(out / REF_WEIGHTS, weights_only=False)
        system.base_params = bridge.params_from_numpy(params, device)
        system.state = shard_state(bridge.state_from_numpy(state, device),
                                   system.cohort)
    return system


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else np.asarray(t), tree)


def result(system: SplitFTSystem, hist) -> dict:
    """What the tests compare; a collective under a shard."""
    out = {"state": _numpy(gather_state(system.state, system.cohort)),
           "history": hist, "sim_clock": system.sim_clock}
    if system.store is not None:
        out["store"] = _numpy(system.store.state_tree())
    return out


def local_rows(system: SplitFTSystem) -> dict:
    return {"/".join(keys): int(x.shape[state_client_axis(keys, x.dim())])
            for keys, x in tree_leaves_with_path(system.state)
            if state_client_axis(keys, x.dim()) is not None}


def run(name: str, policy, out: Path, rounds_: int = ROUNDS, **kw):
    system = build(name, policy, out, **kw)
    return system, [dict(r) for r in system.run(rounds_, log_every=0)]


def run_case(name: str, policy, out: Path, device="cpu") -> dict:
    """ROUNDS rounds of a case: its result, with the state after the
    first round as "state_1"."""
    system, hist = run(name, policy, out, 1, device=device)
    first = result(system, hist)["state"]
    system.run(ROUNDS - 1, log_every=0)
    res = result(system, [dict(r) for r in system.history])
    res["state_1"] = first
    return system, res


def moe_round(shard) -> dict:
    """One round's loss, router loss and gradients (rounds.round_grads)
    of kimi-k2 reduced to 2 layers and 8 experts at capacity 1.25 (pairs
    are dropped), for 4 clients of 2 sequences, gathered."""
    arch = reduced(get_config("kimi-k2-1t-a32b"), layers=2, seq_len=16,
                   vocab=256, experts=8)
    arch = arch.replace(model=dataclasses.replace(arch.model,
                                                  moe_capacity_factor=1.25))
    model = build_model(arch, device="cpu")
    base = model.init_params(torch.Generator().manual_seed(0))
    n = 4
    cohort = cohort_of(shard, n)
    state = shard_state(rounds.init_state(
        model, torch.Generator().manual_seed(1), num_clients=n), cohort)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (n, 2, 17))
    batch = shard_client_batch({"tokens": tokens[..., :-1],
                                "labels": tokens[..., 1:]}, cohort)
    weights = torch.as_tensor(rng.uniform(0.5, 1.5, n), dtype=torch.float32)
    total, met, g_cad, g_sad = rounds.round_grads(
        model, base, state, batch, cohort.rows(weights), cohort=cohort)
    g_cad = gather_state({"client_adapters": g_cad}, cohort)
    return _numpy({"total": total, "aux": met["aux"],
                   "ce": cohort.gather_rows(met["ce"]),
                   "client_grads": g_cad["client_adapters"],
                   "server_grads": g_sad})


def rank_main(rank: int, world: int, out: str):
    out = Path(out)
    shard = ClientShard(make_client_mesh(world), device="cpu")
    for name in CASES:
        system, res = run_case(name, shard, out)
        if rank == 0:
            torch.save(res, out / f"sharded_{name}.pt")
        torch.save(local_rows(system), out / f"rows_{name}_{rank}.pt")

    # one rank's host decision off by one clock tick: every rank raises
    system = build("sync", shard, out)
    if rank == 1:
        system.sim_clock += 1.0
    try:
        system.run(1, log_every=0)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    torch.save(raised, out / f"digest_{rank}.pt")

    # checkpoints across world sizes: saved by 4 ranks at round 1,
    # restored into one process, and the other way round
    ck41, ck14 = out / "ck41", out / "ck14"
    run("sync", shard, out, 1, checkpoint_dir=str(ck41), checkpoint_every=1)
    if rank == 0:
        plain = build("sync", None, out, checkpoint_dir=str(ck41),
                      checkpoint_every=1)
        assert plain.restore()
        torch.save(result(plain, plain.run(1, log_every=0)),
                   out / "ckpt_4to1.pt")
        run("sync", None, out, 1, checkpoint_dir=str(ck14),
            checkpoint_every=1)
    shard.barrier()
    sharded = build("sync", shard, out, checkpoint_dir=str(ck14),
                    checkpoint_every=1)
    assert sharded.restore()
    res = result(sharded, sharded.run(1, log_every=0))
    if rank == 0:
        torch.save(res, out / "ckpt_1to4.pt")

    moe = moe_round(shard)
    if rank == 0:
        torch.save({"sharded": moe, "plain": moe_round(None)},
                   out / "moe.pt")

    # the unsharded runs, shared out over the ranks
    for i, name in enumerate(CASES):
        if i % world == rank:
            torch.save(run_case(name, None, out)[1],
                       out / f"plain_{name}.pt")


# the cases of tests/test_torch_cuda.py, on the card
CARD_CASES = ("sync", "int8_smashed", "topk", "async")


def card_rank(rank: int, world: int, out: str):
    """CARD_CASES under a gloo ClientShard of ranks that share the card,
    then the same cases unsharded, shared out over the ranks."""
    out = Path(out)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    shard = ClientShard(make_client_mesh(world), device=dev, backend="gloo")
    for name in CARD_CASES:
        system, res = run_case(name, shard, out, dev)
        if rank == 0:
            torch.save(res, out / f"sharded_{name}.pt")
        torch.save(local_rows(system), out / f"rows_{name}_{rank}.pt")
    for i, name in enumerate(CARD_CASES):
        if i % world == rank:
            torch.save(run_case(name, None, out, dev)[1],
                       out / f"plain_{name}.pt")


# ---------------------------------------------------------------------------
# the comparisons (repro_torch.runtime.agreement)
#
# A sharded run sums over clients in another order (each rank's partial
# sum, then an all-reduce over the ranks) in the weight normalization,
# the round loss, the server adapters' gradients, the clip norm, FedAvg
# and the eval adapters.  So each float leaf of the gathered state is
# held within RTOL and ATOL_OF_MAX x max|leaf| of the unsharded run's,
# and the per-round losses within LOSS_RTOL; every discrete leaf and
# record (cuts, masks, choices, budgets, versions, round, the simulated
# clock, comm bytes) is equal.

RTOL, ATOL_OF_MAX, LOSS_RTOL = 1e-5, 1e-6, 1e-6
# on the card a rank's GEMMs and reductions run at half the batch, and
# cuBLAS picks its kernels by shape: a client's rows are summed in another
# order than in the unsharded run, not only the sums over clients
# (measured up to 4.8e-6 x max|leaf| on an H100 at these cases' size)
CARD_ATOL_OF_MAX = 1e-5
# case -> (after round 1, after round 2): {top-level state key: atol as a
# share of max|leaf|} where ATOL_OF_MAX does not hold, each about 4x the
# largest gap measured on 4 gloo ranks.  AdamW's first steps divide each
# gradient element by its own magnitude (+ eps 1e-8), so an element whose
# gradient cancels to ~eps turns a rounding of the sum into a change of
# up to lr in its update (sync_adamw's adapters 5.02e-4 and 2.56e-4, its
# moments 8.2e-6 and 2.4e-5 in round 2; local_steps_adamw's adapters
# 1.5e-6 and 7.3e-6, its server moments 1.1e-6 in round 1).  The int8
# smashed quantizer rounds activations that differ in their last bits
# after round 1 onto other int8 steps, amax / 127 apart (3.37e-5 in round
# 2).  Top-k's error-feedback residual is a difference of adapter values
# up to ~50x its own magnitude (2.1e-6 in round 2).  Each bound still
# fails the run without its all-reduce: without the server gradients'
# SUM every case is off by 0.5-2x max|leaf|, and without the clip norm's
# SUM (optimizers.update(norm_sum=)) the cases where the clip binds
# (local_steps, local_steps_adamw) by 9e-3-5e-2 x max|leaf|.
BOUNDS = {
    "sync_adamw": ({"client_adapters": 2e-3, "server_adapters": 2e-3},
                   {"client_adapters": 1e-3, "server_adapters": 1e-3,
                    "opt_c": 4e-5, "opt_s": 1e-4}),
    "local_steps_adamw": ({"client_adapters": 6e-6,
                           "server_adapters": 6e-6, "opt_s": 4e-6},
                          {"client_adapters": 3e-5,
                           "server_adapters": 3e-5}),
    "int8_smashed": ({}, {"client_adapters": 2e-4}),
    "topk": ({}, {"ef": 1e-5}),
}


# on the card more int8 codes at the cut flip in round 2 (a rank's GEMMs
# at half the batch): 2.77e-4 x max|leaf| measured on an H100
CARD_BOUNDS = dict(BOUNDS, int8_smashed=({}, {"client_adapters": 1e-3,
                                              "server_adapters": 1e-3}))


def close_tree(got, want, bounds=None, atol_of_max=ATOL_OF_MAX):
    return agreement.check_state(got, want, rtol=RTOL,
                                 atol_of_max=atol_of_max, bounds=bounds)


def close_history(got, want):
    agreement.check_history(got, want, loss_rtol=LOSS_RTOL)


def held(got, want, name, atol_of_max=ATOL_OF_MAX, bounds=BOUNDS):
    """A sharded case's result against the unsharded one's."""
    b1, b2 = ({k: max(v, atol_of_max) for k, v in b.items()}
              for b in bounds.get(name, ({}, {})))
    close_tree(got["state_1"], want["state_1"], b1, atol_of_max)
    close_tree(got["state"], want["state"], b2, atol_of_max)
    if "store" in want:
        close_tree(got["store"], want["store"], b2, atol_of_max)
    close_history(got["history"], want["history"])
    assert got["sim_clock"] == want["sim_clock"]


def same_bits(got, want):
    """Two results bit for bit: states, store, histories and clock."""
    agreement.same_bits(got, want)
