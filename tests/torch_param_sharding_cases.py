"""The cases of parameter sharding (tensor parallelism over "model", FSDP
over "data") in the dense family's training round, run on every rank of
a process group (tests/test_torch_param_sharding.py spawns the ranks).

This module imports torch and the port only, so each spawned rank starts
without JAX.  ``rank_main`` runs every case under a ``MeshShard`` of the
mesh it is given, then each rank runs its share of the same cases
without a shard, and writes what it found into the output directory:

  sharded_<mesh>_<case>.pt  rank 0: the gathered state after each round
                            and the history
  bytes_<mesh>_<r>.pt       rank r: {leaf path: bytes} of its base blocks
  plain_<case>.pt           the unsharded run of the case
  raised_<mesh>.pt          rank 0: what SplitFTSystem said of each config
                            that the mesh does not execute
  placed_<mesh>_<r>.pt      rank r: {config: {leaf path: bytes}} of the
                            blocks SplitFTSystem placed for each PLACED
                            config
  ckpt_2x2_to_plain.pt,     a checkpoint of the first round saved under
  ckpt_plain_to_2x2.pt      the (2, 2) mesh and finished unsharded, and
                            the other way round
  serve_<mesh>_<case>_<r>.pt  rank r: a SERVE_CASES case's serving after
                            its rounds (torch_mesh_serving_cases.serve);
                            the plain_<case>.pt run holds its own

Every case starts from the JAX reference's weights when the output
directory holds them (``ref_<case>.pt``: the numpy trees of its base
parameters and round state), so the reference's losses compare too.

The cases, 4 clients x batch 2 x seq 32, 4 layers, d_model 64, SGD, no
smashed compression (int8 would flip codes where a sum's order moves
the last bits):
  llama_gqa   RoPE, swiglu, untied head, 4 heads of 16 over 2 KV heads
              (on 4 "model" ranks two ranks share a KV head), vocab 512
              (4 divides it), the LoRA targets extended to mlp_in/mlp_out
  opt_bias    biases on every projection (bq, bk, bv, bo, b_in, b_out),
              tied embeddings, learned positions, vocab 513 (neither 2
              nor 4 divides it: the head stays whole)
  phi_ff      tied, GQA 4 over 2, d_ff 129 (fit_spec leaves the FFN
              whole: its adapters' gradients must not be summed), the
              MLP targets too
  gpt2_remat  remat "full" and the cross entropy in chunks of 8
              positions (ce_chunk), vocab 512
  llama_local_steps  llama_gqa's model under the local-steps engine (2
              inner steps on the straggler clock's budgets)

and, on the (2, 2) mesh only, llama_gqa's model under each engine option
that the client axis runs sharded (OPTIONS: the async engine, two-tier
FedAvg, top-k and int8 adapter compression, microbatch 2, population
mode and the co-controller), against the unsharded port.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.config import MeshConfig, reduced
from repro_torch.configs import get_config
from repro_torch.core import rounds
from repro_torch.core.system import SplitFTSystem, SystemConfig
from repro_torch.runtime import agreement
from repro_torch.runtime.sharding import (MeshShard, gather_state,
                                          local_params, shard_state)
from repro_torch.tree import tree_leaves_with_path, tree_map

import torch_mesh_serving_cases as mesh_serving

ROUNDS = 2
N_CLIENTS = 4
SYS = dict(num_samples=48, eval_samples=16)
TRAIN = dict(optimizer="sgd", lr_client=0.05, lr_server=0.05)
MLP_TARGETS = ("q", "k", "v", "o", "mlp_in", "mlp_out")

LLAMA = dict(num_heads=4, num_kv_heads=2, head_dim=16)
# name -> (config, vocab, ModelConfig fields, LoRA targets, train-step
# options, SystemConfig fields)
CASES = {
    "llama_gqa": ("llama3-8b", 512, LLAMA, MLP_TARGETS, {}, {}),
    "opt_bias": ("opt-125m", 513, {}, None, {}, {}),
    "phi_ff": ("phi4-mini-3.8b", 512, dict(d_ff=129), MLP_TARGETS, {}, {}),
    "gpt2_remat": ("gpt2-small", 512, {}, None,
                   dict(remat="full", ce_chunk=8), {}),
    "llama_local_steps": ("llama3-8b", 512, LLAMA, None, {},
                          dict(scheduler="local_steps", max_local_steps=2,
                               straggler_sim=True)),
}
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
# name -> (SystemConfig fields, train-step options), on llama_gqa's model
# under the (2, 2) mesh: TP, FSDP and the client axis at once
OPTIONS = {
    "async": (dict(scheduler="async", buffer_size=2, straggler_sim=True),
              {}),
    "two_tier": (dict(edge_groups=2), {}),
    "topk": (dict(compress="topk"), {}),
    "int8": (dict(compress="int8"), {}),
    "microbatch2": ({}, dict(microbatch=2)),
    "population": (dict(population=12), {}),
    "co_controller": (dict(controller="co", rank_buckets=(2, 4),
                           compressor_buckets=("none", "int8", "fp8",
                                               "topk"),
                           continuous_topk=True, smashed_ef=False,
                           straggler_sim=True, jitter_sigma=0.0), {}),
}
OPTIONS_MESH = "2x2"

# what a mesh of more than one rank refuses: a head count the "model"
# axis does not divide, and serving a batch with a client axis (its cache
# of lead (N, B) runs on one card, as the reference's) (``refusal``)
REFUSED = {"gpt2-small (3 heads)": "ValueError",
           "gpt2-small (client axis) prefill": "NotImplementedError",
           "gpt2-small (client axis) decode_step": "NotImplementedError"}
# the cases that serve after their rounds (tests/torch_mesh_serving_cases)
SERVE_CASES = ("llama_gqa", "opt_bias")
# configs of the families that the (1, 4) mesh placed only from the MoE,
# SSM and hybrid ports on (tests/test_torch_param_sharding_families.py
# trains them) and from the audio and vlm ports on
# (tests/test_torch_param_sharding_sp.py): each builds on every mesh and
# holds param_specs' blocks
PLACED = ("kimi-k2-1t-a32b", "mamba2-780m", "zamba2-1.2b",
          "whisper-medium", "internvl2-76b")


def case_arch(name: str, reduced=reduced, get_config=get_config):
    """A case's model (either package's config functions); an option's
    is llama_gqa's."""
    cfg, vocab, model_kw, targets, _, _ = CASES.get(name,
                                                    CASES["llama_gqa"])
    arch = reduced(get_config(cfg), layers=4, d_model=64, vocab=vocab,
                   seq_len=32, batch=2)
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
    # d_model 64 where the refusal is not the head count's: 4 heads
    arch = reduced(get_config(name), layers=2,
                   d_model=48 if label.endswith("heads)") else 64,
                   vocab=256)
    if label.endswith("(3 heads)"):
        arch = arch.replace(model=dataclasses.replace(
            arch.model, num_heads=3, num_kv_heads=3, head_dim=16))
    return arch.replace(data=dataclasses.replace(arch.data,
                                                 num_clients=N_CLIENTS))


def refusal(label: str, arch, shard):
    """(exception type name, message) of what `label` asks of `arch` under
    `shard`: building its SplitFTSystem, and for a label that ends in a
    serving entry point ("prefill", "decode_step", "serve_model") that
    entry point on the rank's blocks under the model's policy; ("", "")
    when nothing raised."""
    try:
        system = SplitFTSystem(arch, SystemConfig(**SYS), seed=0,
                               device="cpu", policy=shard)
        what = label.split(" ")[-1]
        model, policy = system.model, system.model_policy
        lead = (2, 2) if "(client axis)" in label else (2,)
        tokens = torch.zeros(lead + (1,), dtype=torch.int32)
        if what == "serve_model":
            system.serve_model()
        elif what == "prefill":
            model.prefill(system.base_params, None, {"tokens": tokens},
                          model.init_cache(lead, 4), policy=policy)
        elif what == "decode_step":
            model.decode_step(system.base_params, None, tokens,
                              model.init_cache(lead, 4), policy=policy)
        return ("", "")
    except (NotImplementedError, ValueError) as e:
        return (type(e).__name__, str(e))


def placed_arch(name: str):
    """A PLACED config at a width whose heads (and SSM heads) 4 divides."""
    arch = reduced(get_config(name), layers=2, d_model=64, vocab=256)
    return arch.replace(data=dataclasses.replace(arch.data,
                                                 num_clients=N_CLIENTS))


def build(name: str, shard, out: Path, device="cpu",
          **more) -> SplitFTSystem:
    """A case's or an option's system; `more`: further SystemConfig
    fields."""
    if name in OPTIONS:
        sys_kw, step_kw = OPTIONS[name]
    else:
        step_kw, sys_kw = CASES[name][-2:]
    system = SplitFTSystem(case_arch(name),
                           SystemConfig(**SYS, **sys_kw, **more),
                           seed=0, device=device, policy=shard)
    if step_kw:
        system.train_step = rounds.make_train_step(
            system.model, smashed_compress=system.smashed_compress,
            shard=shard, **step_kw)
    ref = out / f"ref_{name}.pt"
    if ref.exists():
        params, state = torch.load(ref, weights_only=False)
        system.state = shard_state(bridge.state_from_numpy(state, device),
                                   system.cohort)
    else:
        params = _numpy(system.model.init_params(
            torch.Generator().manual_seed(0)))
    params = bridge.params_from_numpy(with_biases(params), device)
    if shard is not None:
        params = local_params(params, shard.mesh, shard)
    system.base_params = params
    return system


BIASES = ("bq", "bk", "bv", "bo", "b_in", "b_out")


def with_biases(params):
    """The numpy tree with every projection bias drawn from a seed (the
    configs start them at zero, where a bias added on the wrong side of
    a sum over ranks would not show)."""
    rng = np.random.default_rng(7)
    out = tree_map(np.copy, params)
    for keys, leaf in tree_leaves_with_path(out):
        if keys[-1] in BIASES:
            leaf[...] = 0.1 * rng.standard_normal(leaf.shape)
    return out


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy()
                    if isinstance(t, torch.Tensor) else np.asarray(t), tree)


def run_case(name: str, shard, out: Path, device="cpu") -> dict:
    """ROUNDS rounds of a case: the gathered state after each round (a
    collective under a shard) and the history; a SERVE_CASES case then
    serves (``torch_mesh_serving_cases.serve``)."""
    system = build(name, shard, out, device)
    states = []
    for _ in range(ROUNDS):
        system.run(1, log_every=0)
        states.append(_numpy(gather_state(system.state, system.cohort)))
    res = {"states": states, "history": [dict(h) for h in system.history],
           "sim_clock": system.sim_clock, "base": system.base_params}
    if name in SERVE_CASES:
        res["serve"] = mesh_serving.serve(system, device)
    return res


def base_bytes(params) -> dict:
    return {"/".join(k): x.numel() * x.element_size()
            for k, x in tree_leaves_with_path(params)}


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
        if name == "llama_gqa":
            torch.save(base_bytes(base), out / f"bytes_{mesh_name}_{rank}.pt")
    raised = {label: refusal(label, refused_arch(label), shard)
              for label in REFUSED}
    if rank == 0:
        torch.save(raised, out / f"raised_{mesh_name}.pt")
    placed = {}
    for name in PLACED:
        system = SplitFTSystem(placed_arch(name), SystemConfig(**SYS),
                               seed=0, device="cpu", policy=shard)
        placed[name] = base_bytes(system.base_params)
    torch.save(placed, out / f"placed_{mesh_name}_{rank}.pt")
    plain = []
    if mesh_name == OPTIONS_MESH:
        for name in OPTIONS:
            res = run_case(name, shard, out)
            res.pop("base")
            if rank == 0:
                torch.save(res, out / f"sharded_{mesh_name}_{name}.pt")
        checkpoints(rank, shard, out)
        plain = list(OPTIONS)
    # the unsharded runs, shared out over the ranks (the cases' once,
    # under the first mesh)
    if mesh_name == next(iter(MESHES)):
        plain = list(CASES)
    for i, name in enumerate(plain):
        if i % world == rank:
            res = run_case(name, None, out)
            res.pop("base")
            torch.save(res, out / f"plain_{name}.pt")


def _finish(system: SplitFTSystem) -> dict:
    """The second round after a restore: its records and the gathered
    state (a collective under a shard)."""
    assert system.restore()
    hist = [dict(h) for h in system.run(1, log_every=0)]
    return {"history": hist, "sim_clock": system.sim_clock,
            "state": _numpy(gather_state(system.state, system.cohort))}


def checkpoints(rank: int, shard, out: Path):
    """llama_gqa's first round checkpointed under the mesh, restored into
    one unsharded process that runs the second; and the other way
    round."""
    sharded_dir, plain_dir = out / "ck_sharded", out / "ck_plain"
    build("llama_gqa", shard, out, checkpoint_dir=str(sharded_dir),
          checkpoint_every=1).run(1, log_every=0)
    if rank == 0:
        torch.save(_finish(build("llama_gqa", None, out,
                                 checkpoint_dir=str(sharded_dir))),
                   out / "ckpt_2x2_to_plain.pt")
        build("llama_gqa", None, out, checkpoint_dir=str(plain_dir),
              checkpoint_every=1).run(1, log_every=0)
    shard.barrier()
    res = _finish(build("llama_gqa", shard, out,
                        checkpoint_dir=str(plain_dir)))
    if rank == 0:
        torch.save(res, out / "ckpt_plain_to_2x2.pt")


# the cases of tests/test_torch_cuda.py, on the card
CARD_CASES = ("llama_gqa", "opt_bias")


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
# the comparisons (repro_torch.runtime.agreement)
#
# A sharded run sums in another order: the row-parallel products' partial
# sums over "model", the vocab-parallel cross entropy's sums of
# exponentials, the adapters' gradients over "model" and the client sums
# over "data"; the FSDP gather is exact.  So each float leaf of the
# gathered state is held within RTOL and ATOL_OF_MAX x max|leaf| of the
# unsharded run's, the per-round losses within LOSS_RTOL, and every
# discrete leaf and record (cuts, round, the simulated clock, comm
# bytes) is equal, as tests/torch_sharded_cases.py holds the client axis,
# at 10x its atol: the attention backward's cancellation carries the
# reordered sums into the q and k adapters' gradients, whose B moved by
# up to 3.3e-6 x max|leaf| on 4 gloo ranks (opt_bias, both meshes).

RTOL, ATOL_OF_MAX, LOSS_RTOL = 1e-5, 1e-5, 1e-6
# on the card a rank's GEMMs run at other shapes (half the heads, the
# FFN width and the vocabulary), and cuBLAS picks its kernels by shape:
# every product's sum runs in another order, not only the sums over ranks
CARD_ATOL_OF_MAX, CARD_LOSS_RTOL = 1e-4, 1e-5


# {option: {state key: atol as a share of max|leaf|}} where ATOL_OF_MAX
# does not hold, 4x the largest gap measured on the (2, 2) mesh, as
# tests/torch_sharded_cases.py bounds the client axis's: top-k's
# error-feedback residual is a difference of adapter values up to ~50x
# its own magnitude, so the reordered sums move it by up to 3.15e-5 x
# max|leaf| in round 2 (one element of mlp_out's A).
OPTION_BOUNDS = {"topk": {"ef": 1.3e-4}}


def held(got, want, atol_of_max=ATOL_OF_MAX, loss_rtol=LOSS_RTOL,
         bounds=None):
    for a, b in zip(got["states"], want["states"], strict=True):
        agreement.check_state(a, b, rtol=RTOL, atol_of_max=atol_of_max,
                              bounds=bounds)
    agreement.check_history(got["history"], want["history"],
                            loss_rtol=loss_rtol)
    assert got["sim_clock"] == want["sim_clock"]


def same_bits(got, want):
    agreement.same_bits({k: got[k] for k in ("states", "history")},
                        {k: want[k] for k in ("states", "history")})
