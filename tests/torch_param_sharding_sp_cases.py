"""The cases of parameter sharding, part 3, run on every rank of a process
group (tests/test_torch_param_sharding_sp.py spawns the ranks): the
audio and vlm families under tensor parallelism, sequence parallelism
(``seq_shard``) on and off, and the "pod" axis.

This module imports torch and the port only, so each spawned rank starts
without JAX.  ``rank_main`` runs the cases of a group of meshes under a
``MeshShard`` of each, then each rank runs its share of the same cases
without a shard, and writes what it found into the output directory:

  sharded_<mesh>_<case>_<sp>.pt  rank 0: the gathered state after each
                                 round, the history and the MoE layers'
                                 routing (sp: "sp" or "tp", seq_shard on
                                 or off)
  bytes_<mesh>_<case>_<r>.pt     rank r: {leaf path: bytes} of its blocks
  plain_<case>.pt                the unsharded run of the case
  serve_<mesh>_<case>_<sp>_<r>.pt  rank r: a SERVE_CASES case's serving
                                 after its rounds
                                 (torch_mesh_serving_cases.serve); the
                                 plain_<case>.pt run holds its own

Every case starts from the JAX reference's weights when the output
directory holds them (``ref_<case>.pt``), so the reference's losses
compare too.  The audio and vlm cases feed SplitFTSystem's batches the
frontend's inputs (``with_frontend``: "frames" or "prefix" drawn from a
seed per round), which the CLIs' batches do not carry.

The cases, 4 clients x seq 32, 4 layers, d_model 64, SGD:
  whisper      whisper-medium's shape: 4 encoder and 4 decoder layers,
               4 heads of 16 (MHA), 16 frames, cut 2 (in the encoder),
               vocabulary 509 (no "model" axis divides it: the head and
               cross entropy run whole, on the sequence block under SP)
  internvl2    internvl2's shape: 4 heads over 2 KV heads, an 8-position
               prefix
  llama        a dense GQA decoder (llama3-8b's shape), MLP adapters
  llama_s30    the same at seq 30, which a "model" axis of 4 does not
               divide (SP leaves the stream whole there; 2 divides it)
  kimi         kimi-k2's shape: 8 experts, top-2, a shared expert,
               capacity 1.25 (pairs are dropped), the router loss
  zamba2       zamba2's shape (SSM layers, attention at 1), SP forced on
  gpt2_int8    gpt2 with int8 at the cut, batch 2 (the pod meshes)
  gpt2_int8_b3 the same at batch 3, which "pod" 2 does not divide (every
               pod rank holds the whole batch, no sum over "pod")
  gpt2_topk    gpt2 with top-k at the cut and its error feedback (the
               stateful hook: the residual whole on every rank)
  kimi_pod     kimi's shape with a per-expert ff of 130: over a (2, 2, 1)
               mesh its ff dim is split over "pod" alone, d_model over
               ("pod", "data")
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.config import MeshConfig, reduced
from repro_torch.configs import get_config
from repro_torch.core.system import SplitFTSystem, SystemConfig
from repro_torch.models import transformer
from repro_torch.runtime.sharding import (MeshShard, gather_state,
                                          local_params, shard_state)
from repro_torch.tree import tree_leaves_with_path

import torch_mesh_serving_cases as mesh_serving
import torch_param_sharding_family_cases as fam

ROUNDS = 2
N_CLIENTS = 4
SYS = dict(num_samples=48, eval_samples=16)
TRAIN = dict(optimizer="sgd", lr_client=0.05, lr_server=0.05)
MLP_TARGETS = ("q", "k", "v", "o", "mlp_in", "mlp_out")

# name -> (config, vocab, seq, batch, smashed, ModelConfig fields,
# LoRA targets)
CASES = {
    "whisper": ("whisper-medium", 509, 32, 2, "none", {}, None),
    "internvl2": ("internvl2-76b", 512, 32, 2, "none", {}, None),
    "llama": ("llama3-8b", 512, 32, 2, "none", {}, MLP_TARGETS),
    "llama_s30": ("llama3-8b", 512, 30, 2, "none", {}, MLP_TARGETS),
    "kimi": ("kimi-k2-1t-a32b", 512, 32, 2, "none",
             dict(moe_capacity_factor=1.25), None),
    "zamba2": ("zamba2-1.2b", 512, 32, 2, "none", {}, None),
    "gpt2_int8": ("gpt2-small", 512, 32, 2, "int8", {}, None),
    "gpt2_int8_b3": ("gpt2-small", 512, 32, 3, "int8", {}, None),
    "gpt2_topk": ("gpt2-small", 512, 32, 2, "topk", {}, None),
    "kimi_pod": ("kimi-k2-1t-a32b", 512, 32, 2, "none",
                 dict(moe_capacity_factor=1.25, moe_d_ff=130), None),
}
# the cases whose seq_shard on and off are held equal on the (1, 4) mesh
# (zamba2: forced on against the family's default, off)
SP_CASES = ("whisper", "internvl2", "llama", "kimi", "zamba2")
# mesh group -> {mesh name: (shape, axes, [(case, seq_shard), ...])};
# seq_shard None is the reference's rule
GROUPS = {
    "tp": {
        "1x4": ((1, 4), ("data", "model"),
                [(c, sp) for c in SP_CASES for sp in (True, False)]
                + [("llama_s30", True)]),
        "2x2": ((2, 2), ("data", "model"),
                [("whisper", None), ("internvl2", None),
                 ("llama_s30", True)]),
    },
    "pod": {
        "2x1x2": ((2, 1, 2), ("pod", "data", "model"),
                  [("gpt2_int8", None), ("gpt2_int8_b3", None),
                   ("gpt2_topk", None), ("kimi_pod", None)]),
        "2x2x1": ((2, 2, 1), ("pod", "data", "model"),
                  [("gpt2_int8", None), ("gpt2_int8_b3", None),
                   ("kimi_pod", None)]),
    },
}
# the cases that serve after their rounds (tests/torch_mesh_serving_cases):
# the audio family (its cross cache split over "model"), the vlm family,
# and the batch rows over "pod"
SERVE_CASES = ("whisper", "internvl2", "gpt2_int8")
# the cases the JAX reference runs (their losses are held too)
REF_CASES = ("whisper", "internvl2", "gpt2_int8", "gpt2_int8_b3")
MOE_CASES = ("kimi", "kimi_pod")


def sp_tag(seq_shard) -> str:
    return {None: "default", True: "sp", False: "tp"}[seq_shard]


def case_arch(name: str, reduced=reduced, get_config=get_config):
    """A case's model (either package's config functions)."""
    cfg, vocab, seq, batch, smashed, model_kw, targets = CASES[name]
    arch = reduced(get_config(cfg), layers=4, d_model=64, vocab=vocab,
                   experts=8, seq_len=seq, batch=batch)
    lora = arch.lora
    if targets is not None:
        lora = dataclasses.replace(lora, targets=targets)
    return arch.replace(
        model=dataclasses.replace(arch.model, **model_kw), lora=lora,
        data=dataclasses.replace(arch.data, num_clients=N_CLIENTS),
        train=dataclasses.replace(arch.train, **TRAIN),
        split=dataclasses.replace(arch.split, smashed_compress=smashed))


def frontend_batch(cfg, batch, seed: int):
    """`batch` with the frontend's input of an audio or vlm config:
    frames (N, B, S_enc, d) or a prefix (N, B, P, d), drawn from `seed`
    (numpy, so both packages' systems take the same)."""
    n, b = batch["tokens"].shape[:2]
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        shape, key = (n, b, cfg.encoder_seq_len, cfg.d_model), "frames"
    elif cfg.family == "vlm":
        shape, key = (n, b, cfg.frontend_prefix_len, cfg.d_model), "prefix"
    else:
        return batch
    return dict(batch, **{key: rng.standard_normal(shape).astype(
        np.float32)})


def with_frontend(system, cfg):
    """A system (either package's) whose train and eval batches carry the
    frontend's input of round r, drawn from seed r (train) and 1000 + r
    (eval)."""
    train, ev = system._train_batch, system._eval_batch
    system._train_batch = lambda r: frontend_batch(cfg, train(r), r)
    system._eval_batch = lambda r: frontend_batch(cfg, ev(r), 1000 + r)
    return system


def build(name: str, shard, out: Path, device="cpu") -> SplitFTSystem:
    arch = case_arch(name)
    system = with_frontend(
        SplitFTSystem(arch, SystemConfig(**SYS), seed=0, device=device,
                      policy=shard), arch.model)
    ref = out / f"ref_{name}.pt"
    if ref.exists():
        params, state = torch.load(ref, weights_only=False)
        system.state = shard_state(bridge.state_from_numpy(state, device),
                                   system.cohort)
    else:
        params = fam._numpy(system.model.init_params(
            torch.Generator().manual_seed(0)))
    params = bridge.params_from_numpy(params, device)
    if shard is not None:
        params = local_params(params, shard.mesh, shard)
    system.base_params = params
    return system


def pod_rows(calls, system, shard) -> list:
    """Each recorded routing call's groups (G, T, 2k), G = (clients, rows)
    of this rank, with every "pod" rank's rows where the batch rows are
    split over "pod" (one exact gather for all of them)."""
    pod = 1 if shard is None else shard.pod_size
    if pod == 1 or system.arch.train.batch_size % pod:
        return calls
    n = system.cohort.n_local
    bufs = []
    for c in calls:
        c = c.reshape((n, -1) + c.shape[1:])
        buf = torch.zeros((n, c.shape[1] * pod) + c.shape[2:],
                          dtype=c.dtype)
        buf.narrow(1, shard.pod_rank * c.shape[1], c.shape[1]).copy_(c)
        bufs.append(buf)
    got = shard.all_reduce(bufs, "sum", axis="pod")
    return [g.reshape((-1,) + g.shape[2:]) for g in got]


def run_case(name: str, shard, out: Path, device="cpu") -> dict:
    """ROUNDS rounds of a case: the gathered state after each round (a
    collective under a shard), the history, each round's routing and the
    sequence lengths of the residual stream that the attention blocks
    were handed (SP: the rank's block)."""
    system = build(name, shard, out, device)
    states, routes, seqs = [], [], set()
    attention = transformer.attention_apply

    def recording(p, adapters, x, **kw):
        seqs.add(x.shape[-2])
        return attention(p, adapters, x, **kw)

    for r in range(ROUNDS):
        transformer.attention_apply = recording
        try:
            with fam.recorded_routing() as calls:
                system.run(1, log_every=0)
        finally:
            transformer.attention_apply = attention
        calls[:] = pod_rows(calls, system, shard)
        routes.append(fam.gathered_routing(calls, system, shard,
                                           f"{name} routing round {r}"))
        states.append(fam._numpy(gather_state(system.state,
                                              system.cohort)))
    res = {"states": states, "history": [dict(h) for h in system.history],
           "sim_clock": system.sim_clock, "routes": routes,
           "seqs": sorted(seqs), "base": system.base_params}
    if name in SERVE_CASES:
        res["serve"] = mesh_serving.serve(system, device)
    return res


def base_bytes(params) -> dict:
    return {"/".join(k): x.numel() * x.element_size()
            for k, x in tree_leaves_with_path(params)}


def rank_main(rank: int, world: int, out: str, group: str):
    out = Path(out)
    plain = set()
    for mesh_name, (shape, axes, runs) in GROUPS[group].items():
        mesh = MeshConfig(shape, axes)
        for name, seq_shard in runs:
            shard = MeshShard(mesh, device="cpu", seq_shard=seq_shard)
            res = run_case(name, shard, out)
            base = res.pop("base")
            tag = f"{mesh_name}_{name}_{sp_tag(seq_shard)}"
            if name in SERVE_CASES:
                torch.save(res.pop("serve"), out / f"serve_{tag}_{rank}.pt")
            if rank == 0:
                torch.save(res, out / f"sharded_{tag}.pt")
            torch.save(base_bytes(base),
                       out / f"bytes_{mesh_name}_{name}_{rank}.pt")
            plain.add(name)
    # the unsharded runs, shared out over the ranks
    for i, name in enumerate(sorted(plain)):
        if i % world == rank:
            res = run_case(name, None, out)
            res.pop("base")
            torch.save(res, out / f"plain_{name}.pt")


# the cases of tests/test_torch_cuda.py, on the card: group -> (mesh
# shape, axes, cases), each run by gloo ranks that share the card
CARD_GROUPS = {"tp": ((1, 2), ("data", "model"), ("whisper", "internvl2")),
               "pod": ((2, 1, 2), ("pod", "data", "model"), ("gpt2_int8",))}


def card_rank(rank: int, world: int, out: str, group: str):
    """A CARD_GROUPS group's cases under a gloo MeshShard of ranks that
    share the card, then the same cases unsharded, shared out over the
    ranks."""
    out = Path(out)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    shape, axes, names = CARD_GROUPS[group]
    for name in names:
        shard = MeshShard(MeshConfig(shape, axes), device=dev,
                          backend="gloo")
        res = run_case(name, shard, out, dev)
        res.pop("base")
        if rank == 0:
            torch.save(res, out / f"card_sharded_{name}.pt")
    for i, name in enumerate(names):
        if i % world == rank:
            res = run_case(name, None, out, dev)
            res.pop("base")
            torch.save(res, out / f"card_plain_{name}.pt")


# ---------------------------------------------------------------------------
# the comparisons (repro_torch.runtime.agreement), at
# tests/torch_param_sharding_cases.py's tolerances

RTOL, ATOL_OF_MAX, LOSS_RTOL = fam.RTOL, fam.ATOL_OF_MAX, fam.LOSS_RTOL
# int8 at the cut: a 1-ulp difference before the quantizer (the order of
# a sum over ranks) can move a code by one step, as in
# tests/torch_sharded_cases.py's int8_smashed case.  Measured from the
# reference's weights: gpt2_int8_b3 2.1e-3 x max|leaf| on (2, 1, 2) and
# 1.0e-4 on (2, 2, 1) (the second round's client adapters), losses
# 2.2e-6 apart; gpt2_int8 9.4e-7 (no code moved); from the port's own
# init gpt2_int8 1.9e-3 on (2, 1, 2).  Bounded at ~4x.
INT8_BOUND = (8e-3, 1e-5)
BOUNDS = {"gpt2_int8": INT8_BOUND, "gpt2_int8_b3": INT8_BOUND}


# on the card, as tests/torch_param_sharding_cases.py's
CARD_ATOL_OF_MAX, CARD_LOSS_RTOL = fam.CARD_ATOL_OF_MAX, fam.CARD_LOSS_RTOL


def held(got, want, name, card=False):
    """Returns the largest |diff| / max|leaf| over the rounds' leaves."""
    atol, loss_rtol = BOUNDS.get(
        name, (CARD_ATOL_OF_MAX, CARD_LOSS_RTOL) if card
        else (ATOL_OF_MAX, LOSS_RTOL))
    return fam.held(got, want, atol_of_max=atol, loss_rtol=loss_rtol)


def same_bits(got, want):
    fam.same_bits(got, want)


def same_routing(got, want):
    return fam.same_routing(got, want)

