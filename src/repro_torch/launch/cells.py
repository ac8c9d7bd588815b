"""Cell builders: (architecture x shape x mesh) -> a callable and its
arguments, built without allocating them.

Port of src/repro/launch/cells.py.  A *cell* is one entry of the
assigned matrix.  Train cells run the SplitFT round step (forward and
backward through the masked split, the optimizer, FedAvg); prefill and
decode cells the serving step of the fine-tuned global model.  Every
argument is a fake tensor (``torch._subclasses.fake_tensor``: shape,
dtype and strides, no storage), made under the cell's own
``FakeTensorMode``, so a cell of any size is built in moments and
``repro_torch.roofline.counting.count`` runs ``fn`` on its arguments
without allocating them.  The model sits on the CPU device, so the
kernels' wrappers take their plain versions (counting charges each as
the kernel it stands for).

Dry-run conventions (the reference's):
  * base parameters in bf16; adapters and optimizer state fp32 in the
    train cells, the served global adapters bf16;
  * 16 federated clients for train cells;
  * remat "full" and chunked CE for train cells;
  * serve cells run the global (aggregated) adapters at rank r_others,
    here as a pool of one adapter that every row picks, the serving
    path's layout (the indexed LoRA kernel).

The round engine decides from its host leaves (``bridge.HOST_STATE``:
cuts, round, ...) on the host, so those leaves are constant fake
tensors holding the values ``rounds.init_state`` and
``rounds.prepare_state`` give them; every other leaf has no value.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.bridge import HOST_STATE
from repro_torch.config import ArchConfig, MeshConfig, ShapeConfig
from repro_torch.core import lora as lora_lib, rounds
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import (NO_SEQ_SHARD_FAMILIES, NO_SHARDING,
                                       ShardingPolicy)
from repro_torch.models.model import Model, build_model
from repro_torch.runtime import serving
from repro_torch.runtime.sharding import leaf_block

DRYRUN_CLIENTS = 16
PARAM_DTYPE = torch.bfloat16
# the reference's activation budget (11e9 bytes on a 16 GiB TPU v5e
# chip), scaled by 80 GiB / 16 GiB = 5 to one 80 GB H100
CARD_BUDGET = 11e9 * 5


class Cell(NamedTuple):
    fn: Any                      # callable(*args)
    args: Tuple                  # fake tensors (shapes and dtypes)
    model: Model
    info: Dict[str, Any]


def tune_arch_for_cell(arch: ArchConfig, shape: ShapeConfig,
                       *, num_clients: int = DRYRUN_CLIENTS) -> ArchConfig:
    train = dataclasses.replace(
        arch.train,
        batch_size=max(shape.global_batch // num_clients, 1),
        seq_len=shape.seq_len,
        remat="dots",
        dtype="bfloat16", param_dtype="bfloat16")
    data = dataclasses.replace(arch.data, num_clients=num_clients)
    return arch.replace(train=train, data=data)


def _fake_mode() -> FakeTensorMode:
    # real tensors may meet fake ones (a float learning rate, host masks)
    return FakeTensorMode(allow_non_fake_inputs=True)


def _constant(mode: FakeTensorMode, t: torch.Tensor) -> torch.Tensor:
    """A fake tensor that keeps t's value, so the host may read it."""
    return mode.fake_tensor_converter.from_real_tensor(mode, t,
                                                       make_constant=True)


def _fake_inputs(specs) -> Dict[str, torch.Tensor]:
    """Model.input_specs' {name: (shape, dtype)} as tensors (under a fake
    mode: no storage)."""
    return {k: torch.empty(shp, dtype=dt) for k, (shp, dt) in specs.items()}


# ---------------------------------------------------------------------------
# Train cell: the SplitFT round step


def _auto_microbatch(arch: ArchConfig, shape: ShapeConfig, mesh: MeshConfig,
                     num_clients: int, *, seq_shard: bool,
                     budget: float = CARD_BUDGET) -> int:
    """Pick the gradient-accumulation factor so activations fit HBM.

    Empirical activation model (calibrated on the llama3-8b dry-run):
    bytes/device ~ tokens_per_device * d_model * 2 * (2.2 * L + 20);
    the clients over "data", each client's rows over "pod", and under
    sequence parallelism the tokens over "model" (the residual stream's
    block of a rank, ``ShardingPolicy.for_stream``)."""
    m = arch.model
    axes = dict(zip(mesh.axes, mesh.shape))
    data_shards = axes.get("data", 1)
    pod_shards = axes.get("pod", 1)
    per_client_b = max(shape.global_batch // num_clients, 1)
    n_shard = max(num_clients // data_shards, 1)
    b_shard = max(per_client_b // pod_shards, 1)
    tokens_pd = n_shard * b_shard * shape.seq_len
    if seq_shard:
        tokens_pd /= axes.get("model", 1)
    layers = m.num_layers + m.num_encoder_layers
    est = tokens_pd * m.d_model * 2 * (2.2 * layers + 20)
    if m.num_experts:
        # MoE inflates activation volume by ~top_k (each token occupies
        # top_k expert slots, x1.25 capacity padding)
        est *= 1 + 0.6 * m.moe_top_k
    need = max(int(est // budget) + 1, 1)
    # round up to a divisor of the per-client batch
    a = need
    while per_client_b % a and a < per_client_b:
        a += 1
    return min(a, per_client_b)


def _train_state(mode: FakeTensorMode, model: Model, n: int, k_steps: int,
                 is_async: bool):
    """rounds.init_state + prepare_state under `mode`, the host leaves
    constant (their values from the same functions on the host)."""
    host = rounds.prepare_state(
        {"cuts": torch.full((n,), model.arch.split.cut_layer,
                            dtype=torch.int32),
         "round": torch.zeros((), dtype=torch.int32), "opt_c": {}},
        max_local_steps=k_steps, async_buffer=is_async)
    with mode:
        state = rounds.init_state(model, torch.Generator().manual_seed(0),
                                  num_clients=n)
    # prepare_state reads the clients' optimizer step count (0) on the
    # host; what it adds runs on the host too
    count = state["opt_c"]["count"]
    state["opt_c"]["count"] = _constant(
        mode, torch.zeros(count.shape, dtype=count.dtype))
    state = rounds.prepare_state(state, max_local_steps=k_steps,
                                 async_buffer=is_async)
    got = state["opt_c"]["count"]
    state["opt_c"]["count"] = count if got.shape == count.shape \
        else mode.from_tensor(got)
    state.update({k: _constant(mode, v) for k, v in host.items()
                  if k in HOST_STATE})
    return state


def build_train_cell(arch: ArchConfig, shape: ShapeConfig,
                     mesh: Optional[MeshConfig] = None,
                     *, num_clients: int = DRYRUN_CLIENTS,
                     remat: str = "full", ce_chunk: int = 512,
                     microbatch: int = 0, scheduler: str = "sync",
                     max_local_steps: int = 0, overlap_comm: bool = False,
                     seq_shard: Optional[bool] = None,
                     budget: float = CARD_BUDGET) -> Cell:
    """The round step's cell.  seq_shard: sequence parallelism on the
    mesh's "model" axis (None: the reference's rule, on unless the family
    is SSM or hybrid, whose SSD scan needs the contiguous sequence); it
    sets the activation budget's tokens per card, as the reference's."""
    mesh = mesh or make_host_mesh()
    if seq_shard is None:
        seq_shard = arch.model.family not in NO_SEQ_SHARD_FAMILIES
    k_steps = 1
    if scheduler == "local_steps":
        k_steps = max_local_steps or arch.split.max_local_steps
    is_async = scheduler == "async"
    if k_steps > 1 or is_async:
        if microbatch > 1:
            raise ValueError(
                f"scheduler={scheduler!r} does not compose with "
                "microbatch accumulation (rounds.make_train_step); "
                "drop the explicit microbatch or use scheduler='sync'")
        # the local-steps engine carries its own inner loop (and the
        # async engine is a single event tick); skip the activation-
        # budget auto-pick instead of silently accumulating
        microbatch = 1
    elif microbatch <= 0:
        microbatch = _auto_microbatch(arch, shape, mesh, num_clients,
                                      seq_shard=seq_shard, budget=budget)
    arch = tune_arch_for_cell(arch, shape, num_clients=num_clients)
    model = build_model(arch, device="cpu")
    n = num_clients
    mode = _fake_mode()

    state = _train_state(mode, model, n, k_steps, is_async)
    with mode:
        base = model.init_params(torch.Generator().manual_seed(0),
                                 dtype=PARAM_DTYPE)
        batch = _fake_inputs(model.input_specs(shape, num_clients=n,
                                               dtype=PARAM_DTYPE))
        if k_steps > 1:
            # leading (K,) step axis
            batch = {k: v.expand((k_steps,) + tuple(v.shape)).contiguous()
                     for k, v in batch.items()}
        w = torch.empty((n,), dtype=torch.float32)
        lr = torch.empty((), dtype=torch.float32)

    step = rounds.make_train_step(
        model, remat=remat, ce_chunk=ce_chunk, microbatch=microbatch,
        smashed_compress=arch.split.smashed_compress,
        smashed_topk_frac=arch.split.smashed_topk_frac,
        max_local_steps=k_steps, async_buffer=is_async,
        buffer_size=max(1, min(arch.split.async_buffer_size, n)),
        staleness_power=arch.split.staleness_power)

    args = (base, state, batch, w, w, lr, lr)
    # overlap_comm is a host-side clock model (SplitFTSystem's event
    # loop), not an engine knob: it never changes the step, so it rides
    # in `info` for provenance only
    return Cell(step, args, model=model,
                info={"kind": "train", "num_clients": n,
                      "per_client_batch": arch.train.batch_size,
                      "microbatch": microbatch, "scheduler": scheduler,
                      "max_local_steps": k_steps,
                      "overlap_comm": overlap_comm})


# ---------------------------------------------------------------------------
# Serve cells: prefill / decode of the aggregated global model


def _serve_adapters_abs(model: Model, dtype=torch.float32):
    """Rank-masked global adapter tree (rank-2 leaves + scale), drawn
    under the caller's fake mode."""
    ad = lora_lib.init_adapters(model, torch.Generator().manual_seed(0),
                                num_clients=0, dtype=dtype)
    ranks = torch.full((model.num_flat_layers,), model.arch.lora.r_others,
                       dtype=torch.int32)
    return lora_lib.mask_adapters(model, ad, ranks)


def served_adapters(adapters, batch: int):
    """The global adapter tree as the serving path takes it: a pool of
    one adapter ((Lg, 1, ...) leaves) that each of `batch` rows picks
    (``serving.attach_ids``), so every projection runs the indexed LoRA
    kernel, as a served request does."""
    pool = {g: {t: {k: v.unsqueeze(1) for k, v in ad.items()}
                for t, ad in targets.items()}
            for g, targets in adapters.items()}
    return serving.attach_ids(pool, torch.zeros((batch,), dtype=torch.int32))


def build_serve_cell(arch: ArchConfig, shape: ShapeConfig,
                     mesh: Optional[MeshConfig] = None, *,
                     seq_shard: Optional[bool] = None, shard=None) -> Cell:
    """A prefill or decode cell of the served global model.

    shard: a ``runtime.sharding.MeshShard`` (of `mesh`, or of its own
    mesh when `mesh` is None): the cell then holds this rank's blocks,
    the base weights by ``param_specs`` (``local_params``), the adapters
    at their blocks (``Model.serving_blocks``) and the cache by
    ``cache_specs`` (``local_cache``), and runs under the reference's
    serving policy: sequence parallelism for a prefill only, where
    seq_shard says (None: the reference's rule, on unless the family is
    SSM or hybrid).  Without a shard (the dry-run, on fake tensors) the
    cell is the one-card cell."""
    arch = tune_arch_for_cell(arch, shape, num_clients=1)
    b = shape.global_batch
    policy = NO_SHARDING
    if shard is not None:
        mesh = mesh or shard.mesh
        if seq_shard is None:
            seq_shard = arch.model.family not in NO_SEQ_SHARD_FAMILIES
        policy = ShardingPolicy.for_model(
            shard, arch, seq_shard=seq_shard and shape.kind == "prefill")
        model = build_model(arch, device=shard.device)
        base = model.init_params(
            torch.Generator().manual_seed(0), dtype=PARAM_DTYPE,
            place=functools.partial(leaf_block, mesh=mesh, rank=shard.rank))
        ad, policy = model.serving_blocks(
            base, _serve_adapters_abs(model, dtype=PARAM_DTYPE), policy)
        batch = {k: torch.zeros(shp, dtype=dt, device=model.device)
                 for k, (shp, dt) in model.input_specs(
                     shape, num_clients=0, dtype=PARAM_DTYPE).items()}
        cache = model.init_cache((b,), shape.seq_len, PARAM_DTYPE,
                                 policy=policy)
    else:
        model = build_model(arch, device="cpu")
        with _fake_mode():
            base = model.init_params(torch.Generator().manual_seed(0),
                                     dtype=PARAM_DTYPE)
            ad = _serve_adapters_abs(model, dtype=PARAM_DTYPE)
            batch = _fake_inputs(model.input_specs(shape, num_clients=0,
                                                   dtype=PARAM_DTYPE))
            cache = model.init_cache((b,), shape.seq_len, PARAM_DTYPE)

    if shape.kind == "prefill":
        def fn(params, adapters, batch, cache):
            with torch.no_grad():
                return model.prefill(params, served_adapters(adapters, b),
                                     batch, cache, policy=policy)
        args = (base, ad, batch, cache)
    else:  # decode: one new token against a seq_len-deep cache
        def fn(params, adapters, tokens, cache):
            with torch.no_grad():
                return model.decode_step(params,
                                         served_adapters(adapters, b),
                                         tokens, cache, policy=policy)
        args = (base, ad, batch["tokens"], cache)
    return Cell(fn, args, model=model,
                info={"kind": shape.kind, "batch": b,
                      "seq_len": shape.seq_len})


def build_cell(arch: ArchConfig, shape: ShapeConfig,
               mesh: Optional[MeshConfig] = None, **kw) -> Cell:
    if shape.kind == "train":
        return build_train_cell(arch, shape, mesh, **kw)
    for k in ("remat", "ce_chunk", "num_clients", "scheduler",
              "max_local_steps", "overlap_comm", "microbatch", "budget"):
        kw.pop(k, None)
    return build_serve_cell(arch, shape, mesh, **kw)
