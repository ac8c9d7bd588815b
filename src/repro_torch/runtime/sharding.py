"""Sharding rules, and the rank layer that splits the cohort and the
base weights over torch.distributed ranks.

Port of src/repro/runtime/sharding.py.  Two halves:

* The spec tables, pure functions of a tree's shapes and a mesh's axis
  sizes, as the reference's (DESIGN.md §5 there):
    FSDP  base weights over the ("pod", "data") axes on their
          d_model-like dimension;
    TP    head, FFN and vocab dimensions over "model";
    EP    the MoE expert dimension over "model";
    client axis  the stacked per-client leaves of the round state and
          the client axis of a batch over "data";
  every rule filtered through ``fit_spec``, which drops a mesh axis that
  is absent or does not divide its dimension.  A spec is a tuple with one
  entry per tensor dimension: None, an axis name, or a tuple of names,
  which is what the reference's ``PartitionSpec`` holds.  Only shapes
  are read, so meta and fake tensors do (the dry-run's cells).

* The rank layer, the counterpart of the reference's ``constrain_state``,
  ``constrain_client_batch`` and of XLA's placement of ``param_specs``.
  A ``MeshShard`` is this process's place on a ("data", "model") or
  ("pod", "data", "model") mesh of torch.distributed ranks (row-major,
  ``mesh_coords``), with one process group per axis and one over the
  FSDP axes ("pod", "data") together.  Over "data" each rank holds its
  block of the cohort's rows of every client-axis leaf
  (``state_specs``); a ``Cohort`` is one cohort size under it, with the
  collectives the round engine needs: a sum and a max over the "data"
  ranks, and a row gather into the full cohort, built as an all-reduce
  SUM into a zero-filled (N, ...) buffer (exact: every entry is one
  rank's value plus zeros), since gloo takes only all_reduce and
  broadcast on CUDA tensors and NCCL refuses two ranks on one device.
  When N does not divide the "data" axis, ``fit_spec`` drops the axis:
  every rank then holds the whole cohort and no client collective runs,
  since a sum over ranks would count every client ``world`` times.  The
  base weights of every family are placed by ``param_specs``
  (``leaf_block``, each leaf as it is drawn; ``local_params``, a whole
  tree): FSDP over ("pod", "data") on their d_model dims (over the axes
  that ``fit_spec`` keeps, the block index pod_index * data +
  data_index where it keeps both), heads, FFN width, vocabulary and SSM
  heads over "model", the MoE experts over "model" (EP) with their ff
  dim over the FSDP axes; ``models.common.ShardingPolicy`` gathers and
  reduces them in the blocks (the experts' weights never move: their
  activations do), splits each client's batch rows over "pod"
  (``batch_specs``) and, under ``seq_shard``, the residual stream's
  sequence over "model".  Server adapters, optimizer slots and the
  round counter stay whole on every rank.  A ``ClientShard`` is the
  client axis alone (an (n, 1) mesh, every base weight whole).  A
  serving cache is placed by ``cache_specs`` (``local_cache``): the
  batch over the FSDP axes, the KV sequence, the SSM conv channels and
  state heads over "model".

Leaf paths come from repro_torch.tree.tree_leaves_with_path; joined
with "/" they are the reference's.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import roadmap
from repro_torch.config import MeshConfig
from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path

FSDP_AXES = ("pod", "data")
TP_AXIS = "model"
CLIENT_AXIS = "data"
POD_AXIS = "pod"

Spec = Tuple[Any, ...]

# ---------------------------------------------------------------------------
# Round-state client-slot rules.
#
# The round engine's state dict mixes global leaves (server adapters,
# round counter) with per-client ones.  These tables say which top-level
# keys carry a client axis and where, for the spec of the state below
# and for runtime.population.PopulationStore's per-pid slot rows.

# (N, ...) leaves: the client axis leads.
STATE_CLIENT_VECTOR_KEYS = frozenset({
    "cuts", "step_budgets", "buffer_mask", "buffer_steps",
    "adapter_version", "rank_cut", "smashed_choice", "smashed_ef",
    "edge_assign",
})
# Trees of client-stacked adapter-shaped leaves ((Lg, N, din, r)): the
# client axis is axis 1.  opt_c mirrors client_adapters leaf for leaf
# except its step counter ("count"), which is (N,) after
# with_per_client_opt_steps and a global scalar before.
STATE_CLIENT_TREE_KEYS = frozenset({"client_adapters", "ef", "opt_c"})


def state_client_axis(path: Tuple[str, ...], ndim: int) -> Optional[int]:
    """Client-axis position of a round-state leaf at `path` (top-level
    key first), or None for global leaves."""
    if not path:
        return None
    top = path[0]
    if top in STATE_CLIENT_VECTOR_KEYS:
        return 0
    if top in STATE_CLIENT_TREE_KEYS:
        if path[-1] == "count":
            return 0 if ndim == 1 else None
        return 1 if ndim >= 2 else None
    return None


# ---------------------------------------------------------------------------
# spec tables


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a MeshConfig, a mapping, or any object whose
    ``shape`` is such a mapping (a jax Mesh, the reference tests' fake)."""
    if isinstance(mesh, MeshConfig):
        return dict(zip(mesh.axes, mesh.shape))
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(mesh.shape)


def fit_spec(shape: Sequence[int], spec: Spec, mesh) -> Spec:
    """Drop axes that are absent from the mesh or do not divide the dim."""
    sizes = axis_sizes(mesh)
    out: List[Any] = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        kept, prod = [], 1
        for a in axes:
            if a in sizes and dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return tuple(out)


def state_specs(state, mesh):
    """Spec tree of the round-engine state: every client axis
    (state_client_axis) over the data mesh axis, everything else
    replicated; fit_spec drops the axis when the cohort size does not
    divide it (the divisibility fallback)."""
    def spec_of(keys, leaf):
        nd = leaf.dim()
        ax = state_client_axis(keys, nd)
        logical = tuple(CLIENT_AXIS if i == ax else None for i in range(nd))
        return fit_spec(tuple(leaf.shape), logical, mesh)

    return tree_map_with_path(spec_of, state)


def logical_spec(path: str, ndim: int) -> Spec:
    """Logical spec by parameter name; dims right-aligned to the leaf."""
    name = path.split("/")[-1]

    def pad(spec):
        return (None,) * (ndim - len(spec)) + tuple(spec)

    if name in ("tok",):
        return pad((TP_AXIS, FSDP_AXES))      # vocab TP, d FSDP
    if name in ("head",):
        return pad((FSDP_AXES, TP_AXIS))
    if name in ("pos", "enc_pos"):
        return pad((None, None))
    if name in ("wk", "wv", "xwk", "xwv"):
        # GQA KV projections: the head count rarely divides the TP axis,
        # so the out dim stays unsharded; FSDP carries the weight bytes
        return pad((FSDP_AXES, None))
    if name in ("wq", "xwq", "w_in", "w_gate",
                "in_proj", "router", "ws_in", "ws_gate"):
        return pad((FSDP_AXES, TP_AXIS))      # (.., d_in, d_out-TP)
    if name in ("wo", "xwo", "w_out", "out_proj", "ws_out"):
        return pad((TP_AXIS, FSDP_AXES))
    # MoE experts: EP over the TP axis; the FSDP axes shard the ff dim,
    # not d_model, so expert weights stay resident and only
    # activation-sized tensors move
    if name in ("we_in", "we_gate"):
        return pad((TP_AXIS, None, FSDP_AXES))   # (L,E-EP,d,ff-FSDP)
    if name in ("we_out",):
        return pad((TP_AXIS, FSDP_AXES, None))   # (L,E-EP,ff-FSDP,d)
    if name in ("bq", "b_in"):
        return pad((TP_AXIS,))
    if name in ("conv_w", "conv_b"):
        return pad((TP_AXIS,)) if ndim <= 2 else pad((None, TP_AXIS))
    if name in ("A_log", "D", "dt_bias"):
        return pad((TP_AXIS,))
    # norms, biases, scalars: replicate
    return (None,) * ndim


def param_specs(params, mesh):
    """Spec tree of the model parameters."""
    return tree_map_with_path(
        lambda keys, leaf: fit_spec(
            tuple(leaf.shape), logical_spec("/".join(keys),
                                                   leaf.dim()),
            mesh), params)


def adapter_specs(adapters, mesh, *, client_stacked: bool):
    """Adapters {group: {target: {"A", "B"}}}: server adapters ((Lg, din,
    r)) replicate; client-stacked ones ((Lg, N, din, r)) put N on the
    client/data axis."""
    def spec_of(_, leaf):
        nd = leaf.dim()
        if client_stacked and nd >= 3:
            logical = (None, CLIENT_AXIS) + (None,) * (nd - 2)
        else:
            logical = (None,) * nd
        return fit_spec(tuple(leaf.shape), logical, mesh)

    return tree_map_with_path(spec_of, adapters)


def _client_batch_spec(nd: int, *, client_dim: bool,
                       step_axis: bool = False) -> Spec:
    if client_dim:
        rest = tuple(a for a in FSDP_AXES if a != CLIENT_AXIS)
        logical = ((None,) if step_axis else ()) + (CLIENT_AXIS, rest)
    else:
        logical = (FSDP_AXES,)
    return logical + (None,) * (nd - len(logical))


def batch_specs(batch, mesh, *, client_dim: bool):
    """tokens/labels/mask ([N,]B,S[,d]) and frames/prefix embeddings:
    clients over "data" and the per-client batch over the remaining FSDP
    axes, or the batch over all FSDP axes without a client dim."""
    return tree_map_with_path(
        lambda _, leaf: fit_spec(
            tuple(leaf.shape),
            _client_batch_spec(leaf.dim(), client_dim=client_dim), mesh),
        batch)


def cache_spec(name: str, shape: Sequence[int], mesh) -> Spec:
    """The spec of one cache leaf by its name (``cache_specs``)."""
    nd = len(shape)
    if name == "len":
        return ()
    if name in ("k", "v", "xk", "xv"):
        return fit_spec(shape, (None, FSDP_AXES, TP_AXIS, None, None), mesh)
    if name == "conv":
        return fit_spec(shape, (None, FSDP_AXES) + (None,) * (nd - 3)
                        + (TP_AXIS,), mesh)
    if name == "state":
        return fit_spec(shape, (None, FSDP_AXES, TP_AXIS)
                        + (None,) * (nd - 3), mesh)
    return (None,) * nd


def cache_specs(cache, mesh):
    """KV/SSM caches: KV leaves (Lg, B, Smax, KVH, hd) put the batch over
    the FSDP axes and the sequence over "model" (sequence-parallel
    decode: KV heads rarely divide the TP axis, the sequence does); SSM
    conv (Lg, B, W, C) C over "model"; SSM state (Lg, B, H, P, N) H over
    "model"."""
    return tree_map_with_path(
        lambda keys, leaf: cache_spec(keys[-1] if keys else "",
                                      tuple(leaf.shape), mesh), cache)


# ---------------------------------------------------------------------------
# the rank layer

EXECUTED_AXES = (POD_AXIS, CLIENT_AXIS, TP_AXIS)


def mesh_coords(mesh, rank: int) -> Dict[str, int]:
    """{axis: index} of `rank` on the mesh, ranks placed in row-major
    order over the axes as listed (the order jax.make_mesh gives its
    devices)."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    idx = np.unravel_index(int(rank), tuple(sizes[a] for a in names))
    return {a: int(i) for a, i in zip(names, idx)}


def _axis_key(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_ranks(mesh, axes) -> List[List[int]]:
    """The rank groups along `axes` (one axis name, or several in the
    mesh's order, joined): each list holds the ranks that differ only in
    those coordinates, in their row-major order."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    key = [a for a in _axis_key(axes) if a in sizes]
    grid = np.arange(int(np.prod([sizes[a] for a in names]))).reshape(
        tuple(sizes[a] for a in names))
    lines = np.moveaxis(grid, [names.index(a) for a in key],
                        list(range(-len(key), 0))).reshape(
        -1, int(np.prod([sizes[a] for a in key])))
    return [[int(r) for r in line] for line in lines]


def _check_mesh(mesh):
    sizes = axis_sizes(mesh)
    wide = {a: s for a, s in sizes.items()
            if a not in EXECUTED_AXES and s > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: the port executes the {EXECUTED_AXES} "
            f"axes only: see {roadmap.PARAM_SHARDING}")
    return sizes


def _check_client_mesh(mesh):
    sizes = _check_mesh(mesh)
    wide = {a: sizes[a] for a in (POD_AXIS, TP_AXIS)
            if sizes.get(a, 1) > 1}
    if wide:
        raise NotImplementedError(
            f"mesh axes {wide}: \"model\" splits heads, the FFN and the "
            "vocabulary (param_specs) and \"pod\" each client's batch rows "
            "and the base weights' FSDP blocks, which ClientShard leaves "
            "whole: a MeshShard executes them, serving included "
            f"({roadmap.PARAM_SHARDING})")
    return sizes.get(CLIENT_AXIS, 1)


class _Axis:
    """One mesh axis (or the FSDP axes joined) as this rank sees it: its
    size, this rank's index on it and the process group over its ranks
    (None: the default group, when the axis spans every rank)."""

    def __init__(self, size: int, index: int, group=None):
        self.size, self.index, self.group = size, index, group


class MeshShard:
    """This process's rank in a torch.distributed process group over a
    ("data", "model") or ("pod", "data", "model") mesh (the reference's
    mesh under ``ShardingPolicy(mesh, client_mode=True,
    seq_shard=...)``), ranks placed in row-major order
    (``mesh_coords``).

    The cohort's rows split over "data" (``Cohort``), and the base
    weights are placed by ``param_specs`` (``leaf_block``): FSDP over
    ("pod", "data"), heads, FFN width, vocabulary, SSM heads and MoE
    experts over "model", the experts' ff dim over the FSDP axes;
    ``models.common.ShardingPolicy`` gathers and reduces them in the
    model's forward and backward, splits each client's batch rows over
    "pod" and, with `seq_shard` (None: the reference's rule, on unless
    the family is SSM or hybrid; ``ShardingPolicy.for_model``), the
    residual stream's sequence over "model".  One subgroup per axis and
    one over the FSDP axes joined (``dist.new_group``, made on every
    rank in the same order, one per distinct set of ranks); an axis that
    spans every rank uses the default group.

    `device` defaults to the card (``device.resolve_device``: the CPU
    only when named).  The default group must exist
    (``repro_torch.launch.sharded`` starts one per rank) with the mesh's
    size as its world size, on the backend that `device` takes: NCCL
    for a CUDA device, gloo for the CPU or when the caller names it (two
    ranks that share one card).  Nothing falls
    back: another backend or world size raises, and so does a mesh axis
    other than "pod", "data" and "model" larger than 1.  ``collectives``
    and ``bytes_reduced`` count this rank's collectives and the bytes it
    put into them."""

    places_params = True

    def __init__(self, mesh: MeshConfig, *, device=None,
                 backend: Optional[str] = None,
                 seq_shard: Optional[bool] = None):
        import torch.distributed as dist
        sizes = self._check(mesh)
        self.mesh = mesh
        self.seq_shard = seq_shard
        self.device = resolve_device(device)
        self.backend = backend or ("nccl" if self.device.type == "cuda"
                                   else "gloo")
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                f"{type(self).__name__} needs a torch.distributed process "
                "group; start the ranks with repro_torch.launch.sharded")
        got = dist.get_backend()
        if got != self.backend:
            raise ValueError(f"the process group runs {got!r}, but this "
                             f"shard asks for {self.backend!r}")
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        want = int(np.prod(list(sizes.values()))) if sizes else 1
        if self.world != want:
            raise ValueError(f"the mesh {sizes} has {want} ranks, the "
                             f"process group {self.world}")
        self.coords = mesh_coords(mesh, self.rank)
        self.axes: Dict[Tuple[str, ...], _Axis] = {}
        made: Dict[Tuple[Tuple[int, ...], ...], Any] = {}
        for key in [(a,) for a in EXECUTED_AXES] + [FSDP_AXES]:
            present = [a for a in key if a in sizes]
            size, index = 1, 0
            for a in present:
                size, index = size * sizes[a], index * sizes[a] + \
                    self.coords[a]
            group = None
            if 1 < size < self.world:
                lines = tuple(tuple(r) for r in axis_ranks(mesh, present))
                if lines not in made:
                    made[lines] = {line: dist.new_group(list(line))
                                   for line in lines}
                group = next(g for line, g in made[lines].items()
                             if self.rank in line)
            self.axes[key] = _Axis(size, index, group)
        self.pod_size = self.axes[(POD_AXIS,)].size
        self.pod_rank = self.axes[(POD_AXIS,)].index
        self.data_size = self.axes[(CLIENT_AXIS,)].size
        self.data_rank = self.axes[(CLIENT_AXIS,)].index
        self.model_size = self.axes[(TP_AXIS,)].size
        self.model_rank = self.axes[(TP_AXIS,)].index
        self.collectives = self.bytes_reduced = 0

    @staticmethod
    def _check(mesh):
        return _check_mesh(mesh)

    # -- collectives ----------------------------------------------------
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """A private copy of t where the backend takes it (NCCL: on the
        card; gloo: CPU or CUDA tensors as they are)."""
        if self.backend == "nccl" and t.device.type != "cuda":
            return t.to(self.device)
        return t.clone()

    def all_reduce(self, tensors: Sequence[torch.Tensor], op: str,
                   axis=CLIENT_AXIS) -> List[torch.Tensor]:
        """SUM or MAX of each tensor over the ranks of mesh axis `axis`
        (a name, or the FSDP axes as a tuple), one collective per dtype
        (the tensors packed flat).  Returns new tensors on the inputs'
        devices.  Over an axis of one rank inside a larger group it runs
        no collective."""
        import torch.distributed as dist
        ax = self.axes[_axis_key(axis)]
        if ax.size == 1 and self.world > 1:
            return [t.clone() for t in tensors]
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            parts = [tensors[i] for i in idx]
            dev = parts[0].device
            # cat makes a new tensor: the collective writes no input
            flat = torch.cat([p.reshape(-1).to(dev) for p in parts])
            if self.backend == "nccl" and flat.device.type != "cuda":
                flat = flat.to(self.device)
            dist.all_reduce(flat, op=red, group=ax.group)
            self.collectives += 1
            self.bytes_reduced += flat.numel() * flat.element_size()
            off = 0
            for i, p in zip(idx, parts):
                out[i] = flat[off:off + p.numel()].reshape(p.shape).to(
                    p.device)
                off += p.numel()
        return out

    def check_agree(self, tag: str, *arrays) -> None:
        """Raise on every rank unless every rank holds the same `arrays`:
        rank 0 broadcasts a SHA-256 digest of its own, each rank compares
        its digest with it, and a MAX over the mismatch flags makes every
        rank raise together (no rank is left waiting in a collective)."""
        import torch.distributed as dist
        h = hashlib.sha256()
        for a in arrays:
            a = np.ascontiguousarray(np.asarray(a))
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(a.tobytes())
        mine = torch.from_numpy(
            np.frombuffer(h.digest(), dtype=np.int64).copy())
        ref = self._wire(mine)
        dist.broadcast(ref, src=0)
        bad = self._wire(torch.tensor(
            [int(not torch.equal(ref.cpu(), mine))], dtype=torch.int64))
        dist.all_reduce(bad, op=dist.ReduceOp.MAX)
        self.collectives += 2
        self.bytes_reduced += ref.numel() * 8 + 8
        if int(bad.item()):
            same = torch.equal(ref.cpu(), mine)
            raise RuntimeError(
                f"the ranks' host decisions disagree at {tag}: rank "
                f"{self.rank} {'agrees with' if same else 'differs from'} "
                "rank 0")

    def barrier(self) -> None:
        import torch.distributed as dist
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index or 0])
        else:
            dist.barrier()


class ClientShard(MeshShard):
    """A MeshShard of the client axis alone, on an (n, 1) mesh: each rank
    holds its block of the cohort's rows, and every global leaf, the
    base weights included, whole (the layout that phase 16 and the
    client-axis tests run).  A "model" or "pod" axis larger than 1
    raises."""

    places_params = False

    @staticmethod
    def _check(mesh):
        _check_client_mesh(mesh)
        return _check_mesh(mesh)


def leaf_block(name: str, leaf: torch.Tensor, *, mesh,
               rank: int) -> torch.Tensor:
    """`rank`'s block of one base leaf (its path, or the last name of it,
    is all that ``logical_spec`` reads), as ``param_specs`` places it on
    the mesh (``fit_spec``'s divisibility rule included: a dim that an
    axis does not divide stays whole): a copy, so the full leaf can be
    freed.  ``Model.init_params(place=...)`` calls it on each leaf as it
    is drawn."""
    spec = fit_spec(tuple(leaf.shape), logical_spec(name, leaf.dim()), mesh)
    return _block(leaf, spec, mesh, rank).clone(
        memory_format=torch.contiguous_format)


def _block(leaf: torch.Tensor, spec: Spec, mesh, rank: int) -> torch.Tensor:
    """`rank`'s block of a leaf under `spec` (a view)."""
    sizes = axis_sizes(mesh)
    coords = mesh_coords(mesh, rank)
    out = leaf
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        index, count = 0, 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            index = index * sizes[a] + coords[a]
            count *= sizes[a]
        n = leaf.shape[dim] // count
        out = out.narrow(dim, index * n, n)
    return out


def local_params(params, mesh, shard):
    """This rank's block of every base leaf (``leaf_block``): copies, so
    the full tree can be freed.  `shard` gives the rank (a MeshShard, or
    anything with a ``rank``)."""
    return tree_map_with_path(
        lambda keys, leaf: leaf_block("/".join(keys), leaf, mesh=mesh,
                                      rank=shard.rank), params)


def cache_block(name: str, leaf: torch.Tensor, *, mesh,
                rank: int) -> torch.Tensor:
    """`rank`'s block of one cache leaf (its path, or the last name of
    it), as ``cache_specs`` places it: the batch over the FSDP axes, a
    KV leaf's sequence, the conv window's channels and the state's heads
    over "model", each where ``fit_spec`` keeps the axis; "len" whole.
    A copy."""
    spec = cache_spec(name.split("/")[-1], tuple(leaf.shape), mesh)
    return _block(leaf, spec or (None,) * leaf.dim(), mesh, rank).clone(
        memory_format=torch.contiguous_format)


def kv_seq_lo(cache, mesh, rank: int,
              names: Tuple[str, ...] = ("k", "v")) -> Optional[int]:
    """The global position of the first slot of `rank`'s block of the
    sequence of the cache leaves called `names` (the self-attention KV
    cache, or ("xk", "xv"): the cross cache, whose capacity is the
    encoder's length), or None when no such leaf's sequence is split
    (no such leaf, a "model" axis of one rank, or a capacity that
    "model" does not divide).  Every group's leaves of one name have the
    same capacity."""
    if axis_sizes(mesh).get(TP_AXIS, 1) == 1:
        return None
    for keys, leaf in tree_leaves_with_path(cache):
        if keys[-1] not in names:
            continue
        spec = cache_spec(keys[-1], tuple(leaf.shape), mesh)
        if spec[2] is None:
            return None
        n = leaf.shape[2] // axis_sizes(mesh)[TP_AXIS]
        return mesh_coords(mesh, rank)[TP_AXIS] * n
    return None


# the origin keys of a split cache: the self-attention KV block's and the
# cross cache's (``local_cache``)
SEQ_ORIGINS = {"seq_lo": ("k", "v"), "xseq_lo": ("xk", "xv")}


def local_cache(cache, mesh, shard):
    """This rank's blocks of a whole cache (``cache_block``; copies), and
    the global position of the first slot of its block where a sequence
    is split (``kv_seq_lo``), which the attention layers read: "seq_lo"
    for the KV cache, "xseq_lo" for the cross cache (each set only where
    ``fit_spec`` splits its own capacity).  "len" stays whole on every
    rank."""
    out = tree_map_with_path(
        lambda keys, leaf: cache_block("/".join(keys), leaf, mesh=mesh,
                                       rank=shard.rank), cache)
    for key, names in SEQ_ORIGINS.items():
        lo = kv_seq_lo(cache, mesh, shard.rank, names)
        if lo is not None:
            out[key] = lo
    return out


class Cohort:
    """A cohort of n clients under a MeshShard (or none): which rows of
    the client axis this rank holds, and the collectives over them, over
    the ranks of the mesh's "data" axis.

    The rows are split when the shard's "data" axis divides n (fit_spec's
    rule) and has more than one rank: the rank at "data" index r holds
    the block [r n / w, (r + 1) n / w).  `active` says whether the
    collectives run: at world size 1 they do (each is the identity on its
    value), and without a shard, or when the axis does not divide n,
    every collective returns its input and every rank holds the whole
    cohort."""

    def __init__(self, shard: Optional[MeshShard], n: int):
        self.shard = shard
        self.n = int(n)
        size, index = 1, 0
        if shard is not None:
            size = axis_sizes(shard.mesh).get(CLIENT_AXIS, 1)
            index = mesh_coords(shard.mesh, shard.rank).get(CLIENT_AXIS, 0)
        self.active = shard is not None and self.n % size == 0
        self.world = size if self.active else 1
        self.split = self.active and self.world > 1
        self.n_local = self.n // self.world
        self.lo = index * self.n_local if self.split else 0

    # -- rows -----------------------------------------------------------
    def rows(self, x, axis: int = 0):
        """This rank's rows of a full-cohort tensor or array (a view)."""
        if not self.split:
            return x
        if isinstance(x, torch.Tensor):
            return x.narrow(axis, self.lo, self.n_local)
        idx = [slice(None)] * np.ndim(x)
        idx[axis] = slice(self.lo, self.lo + self.n_local)
        return np.asarray(x)[tuple(idx)]

    def gather_rows_many(self, xs: Sequence[torch.Tensor],
                         axes: Sequence[int]) -> List[torch.Tensor]:
        """Each rank's rows into the full cohort: this rank's block
        written into a zero-filled buffer, then one SUM over ranks."""
        if not self.split:
            return list(xs)
        bufs = []
        for x, ax in zip(xs, axes):
            shape = list(x.shape)
            shape[ax] = self.n
            buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
            buf.narrow(ax, self.lo, self.n_local).copy_(x)
            bufs.append(buf)
        return self.shard.all_reduce(bufs, "sum")

    def gather_rows(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        return self.gather_rows_many([x], [axis])[0]

    # -- reductions over ranks -----------------------------------------
    def sum_many(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if not self.active:
            return list(xs)
        return self.shard.all_reduce(xs, "sum")

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.sum_many([x])[0]

    def sum_dict(self, part: Dict[Any, torch.Tensor]
                 ) -> Dict[Any, torch.Tensor]:
        """This rank's partial sums over its clients, summed over the
        ranks in one all-reduce (as they are when inactive)."""
        return dict(zip(part, self.sum_many(list(part.values()))))

    def max(self, x: torch.Tensor) -> torch.Tensor:
        if not self.active:
            return x
        return self.shard.all_reduce([x], "max")[0]


UNSHARDED = Cohort(None, 0)


def cohort_of(shard: Optional[MeshShard], n: int) -> Cohort:
    return UNSHARDED if shard is None else Cohort(shard, n)


def _client_leaves(state, size: int):
    """(key path, client axis, leaf) of every client-axis leaf whose axis
    holds `size` rows.  Every client axis of a cohort has the same n, so
    state_specs puts all of them on "data" or none (Cohort.split is its
    divisibility rule)."""
    out = []
    for keys, leaf in tree_leaves_with_path(state):
        ax = state_client_axis(keys, leaf.dim())
        if ax is not None and leaf.shape[ax] == size:
            out.append((keys, ax, leaf))
    return out


def _replace(state, new: Dict[Tuple[str, ...], Any]):
    return tree_map_with_path(lambda keys, x: new.get(keys, x), state)


def shard_state(state, cohort: Cohort):
    """This rank's state: the rows of its block of every client-axis leaf
    that state_specs puts on "data" (copies, so the full leaves can be
    freed), every other leaf as it is.  A leaf that holds the block
    already is kept, so this is idempotent (the engines call it on
    entry, as the reference's engines call constrain_state)."""
    if not cohort.split:
        return state
    new = {keys: cohort.rows(x, ax).clone(
               memory_format=torch.contiguous_format)
           for keys, ax, x in _client_leaves(state, cohort.n)}
    return _replace(state, new)


def gather_state(state, cohort: Cohort):
    """The whole cohort's state on every rank (a collective: every rank
    calls it at the same point)."""
    if not cohort.split:
        return state
    got = _client_leaves(state, cohort.n_local)
    full = cohort.gather_rows_many([x for _, _, x in got],
                                   [ax for _, ax, _ in got])
    return _replace(state, {keys: f for (keys, _, _), f in zip(got, full)})


def shard_client_batch(batch, cohort: Cohort, *, step_axis: bool = False):
    """This rank's rows of a client-stacked batch ((N, B, S) leaves, or
    (K, N, B, S) with step_axis=True under the local-steps engine),
    numpy or tensors."""
    if not cohort.split:
        return batch
    ax = 1 if step_axis else 0
    return {k: cohort.rows(v, ax) for k, v in batch.items()}
