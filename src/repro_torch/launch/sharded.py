"""The rank launcher: run one callable on every rank of a process group.

The counterpart of the reference's ``with mesh:``.  ``run_ranks`` spawns
one process per rank of a mesh (torch.multiprocessing, start method
"spawn"), joins each to one gloo group through a file store in a
directory that the caller gives (no TCP port to collide with another
group on the host), sets one intra-op thread per rank, runs ``fn(rank,
world, *args)`` and returns rank 0's result.  A rank finds its (data,
model) coordinates with ``runtime.sharding.mesh_coords(mesh, rank)``
(row-major, as jax.make_mesh orders devices), which is what a
``MeshShard`` built on the same mesh reads.  A rank that raises fails
the call, and torch.multiprocessing ends the other ranks.
``process_group`` joins the calling process itself, on gloo or NCCL (a
group of one on a card: NCCL refuses two ranks on one device, so ranks
that share a card run gloo).

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.sharding import MeshShard

    def train(rank, world):           # at module level: it is pickled
        shard = MeshShard(make_mesh(2, 2), device="cpu")
        system = SplitFTSystem(arch, cfg, device="cpu", policy=shard)
        return system.run(2, log_every=0)

    history = run_ranks(train, make_mesh(2, 2), "/path/to/empty/dir")
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path
from typing import Any, Callable, Sequence

import torch

from repro_torch.config import MeshConfig


@contextlib.contextmanager
def process_group(rank: int, world: int, init_dir, *,
                  backend: str = "gloo"):
    """This process as `rank` of a `world`-rank group whose file store
    lives in init_dir; the group is destroyed on exit."""
    import torch.distributed as dist
    Path(init_dir).mkdir(parents=True, exist_ok=True)
    store = Path(init_dir) / "store"
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, world: int, init_dir: str,
               args: Sequence[Any]):
    torch.set_num_threads(1)
    with process_group(rank, world, init_dir):
        out = fn(rank, world, *args)
    if rank == 0:
        torch.save(out, Path(init_dir) / "result.pt")


def run_ranks(fn: Callable, world, init_dir, *,
              args: Sequence[Any] = ()) -> Any:
    """fn(rank, world, *args) on `world` spawned gloo ranks (a count, or
    a MeshConfig: one rank per entry of the mesh); rank 0's result.
    fn must be importable at module level (spawn pickles it by name); a
    store or result that an earlier group left in init_dir is removed
    first."""
    import torch.multiprocessing as mp
    if isinstance(world, MeshConfig):
        world = world.num_devices
    init_dir = Path(init_dir)
    init_dir.mkdir(parents=True, exist_ok=True)
    for name in ("store", "result.pt"):
        if (init_dir / name).exists():
            os.remove(init_dir / name)
    mp.start_processes(_rank_main,
                       args=(fn, world, str(init_dir), tuple(args)),
                       nprocs=world, join=True, start_method="spawn")
    return torch.load(init_dir / "result.pt", weights_only=False)
