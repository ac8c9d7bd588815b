"""Device layouts: the dry-run's cells and the executed meshes.

Port of src/repro/launch/mesh.py.  Functions, not module constants, and
they touch no device: importing this module or calling them needs no
card.  A layout is a ``MeshConfig`` (axis sizes and names) over
("data", "model") or ("pod", "data", "model"), one torch.distributed
rank per entry, ranks placed in row-major order
(``runtime.sharding.mesh_coords``).  The dry-run's cells read it for
their activation budget (``make_production_mesh``).  The port executes
a mesh of any shape (``make_mesh``) through a
``runtime.sharding.MeshShard`` (``launch.sharded`` starts its ranks):
the cohort's rows over "data", each client's batch rows over "pod", and
the base weights by ``param_specs`` (FSDP over ("pod", "data"); heads,
FFN width, vocabulary, experts and SSM heads over "model"; the residual
stream's sequence over "model" under sequence parallelism).
``make_client_mesh`` is the (n, 1) layout of the client axis alone
(``ClientShard``).  Serving on a mesh waits for
``repro_torch.roadmap.PARAM_SHARDING``.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.config import MeshConfig

AXES = ("data", "model")
POD_AXES = ("pod",) + AXES


def make_production_mesh(*, num_cards: int = 1) -> MeshConfig:
    """The dry-run's layout: (1, 1) for one card; (1, 4) over ("data",
    "model") for the four cards of one host, joined all to all by
    NVLink.  A MeshShard executes either as it stands."""
    if num_cards not in (1, 4):
        raise ValueError(f"num_cards must be 1 or 4, got {num_cards}")
    return MeshConfig(shape=(1, num_cards), axes=AXES)


def make_mesh(data: int = 1, model: int = 1,
              pod: Optional[int] = None) -> MeshConfig:
    """(data, model) over ("data", "model"), or with `pod` (1 included)
    (pod, data, model) over ("pod", "data", "model"): one rank per
    entry, the cohort's rows over "data", each client's batch rows over
    "pod" and the base weights of every family by param_specs over all
    the axes."""
    sizes = (data, model) if pod is None else (pod, data, model)
    if min(sizes) < 1:
        raise ValueError(f"axis sizes must be >= 1, got {sizes}")
    if pod is None:
        return MeshConfig(shape=sizes, axes=AXES)
    return MeshConfig(shape=sizes, axes=POD_AXES)


def make_client_mesh(num_cards: int = 1) -> MeshConfig:
    """(num_cards, 1) over ("data", "model"): the cohort's rows split
    over num_cards ranks (CPU processes on the host), every global leaf
    whole on each."""
    if num_cards < 1:
        raise ValueError(f"num_cards must be >= 1, got {num_cards}")
    return MeshConfig(shape=(num_cards, 1), axes=AXES)


def make_host_mesh() -> MeshConfig:
    """The 1-device layout of the CPU tests."""
    return MeshConfig(shape=(1, 1), axes=AXES)
