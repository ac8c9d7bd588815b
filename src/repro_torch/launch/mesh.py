"""Device layouts: the dry-run's cells and the executed meshes.

Port of src/repro/launch/mesh.py.  Functions, not module constants, and
they touch no device: importing this module or calling them needs no
card.  A layout is a ``MeshConfig`` (axis sizes and names) over
("data", "model"), one torch.distributed rank per entry, ranks placed in
row-major order (``runtime.sharding.mesh_coords``).  The dry-run's cells
read it for their activation budget (``make_production_mesh``).  The
port executes a mesh of any (data, model) shape (``make_mesh``) through
a ``runtime.sharding.MeshShard`` (``launch.sharded`` starts its ranks):
the cohort's rows over "data", and, for the dense family, the base
weights by ``param_specs`` (FSDP over "data"; heads, FFN width and
vocabulary over "model").  ``make_client_mesh`` is the (n, 1) layout of
the client axis alone (``ClientShard``).  Experts, SSM and hybrid layers
and the audio and vlm families are not split over "model" yet
(``repro_torch.roadmap.PARAM_SHARDING``).
"""

from __future__ import annotations

from repro_torch.config import MeshConfig

AXES = ("data", "model")


def make_production_mesh(*, num_cards: int = 1) -> MeshConfig:
    """The dry-run's layout: (1, 1) for one card; (1, 4) over ("data",
    "model") for the four cards of one host, joined all to all by
    NVLink.  A MeshShard executes either as it stands."""
    if num_cards not in (1, 4):
        raise ValueError(f"num_cards must be 1 or 4, got {num_cards}")
    return MeshConfig(shape=(1, num_cards), axes=AXES)


def make_mesh(data: int = 1, model: int = 1) -> MeshConfig:
    """(data, model) over ("data", "model"): data * model ranks, the
    cohort's rows over "data" and the base weights of the dense, MoE,
    SSM and hybrid families by param_specs over both axes."""
    if data < 1 or model < 1:
        raise ValueError(f"axis sizes must be >= 1, got ({data}, {model})")
    return MeshConfig(shape=(data, model), axes=AXES)


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
