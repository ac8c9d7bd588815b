"""Device layouts: the dry-run's cells and the cohort's split over cards.

Port of src/repro/launch/mesh.py.  Functions, not module constants, and
they touch no device: importing this module or calling them needs no
card.  A layout is a ``MeshConfig`` (axis sizes and names).  The
dry-run's cells read it for their activation budget
(``make_production_mesh``); ``make_client_mesh`` is the layout that the
port executes, the cohort's rows over the "data" axis, one
torch.distributed rank per entry (``runtime.sharding.ClientShard``,
``launch.sharded``).  Base weights, heads and experts are not split
over "model" yet (``repro_torch.roadmap.PARAM_SHARDING``).
"""

from __future__ import annotations

from repro_torch.config import MeshConfig

AXES = ("data", "model")


def make_production_mesh(*, num_cards: int = 1) -> MeshConfig:
    """The dry-run's layout: (1, 1) for one card; (1, 4) over ("data",
    "model") for the four cards of one host, joined all to all by
    NVLink."""
    if num_cards not in (1, 4):
        raise ValueError(f"num_cards must be 1 or 4, got {num_cards}")
    return MeshConfig(shape=(1, num_cards), axes=AXES)


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
