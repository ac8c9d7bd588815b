"""Device layouts of the dry-run's cells.

Port of src/repro/launch/mesh.py.  Functions, not module constants, and
they touch no device: importing this module or calling them needs no
card.  A layout is a ``MeshConfig`` (axis sizes and names), which is all
the port's cells read (the train cell's activation budget splits its
clients over the "data" axis).  The port shards nothing across cards
yet: the mesh functions of ``runtime/sharding.py`` and a
``torch.distributed`` process group over these axes wait for
``repro_torch.roadmap.SHARDING``.
"""

from __future__ import annotations

from repro_torch.config import MeshConfig

AXES = ("data", "model")


def make_production_mesh(*, num_cards: int = 1) -> MeshConfig:
    """(1, 1) for one card; (1, 4) over ("data", "model") for the four
    cards of one host, joined all to all by NVLink."""
    if num_cards not in (1, 4):
        raise ValueError(f"num_cards must be 1 or 4, got {num_cards}")
    return MeshConfig(shape=(1, num_cards), axes=AXES)


def make_host_mesh() -> MeshConfig:
    """The 1-device layout of the CPU tests."""
    return MeshConfig(shape=(1, 1), axes=AXES)
