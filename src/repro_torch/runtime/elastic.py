"""Elastic client membership.

A numpy copy of src/repro/runtime/elastic.py (the port imports nothing of the
JAX package); tests/test_torch_host_loop.py pins it bitwise against
the reference on seeded inputs.

The adapter stacks are allocated for `max_clients`; membership is a boolean
activity mask.  Joining/leaving clients therefore never changes any array
shape — no recompilation, no optimizer-state surgery.  A joining client's
adapter rows are re-initialized from the current global aggregate; a
leaving client simply drops out of the FedAvg weights.

Data is re-partitioned over active clients on every membership change
(the partitioner is deterministic given the member list + seed).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ClientPool:
    max_clients: int
    active: np.ndarray = None          # bool (max_clients,)
    generation: int = 0                # bumps on membership change

    def __post_init__(self):
        if self.active is None:
            self.active = np.ones(self.max_clients, bool)

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    def active_ids(self) -> np.ndarray:
        return np.where(self.active)[0]

    def leave(self, client_id: int):
        if self.active[client_id]:
            self.active = self.active.copy()
            self.active[client_id] = False
            self.generation += 1

    def join(self, client_id: Optional[int] = None) -> int:
        """Activate a slot (lowest inactive if unspecified)."""
        if client_id is None:
            inactive = np.where(~self.active)[0]
            if len(inactive) == 0:
                raise RuntimeError("pool full")
            client_id = int(inactive[0])
        if not self.active[client_id]:
            self.active = self.active.copy()
            self.active[client_id] = True
            self.generation += 1
        return client_id

    def weights(self, sample_counts: Sequence[int]) -> np.ndarray:
        """FedAvg weights over active clients (inactive -> 0)."""
        w = np.asarray(sample_counts, np.float64) * self.active
        s = w.sum()
        return w / s if s > 0 else w
