"""Which round-state leaves carry a client axis, and where.

Port of the client-axis table of src/repro/runtime/sharding.py.  The
round engine's state dict mixes global leaves (server adapters, round
counter) with per-client ones; this table says which top-level keys hold
a client axis and on which axis, and runtime.population.PopulationStore
builds its per-pid slot rows from it.

The reference also shards that axis over a device mesh (``state_specs``,
``constrain_state``, ``constrain_client_batch``).  On one card those are
no-ops, so the port has only the table the store needs; its leaf paths
come from repro_torch.tree.tree_leaves_with_path.
"""

from __future__ import annotations

from typing import Optional, Tuple

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

