"""Fleet-scale client population: per-pid slots and cohort sampling.

Port of src/repro/runtime/population.py.  Production cross-device FL
never trains the whole fleet: each round a seeded sampler draws a
*cohort* of C clients from a population of P, and every client carries
state that must survive cohort churn: adapter rows, optimizer slots, EF
residuals, the co-controller's (cut, rank, compressor) assignment,
speed and bandwidth draws, and the data cursor (the batch index the
client consumes next).

The round engine's client axis is the cohort axis (size C).  The host
pieces here bridge population and engine:

  CohortSampler     seeded without-replacement draw of C pids per round,
                    the reference's numpy draw exactly; its RNG state
                    round-trips through checkpoint metadata.
  PopulationStore   sparse pid -> slot map (a slot is made on a pid's
                    first draw).  gather() assembles C slots into engine
                    state before the step; scatter() writes the cohort's
                    rows back after.  Which state leaves are per-client,
                    and on which axis, comes from
                    runtime.sharding.state_client_axis.

Slot rows live in host memory: a population can far outgrow the card (a
full-width gpt2-small slot holds the client adapters and AdamW's two
moments, 13.5 MiB).  gather stacks the cohort's rows of a leaf into one
pinned buffer and copies it to the leaf's device in one transfer;
scatter copies each leaf back in one transfer and keeps per-pid copies,
never views of engine tensors, so slots outside the cohort stay bit for
bit as they were and later in-place updates of the engine cannot reach
them.  Leaves that are host tensors in the engine (bridge.HOST_STATE)
stay on the host.

Under client-axis sharding (runtime.sharding.ClientShard) every rank
keeps a whole store, identical on every rank since every rank runs the
same host loop on the same seed: gather() builds the whole cohort and
the system keeps its rank's rows (shard_state); scatter() takes the
cohort's rows gathered from every rank (gather_state).

A fresh pid's slot is column (pid % C) of the *initial* engine state,
so with P == C population mode starts from exactly the fleet state;
speed and bandwidth draws are keyed by pid
(straggler.population_speed_draws), stable across cohort churn.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.runtime.sharding import state_client_axis
from repro_torch.runtime.straggler import population_speed_draws
from repro_torch.tree import tree_leaves_with_path, tree_map_with_path

Params = Dict[str, Any]

# per-client state keys derived from the pids, not persistent identity:
# edge_assign is recomputed at gather time (pid % num_edges), so it never
# lives in a slot
_DERIVED_KEYS = frozenset({"edge_assign"})


class CohortSampler:
    """Seeded without-replacement cohort draw, checkpoint-resumable.

    sample() returns C sorted distinct pids.  P == C short-circuits to
    arange(C) (the fleet path) without consuming RNG state, so the
    P == C bitwise pin does not depend on how many rounds ran."""

    def __init__(self, population: int, cohort: int, *, seed: int = 0):
        if not 1 <= cohort <= population:
            raise ValueError(f"cohort size {cohort} must lie in "
                             f"[1, population={population}]")
        self.population = int(population)
        self.cohort = int(cohort)
        self.seed = int(seed)
        self._rng = np.random.RandomState(seed ^ 0x5EED5)

    def sample(self) -> np.ndarray:
        if self.cohort == self.population:
            return np.arange(self.cohort, dtype=np.int64)
        if self.cohort * 4 <= self.population:
            # rejection sampling: O(C) draws, no O(P) permutation
            picked: set = set()
            while len(picked) < self.cohort:
                need = self.cohort - len(picked)
                picked.update(
                    int(p) for p in
                    self._rng.randint(0, self.population, size=2 * need))
                while len(picked) > self.cohort:
                    picked.pop()
            return np.array(sorted(picked), dtype=np.int64)
        ids = self._rng.choice(self.population, size=self.cohort,
                               replace=False)
        return np.sort(ids).astype(np.int64)

    # -- checkpoint round-trip (plain JSON types) -----------------------
    def state_dict(self) -> Dict[str, Any]:
        alg, keys, pos, has_gauss, cached = self._rng.get_state()
        return {"population": self.population, "cohort": self.cohort,
                "alg": str(alg), "keys": [int(k) for k in keys],
                "pos": int(pos), "has_gauss": int(has_gauss),
                "cached": float(cached)}

    def load_state_dict(self, d: Dict[str, Any]):
        if int(d["population"]) != self.population:
            raise ValueError(
                f"checkpoint cohort sampler was drawn over population="
                f"{d['population']} but this run has population="
                f"{self.population}; pid identity is not transferable "
                "across population sizes — resume with the original "
                "--population or use a fresh checkpoint dir")
        if int(d["cohort"]) != self.cohort:
            raise ValueError(
                f"checkpoint cohort size {d['cohort']} != this run's "
                f"{self.cohort}; the engine's client axis is the cohort "
                "size, so resuming needs the original --cohort-size")
        self._rng.set_state((d["alg"],
                             np.asarray(d["keys"], np.uint32),
                             int(d["pos"]), int(d["has_gauss"]),
                             float(d["cached"])))


def _client_axis(keys: Tuple[str, ...], leaf) -> Optional[int]:
    """Client axis of a persistent per-client leaf (None for global and
    derived leaves)."""
    if keys and keys[0] in _DERIVED_KEYS:
        return None
    return state_client_axis(keys, leaf.dim())


def _host_copy(rows: torch.Tensor) -> torch.Tensor:
    """`rows` as a fresh contiguous host tensor, in one transfer (into
    pinned memory when it comes from the card)."""
    out = torch.empty(rows.shape, dtype=rows.dtype,
                      pin_memory=rows.is_cuda)
    return out.copy_(rows)


def _as_rows(arr) -> torch.Tensor:
    """A checkpoint's (K, ...) rows (numpy as loaded, or a tensor)."""
    if isinstance(arr, torch.Tensor):
        return arr
    return torch.from_numpy(np.array(arr))


class PopulationStore:
    """Sparse pid -> slot map over the engine state's per-client leaves.

    template_state: the INITIAL prepared engine state (cohort shape C on
    every client axis).  Fresh pids materialize from its column
    (pid % C); C also fixes the gather shape."""

    def __init__(self, population: int, template_state: Params, *,
                 seed: int = 0, speed_sigma: float = 0.5,
                 bw_mean: float = 100e6, bw_sigma: float = 0.7):
        self.population = int(population)
        self.seed = int(seed)
        self.speed_sigma = float(speed_sigma)
        self.bw_mean = float(bw_mean)
        self.bw_sigma = float(bw_sigma)
        # leaf path -> (C, ...) host rows (client axis moved to the front)
        self._template: Dict[str, torch.Tensor] = {}
        # leaf path -> (key path, client axis)
        self._axes: Dict[str, Tuple[Tuple[str, ...], int]] = {}
        for keys, leaf in tree_leaves_with_path(template_state):
            ax = _client_axis(keys, leaf)
            if ax is None:
                continue
            lp = "/".join(keys)
            self._template[lp] = _host_copy(leaf.detach().movedim(ax, 0))
            self._axes[lp] = (keys, ax)
        if not self._axes:
            raise ValueError("state has no per-client leaves")
        self.cohort = int(next(iter(self._template.values())).shape[0])
        # bytes of one slot's rows
        self.slot_bytes = sum(v[0].nbytes for v in self._template.values())
        # pid -> {"rows": {leaf path: row}, "cursor", "c3", "speed", "bw",
        # "jseed"}
        self._slots: Dict[int, Dict[str, Any]] = {}

    # -- slot lifecycle -------------------------------------------------
    def _materialize(self, pid: int) -> Dict[str, Any]:
        slot = self._slots.get(pid)
        if slot is None:
            speed, bw, jseed = population_speed_draws(
                [pid], seed=self.seed, speed_sigma=self.speed_sigma,
                bw_mean=self.bw_mean, bw_sigma=self.bw_sigma)
            # slot rows are replaced, never written in place, so a fresh
            # slot shares its template column until its first scatter
            slot = {
                "rows": {k: v[pid % self.cohort]
                         for k, v in self._template.items()},
                "cursor": 0,
                "c3": 1.0,
                "speed": float(speed[0]),
                "bw": float(bw[0]),
                "jseed": int(jseed[0]),
            }
            self._slots[pid] = slot
        return slot

    def __len__(self) -> int:
        return len(self._slots)

    # -- cohort gather/scatter ------------------------------------------
    def gather(self, state: Params, pids: Sequence[int]) -> Params:
        """The engine state with every per-client leaf restacked from the
        pids' slot rows, on the leaf's device and in its dtype (global
        leaves pass through untouched)."""
        pids = np.asarray(pids, np.int64)
        if pids.shape[0] != self.cohort:
            raise ValueError(f"cohort of {pids.shape[0]} pids does not "
                             f"fit the engine's client axis "
                             f"({self.cohort})")
        slots = [self._materialize(int(p)) for p in pids]

        def leaf(keys, x):
            lp = "/".join(keys)
            if lp not in self._axes:
                return x
            ax = self._axes[lp][1]
            rows = [s["rows"][lp] for s in slots]
            pin = x.is_cuda
            host = torch.empty((len(rows),) + tuple(rows[0].shape),
                               dtype=rows[0].dtype, pin_memory=pin)
            torch.stack(rows, out=host)
            return host.to(x.device, non_blocking=pin) \
                .movedim(0, ax).contiguous()

        return tree_map_with_path(leaf, state)

    def scatter(self, state: Params, pids: Sequence[int], *,
                cursors: Optional[Sequence[int]] = None,
                c3_weights: Optional[Sequence[float]] = None):
        """Write the cohort's post-round rows back into their slots (one
        transfer per leaf; each slot keeps its own copy).  Slots of pids
        outside the cohort are untouched."""
        pids = np.asarray(pids, np.int64)
        for lp, (keys, ax) in self._axes.items():
            leaf = state
            for k in keys:
                leaf = leaf[k]
            rows = leaf.detach().movedim(ax, 0)
            host = _host_copy(rows) if rows.is_cuda else rows
            for j, pid in enumerate(pids):
                self._slots[int(pid)]["rows"][lp] = host[j].clone(
                    memory_format=torch.contiguous_format)
        if cursors is not None:
            for j, pid in enumerate(pids):
                self._slots[int(pid)]["cursor"] = int(cursors[j])
        if c3_weights is not None:
            for j, pid in enumerate(pids):
                self._slots[int(pid)]["c3"] = float(c3_weights[j])

    # -- per-pid host-side attributes -----------------------------------
    def cursors(self, pids: Sequence[int]) -> np.ndarray:
        return np.array([self._materialize(int(p))["cursor"]
                         for p in pids], np.int64)

    def c3_weights(self, pids: Sequence[int]) -> np.ndarray:
        return np.array([self._materialize(int(p))["c3"]
                         for p in pids], np.float64)

    def speed_draws(self, pids: Sequence[int]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(speed, bandwidth, jitter seed) per pid, stable across cohort
        churn; the jitter seeds go to SpeedModel.jitter_seeds so per-round
        noise is keyed by pid, not by slot."""
        slots = [self._materialize(int(p)) for p in pids]
        return (np.array([s["speed"] for s in slots], np.float64),
                np.array([s["bw"] for s in slots], np.float64),
                np.array([s["jseed"] for s in slots], np.int64))

    # -- checkpoint round-trip ------------------------------------------
    def state_tree(self) -> Params:
        """The store as a tree for checkpoint/store.py:
        {"pids","cursors","c3","speed","bw","jseed",
         "rows":{leaf path: (K, ...)}} with K = number of slots, in the
        reference's layout.  The tree's structure does not depend on K
        (K = 0 included), so a fresh store is the donor template of any
        population checkpoint."""
        pids = sorted(self._slots)
        slots = [self._slots[p] for p in pids]
        rows = {}
        for lp, tmpl in sorted(self._template.items()):
            rows[lp] = (torch.stack([s["rows"][lp] for s in slots]) if slots
                        else torch.zeros((0,) + tuple(tmpl.shape[1:]),
                                         dtype=tmpl.dtype))
        return {
            "pids": np.asarray(pids, np.int64),
            "cursors": np.array([s["cursor"] for s in slots], np.int64),
            "c3": np.array([s["c3"] for s in slots], np.float64),
            "speed": np.array([s["speed"] for s in slots], np.float64),
            "bw": np.array([s["bw"] for s in slots], np.float64),
            "jseed": np.array([s["jseed"] for s in slots], np.int64),
            "rows": rows,
        }

    def load_state_tree(self, tree: Params):
        """Rebuild the slot map from state_tree() output (numpy arrays as
        checkpoint.load_checkpoint gives them, or tensors)."""
        pids = np.asarray(tree["pids"], np.int64)
        jarr = tree.get("jseed")
        rows = {lp: _as_rows(arr) for lp, arr in tree["rows"].items()}
        self._slots = {}
        for j, pid in enumerate(pids):
            if jarr is not None:
                js = int(np.asarray(jarr)[j])
            else:
                # a checkpoint from before the jitter seeds: the seed is a
                # pure hash of (pid, store seed), so recomputing it is exact
                js = int(population_speed_draws(
                    [int(pid)], seed=self.seed,
                    speed_sigma=self.speed_sigma, bw_mean=self.bw_mean,
                    bw_sigma=self.bw_sigma)[2][0])
            self._slots[int(pid)] = {
                "rows": {lp: arr[j].clone() for lp, arr in rows.items()},
                "cursor": int(np.asarray(tree["cursors"])[j]),
                "c3": float(np.asarray(tree["c3"])[j]),
                "speed": float(np.asarray(tree["speed"])[j]),
                "bw": float(np.asarray(tree["bw"])[j]),
                "jseed": js,
            }
