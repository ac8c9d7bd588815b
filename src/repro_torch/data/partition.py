"""Dataset partitioners — paper contribution C4.

IID: random shuffle, equal split.

Length-based Dirichlet (the paper's proposal): samples are bucketed into K
classes by token length; for each class k a Dirichlet(alpha) proportion
vector over the N clients allocates that class's samples.  Small alpha ->
each client sees only a narrow length band (high heterogeneity); alpha ->
infinity recovers IID.

A numpy copy of src/repro/data/partition.py (the port imports nothing of the
JAX package); tests/test_torch_host.py pins it bitwise to the original.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def iid_partition(lengths: Sequence[int], num_clients: int,
                  *, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(lengths))
    return [np.sort(part) for part in np.array_split(idx, num_clients)]


def length_classes(lengths: Sequence[int], num_classes: int) -> np.ndarray:
    """Assign each sample a class id 0..K-1 by length quantile."""
    lengths = np.asarray(lengths)
    qs = np.quantile(lengths, np.linspace(0, 1, num_classes + 1)[1:-1])
    return np.searchsorted(qs, lengths, side="right")


def length_dirichlet_partition(lengths: Sequence[int], num_clients: int,
                               *, alpha: float, num_classes: int = 8,
                               seed: int = 0) -> List[np.ndarray]:
    """The paper's partitioner.  Returns per-client index arrays."""
    rng = np.random.RandomState(seed)
    cls = length_classes(lengths, num_classes)
    parts: List[List[int]] = [[] for _ in range(num_clients)]
    for k in range(num_classes):
        members = np.where(cls == k)[0]
        rng.shuffle(members)
        p = rng.dirichlet([alpha] * num_clients)
        counts = np.floor(p * len(members)).astype(int)
        # distribute the rounding remainder to the largest shares
        rem = len(members) - counts.sum()
        if rem > 0:
            order = np.argsort(-p)
            counts[order[:rem]] += 1
        start = 0
        for i in range(num_clients):
            parts[i].extend(members[start:start + counts[i]].tolist())
            start += counts[i]
    out = []
    for i in range(num_clients):
        a = np.array(sorted(parts[i]), dtype=np.int64)
        if len(a) == 0:                    # degenerate Dirichlet draw:
            a = np.array([rng.randint(len(lengths))])  # give 1 sample
        out.append(a)
    return out


def partition_dataset(lengths: Sequence[int], num_clients: int, *,
                      strategy: str, alpha: float = 0.9,
                      num_classes: int = 8, seed: int = 0):
    if strategy == "iid":
        return iid_partition(lengths, num_clients, seed=seed)
    if strategy == "dirichlet":
        return length_dirichlet_partition(
            lengths, num_clients, alpha=alpha, num_classes=num_classes,
            seed=seed)
    raise ValueError(f"unknown partition strategy {strategy!r}")
