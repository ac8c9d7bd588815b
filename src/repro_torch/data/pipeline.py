"""Batching pipeline: tokenized samples -> fixed-shape per-client batches.

The round engine consumes batches shaped (N_clients, B, S) int32 with a
loss mask (pad positions excluded).  Sampling is deterministic per
(seed, round) so runs are exactly reproducible and checkpoint-resumable.

A numpy copy of src/repro/data/pipeline.py (the port imports nothing of the
JAX package); tests/test_torch_host.py pins it bitwise to the original.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


@dataclasses.dataclass
class ClientDataLoader:
    """Per-client stream of (tokens, labels, mask) batches."""

    token_ids: List[np.ndarray]        # this client's tokenized samples
    batch_size: int
    seq_len: int
    pad_id: int = 0
    seed: int = 0

    def num_samples(self) -> int:
        return len(self.token_ids)

    def batch(self, round_idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 100003 + round_idx)
                                    & 0x7FFFFFFF)
        n = len(self.token_ids)
        take = rng.randint(0, n, size=self.batch_size)
        s = self.seq_len
        toks = np.full((self.batch_size, s + 1), self.pad_id, np.int32)
        for row, j in enumerate(take):
            ids = self.token_ids[j][:s + 1]
            toks[row, :len(ids)] = ids
        tokens = toks[:, :-1]
        labels = toks[:, 1:]
        mask = (labels != self.pad_id).astype(np.float32)
        return {"tokens": tokens, "labels": labels, "loss_mask": mask}


def make_client_loaders(samples_tokens: Sequence[np.ndarray],
                        parts: Sequence[np.ndarray], *, batch_size: int,
                        seq_len: int, pad_id: int = 0,
                        seed: int = 0) -> List[ClientDataLoader]:
    return [
        ClientDataLoader([samples_tokens[j] for j in part],
                         batch_size=batch_size, seq_len=seq_len,
                         pad_id=pad_id, seed=seed + i)
        for i, part in enumerate(parts)
    ]


def stack_client_batches(batches: Sequence[Dict[str, np.ndarray]]):
    """[{tokens,labels,mask}] per client -> (N,B,S) arrays."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}
