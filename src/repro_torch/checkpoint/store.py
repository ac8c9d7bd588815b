"""Fault-tolerant checkpointing.

Port of src/repro/checkpoint/store.py.  Format: one .npz holding every
array leaf as ``leaf_0 … leaf_{n-1}`` in the tree's leaf order
(``repro_torch.tree.tree_leaves``: dict keys sorted, the order
``jax.tree.flatten`` gives a dict), so the reference and the port read
each other's arrays.  Metadata goes to a JSON sidecar ``<path>.meta.json``
(the reference's msgpack sidecar is ``<path>.meta``; neither reader
mistakes the other's file for its own, and the port needs no msgpack).

Guarantees used by the round engine's failure story:
  * atomic: write to <name>.tmp-<pid>, fsync, rename — a crash mid-write
    never corrupts the latest checkpoint;
  * keep-last-k with monotonically increasing step names, so a corrupted
    or partial newest checkpoint falls back to the previous one on load.

Tensors are copied to the CPU before they are written; a loaded tree
holds numpy leaves, and the caller moves them to their device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_unflatten

META_SUFFIX = ".meta.json"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(path: str, tree, *, metadata: Optional[Dict] = None):
    """Atomically write `tree` (+ metadata) to `path` (.npz)."""
    flat = {f"leaf_{i}": _to_numpy(v)
            for i, v in enumerate(tree_leaves(tree))}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _atomic_write(path, lambda f: np.savez(f, **flat))
    meta = json.dumps({"metadata": metadata or {}}).encode()
    _atomic_write(path + META_SUFFIX, lambda f: f.write(meta))


def _read_meta(path: str) -> Dict:
    """Metadata sidecar of checkpoint `path` ({} if absent)."""
    meta_path = path + META_SUFFIX
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f).get("metadata", {})


def load_checkpoint(path: str, like) -> Tuple[Any, Dict]:
    """Load into the structure of `like` (a donor tree).

    Only the structure of `like` matters; leaf shapes come from the file.
    A leaf-count mismatch means `like` is a structurally different
    template and raises instead of mis-zipping leaves into wrong slots."""
    with np.load(path) as z:
        leaves = [z[f"leaf_{i}"] for i in range(len(z.files))]
    n_like = len(tree_leaves(like))
    if n_like != len(leaves):
        raise ValueError(
            f"checkpoint {path} holds {len(leaves)} leaves but the "
            f"donor template has {n_like}; the saved tree was written "
            "with a different state template")
    return tree_unflatten(like, leaves), _read_meta(path)


class CheckpointManager:
    """keep-last-k manager with corruption fallback."""

    def __init__(self, directory: str, *, keep: int = 3,
                 prefix: str = "ckpt"):
        self.directory = directory
        self.keep = keep
        self.prefix = prefix
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step:08d}.npz")

    def steps(self) -> List[int]:
        out = []
        for fn in os.listdir(self.directory):
            if fn.startswith(self.prefix) and fn.endswith(".npz") \
                    and ".tmp" not in fn:
                try:
                    out.append(int(fn[len(self.prefix) + 1:-4]))
                except ValueError:
                    pass
        return sorted(out)

    def save(self, step: int, tree, *, metadata: Optional[Dict] = None):
        save_checkpoint(self._path(step), tree, metadata=metadata)
        self._gc()

    def restore_latest(self, like) -> Optional[Tuple[Any, Dict, int]]:
        """Newest loadable checkpoint (falls back past corrupted files)."""
        for step in reversed(self.steps()):
            try:
                tree, meta = load_checkpoint(self._path(step), like)
                return tree, meta, step
            except Exception:
                continue
        return None

    def metadata(self, step: int) -> Optional[Dict]:
        """Just the metadata sidecar of one checkpoint (no array load)."""
        try:
            return _read_meta(self._path(step))
        except Exception:
            return None

    def _gc(self):
        for s in self.steps()[:-self.keep]:
            for suffix in ("", META_SUFFIX):
                p = self._path(s) + suffix
                if os.path.exists(p):
                    os.remove(p)
