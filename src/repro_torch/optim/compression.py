"""Adapter-sync compression: top-k sparsification with error feedback and
int8 quantization.

Port of src/repro/optim/compression.py.  The per-round FedAvg payload
(the client LoRA deltas) is compressed before aggregation; error feedback
carries the uncompressed remainder into the next round's delta.

Every function maps a tree of tensors to a tree of the same structure.
Top-k runs over each whole leaf, client axis included, and the int8
scale is the amax of the whole leaf, as in the reference.  Under a
split cohort (runtime.sharding.Cohort), where each rank holds a block of
the client axis (axis 1 of a client-stacked (Lg, N, ...) leaf), top-k
gathers the rows and runs on the identical full leaf on every rank, each
rank keeping its own rows of the result and of the residual, and the
int8 amax is a MAX over the ranks.  Which entries tie at the k-th
magnitude may differ from ``jax.lax.top_k`` (equal magnitudes, zeros
above all); the dense result differs only where two entries of equal
magnitude and different value tie, and never for zeros.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.runtime.sharding import UNSHARDED, Cohort
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

INT8_INV = 1.0 / 127.0


def _topk_one(x: torch.Tensor, k_frac: float) -> Dict[str, torch.Tensor]:
    flat = x.reshape(-1).float()
    k = max(1, int(flat.shape[0] * k_frac))
    idx = torch.topk(flat.abs(), k, sorted=False).indices
    resid = flat.clone()
    resid[idx] = 0.0
    return {"values": flat[idx].to(x.dtype), "indices": idx,
            "residual": resid.reshape(x.shape).to(x.dtype)}


def topk_compress(tree, k_frac: float):
    """Keep the top k_frac fraction (by |value|) of every leaf: each leaf
    becomes {"values": (k,), "indices": (k,), "residual": dense
    remainder}."""
    return tree_map(lambda x: _topk_one(x, k_frac), tree)


def topk_decompress_leaf(c: Dict[str, torch.Tensor], x: torch.Tensor):
    """One dense leaf from its (values, indices), shaped like `x`."""
    flat = torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
    flat[c["indices"]] = c["values"]
    return flat.reshape(x.shape)


def _map_compressed(fn, comp, *rest):
    """fn over the compressed leaves of `comp` (a dict of tensors, such
    as values/indices/residual or q/scale, stands for one leaf) and the
    matching leaves of `rest`."""
    if isinstance(comp, dict) and not all(isinstance(v, torch.Tensor)
                                          for v in comp.values()):
        return {k: _map_compressed(fn, comp[k], *(r[k] for r in rest))
                for k in sorted(comp)}
    return fn(comp, *rest)


def topk_decompress(comp, like):
    """Dense leaves from (values, indices), with `like` as shape donor."""
    return _map_compressed(topk_decompress_leaf, comp, like)


def _int8_one(x: torch.Tensor, cohort: Cohort) -> Dict[str, torch.Tensor]:
    xf = x.float()
    amax = torch.clamp(cohort.max(xf.abs().max()), min=1e-12)
    # the reference's "amax / 127.0" as XLA compiles it inside the jitted
    # round step: a multiply by fp32(1/127) (tests pin it bitwise)
    scale = amax * INT8_INV
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def int8_quantize(tree, cohort: Cohort = UNSHARDED):
    """Symmetric per-leaf int8 quantization: x ~ scale * q.  cohort: the
    leaves hold this rank's rows; the scale is the whole cohort's."""
    return tree_map(lambda x: _int8_one(x, cohort), tree)


def int8_dequantize(tree, dtype=torch.float32):
    return _map_compressed(lambda c: (c["q"].float() * c["scale"]).to(dtype),
                           tree)


class ErrorFeedback:
    """Residual accumulator: delta' = delta + residual; the uncompressed
    remainder becomes the next residual."""

    @staticmethod
    def init(tree):
        return tree_map(torch.zeros_like, tree)

    @staticmethod
    def apply(tree, residual, k_frac: float,
              cohort: Cohort = UNSHARDED) -> Tuple[Any, Any, int]:
        """Compress (tree + residual); returns (dense compressed tree,
        new residual, bytes on the wire: the kept values at their dtype
        plus 4 bytes per index, the reference's int32 wire format).
        cohort: the client-stacked leaves hold this rank's rows; top-k
        runs over the gathered cohort and both results come back as this
        rank's rows."""
        summed = tree_map(lambda a, b: a + b, tree, residual)
        if cohort.split:
            leaves = tree_leaves(summed)
            summed = tree_unflatten(summed, cohort.gather_rows_many(
                leaves, [1] * len(leaves)))
        comp = topk_compress(summed, k_frac)
        dense = _map_compressed(topk_decompress_leaf, comp, summed)
        new_resid = _map_compressed(lambda c: c["residual"], comp)
        if cohort.split:
            mine = lambda x: cohort.rows(x, 1).clone(  # noqa: E731
                memory_format=torch.contiguous_format)
            dense, new_resid = tree_map(mine, dense), tree_map(mine,
                                                               new_resid)
        nbytes = sum(c["values"].numel() * c["values"].element_size()
                     + c["indices"].numel() * 4
                     for c in _compressed_leaves(comp))
        return dense, new_resid, nbytes


def _compressed_leaves(comp):
    out = []
    _map_compressed(lambda c: out.append(c), comp)
    return out
