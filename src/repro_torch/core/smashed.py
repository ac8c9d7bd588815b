"""Smashed-activation compression at the cut boundary (paper f2/f4).

Port of src/repro/core/smashed.py for the non-stateful path:

  none   identity (paper baseline)
  int8   per-channel symmetric int8 through the fused round-trip kernel
         (repro_torch.kernels.smashed_quant)
  fp8    e4m3 scaled cast, one scale per message (plain torch, as in the
         reference)
  topk   per-token magnitude sparsification along d_model (plain torch)

Each compressor is wrapped in a straight-through estimator whose backward
applies the SAME compressor to the cotangent, so the f4 gradient return is
compressed symmetrically with the f2 uplink.  ``wire_bytes`` is the
per-message payload that repro_torch.core.comm charges.

The reference's boundary keeps one executable for every cut with a
``lax.cond`` on the traced cuts.  Eager PyTorch decides on the host
instead: the hook holds the cuts as host data and returns x untouched at
a layer where no client cuts, so the layer loop costs no device-to-host
sync.  Error feedback (a stateful boundary) and per-client compressor
buckets come with the co-controller's slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.kernels.smashed_quant import ops as quant_ops

COMPRESSORS = ("none", "int8", "fp8", "topk")

FP8_MAX = 448.0          # float8_e4m3fn finite max
_EPS = 1e-12


class _StraightThrough(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g.contiguous()), None


def straight_through(fn: Callable) -> Callable:
    """Wrap a shape-preserving compressor so its backward compresses the
    cotangent with the same function (symmetric f2/f4 wire simulation)."""
    return lambda x: _StraightThrough.apply(x, fn)


# ---------------------------------------------------------------------------
# compressor functions (x: (..., d); leading axis = message/client when 3D+)


def _int8_roundtrip(x):
    return quant_ops.int8_roundtrip_smashed(x)


def _fp8_roundtrip(x):
    xf = x.float()
    red = tuple(range(1, x.dim())) if x.dim() >= 3 else tuple(range(x.dim()))
    amax = xf.abs().amax(dim=red, keepdim=True)
    scale = torch.clamp(amax, min=_EPS) / FP8_MAX
    y = (xf / scale).to(torch.float8_e4m3fn).float() * scale
    return y.to(x.dtype)


def _topk_sparsify(x, frac: float):
    d = x.shape[-1]
    k = max(1, int(d * frac))
    av = x.float().abs()
    kth = torch.topk(av, k, dim=-1).values[..., -1:]
    return torch.where(av >= kth, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


# ---------------------------------------------------------------------------
# public interface


@dataclasses.dataclass(frozen=True)
class SmashedCompressor:
    """A cut-boundary compressor: `apply` is STE-wrapped and preserves
    shape and dtype."""

    name: str
    apply: Callable
    topk_frac: float = 0.1


def make_compressor(name: str, *, topk_frac: float = 0.1
                    ) -> Optional[SmashedCompressor]:
    """Build a compressor; "none" (and None) -> None, so callers skip the
    boundary hook for the uncompressed baseline."""
    name = name or "none"
    if name == "none":
        return None
    if name == "int8":
        fn = _int8_roundtrip
    elif name == "fp8":
        fn = _fp8_roundtrip
    elif name == "topk":
        fn = lambda x: _topk_sparsify(x, topk_frac)      # noqa: E731
    else:
        raise ValueError(
            f"unknown smashed compressor {name!r}; known: {COMPRESSORS}")
    return SmashedCompressor(name=name, apply=straight_through(fn),
                             topk_frac=topk_frac)


def wire_bytes(name: str, *, batch: int, seq: int, d_model: int,
               dtype_bytes: int = 4, topk_frac: float = 0.1) -> float:
    """Bytes one smashed message (one direction, one client) puts on the
    wire: B*S tokens of d_model channels, plus compressor side data."""
    tokens = batch * seq
    name = name or "none"
    if name == "none":
        return float(tokens * d_model * dtype_bytes)
    if name == "int8":
        # int8 payload + one f32 scale per channel per message
        return float(tokens * d_model + d_model * 4)
    if name == "fp8":
        # fp8 payload + one f32 scale per message
        return float(tokens * d_model + 4)
    if name == "topk":
        # kept values at full precision + 2-byte channel index each
        k = max(1, int(d_model * topk_frac))
        return float(tokens * k * (dtype_bytes + 2))
    raise ValueError(
        f"unknown smashed compressor {name!r}; known: {COMPRESSORS}")


def make_boundary(compressor: Optional[SmashedCompressor], cuts):
    """Boundary hook for Model.run_blocks: compress x only where flat
    layer `fid` is the last client-side layer (cut - 1) of some client,
    and there only that client's rows.

    x carries the client axis first ((N, B, S, d)); cuts is the (N,) cut
    array as host data (a CPU tensor or a sequence)."""
    if compressor is None:
        return None
    cut_ids = [int(c) - 1 for c in torch.as_tensor(cuts).tolist()]
    sel = {fid: torch.tensor([c == fid for c in cut_ids])
           for fid in set(cut_ids)}

    def boundary(x, fid):
        if fid not in sel:
            return x
        mask = sel[fid].to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(mask, compressor.apply(x), x)

    return boundary
