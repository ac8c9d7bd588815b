"""Smashed-activation compression at the cut boundary (paper f2/f4).

Port of src/repro/core/smashed.py:

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
sync.  ``make_multi_boundary`` is the co-controller's per-client bucket
choice, with an optional per-client topk keep fraction; ``make_boundary``
with a residual is the stateful error-feedback boundary.
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


def straight_through2(fn: Callable) -> Callable:
    """`straight_through` for a two-operand fn(x, aux), where aux (the
    per-client topk keep fraction) parameterizes the compressor but
    carries no gradient: the backward compresses the cotangent with the
    same fn at the same aux."""
    return lambda x, aux: _StraightThrough.apply(x, lambda t: fn(t, aux))


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


def _topk_sparsify_frac(x, frac):
    """`_topk_sparsify` with a per-client keep fraction (the
    co-controller's continuous knob): frac is a scalar or an (N,) array
    over x's leading client axis; k = clip(floor(d * frac), 1, d) in fp32
    as the reference computes it, and the k-th largest magnitude is a
    value, so a uniform frac equal to the static topk_frac gives the
    static compressor bit for bit.  One descending sort along d and a
    gather at k - 1, since k varies per client."""
    d = x.shape[-1]
    frac = torch.as_tensor(frac, dtype=torch.float32)
    k = torch.clamp(torch.floor(d * frac).to(torch.int32), 1, d)
    k = k.reshape(k.shape + (1,) * (x.dim() - 1 - k.dim())).to(x.device)
    av = x.float().abs()
    sv = torch.sort(av, dim=-1, descending=True).values
    idx = (k.long() - 1).expand(av.shape[:-1])[..., None]
    kth = torch.gather(sv, -1, idx)
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


def make_boundary(compressor: Optional[SmashedCompressor], cuts,
                  residual=None):
    """Boundary hook for Model.run_blocks: compress x only where flat
    layer `fid` is the last client-side layer (cut - 1) of some client,
    and there only that client's rows.

    x carries the client axis first ((N, B, S, d)); cuts is the (N,) cut
    array as host data (a CPU tensor or a sequence).

    With `residual` (the (N, B, S, d) error-feedback buffer of the round
    state) the hook is stateful: the f2 message is compress(x +
    residual), and the uncompressed remainder leaves the forward as the
    next round's residual.  A stateful hook has `stateful = True` and
    `init()` for the carry, and is called as `x, carry = hook(x, carry,
    fid)`; the last carry is the new residual, a detached tensor that the
    layer returns (so a recomputed layer cannot write it twice).  Error
    feedback tracks f2; the f4 cotangent is compressed memorylessly by
    the straight-through backward.

    The hook's ``fids`` are the flat layers where it acts.  Under a
    MeshShard that splits the stream (a client's batch rows over "pod",
    its sequence over "model"), the model runs the hook there on the
    whole message (``ShardingPolicy.whole_message``: gathered, compressed
    with its per-channel or per-message scales, the rank's block kept,
    and so for the f4 cotangent), and the residual is whole on every
    rank."""
    if compressor is None:
        return None
    cut_ids = [int(c) - 1 for c in torch.as_tensor(cuts).tolist()]
    sel = {fid: torch.tensor([c == fid for c in cut_ids])
           for fid in set(cut_ids)}

    def _mask(fid, x):
        return sel[fid].to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))

    if residual is None:
        def boundary(x, fid):
            if fid not in sel:
                return x
            return torch.where(_mask(fid, x), compressor.apply(x), x)

        boundary.fids = frozenset(sel)
        return boundary

    resid = residual.detach()

    def ef_boundary(x, carry, fid):
        if fid not in sel:
            return x, carry
        mask = _mask(fid, x)
        xin = x + resid.to(x.dtype)
        y = compressor.apply(xin)
        new_r = (xin - y).detach().to(carry.dtype)
        return torch.where(mask, y, x), torch.where(mask, new_r, carry)

    ef_boundary.stateful = True
    ef_boundary.fids = frozenset(sel)
    ef_boundary.init = lambda: torch.zeros_like(resid)
    return ef_boundary


def make_multi_boundary(compressors, cuts, choice, topk_frac=None):
    """Boundary hook with a per-client compressor choice, the
    co-controller's third knob.

    compressors: tuple of Optional[SmashedCompressor], one per bucket
    ("none" -> None); choice: (N,) bucket index per client, host data
    like the cuts (state["smashed_choice"]).  At a cut layer each bucket
    that some client cutting there chose is computed on the whole x and
    selected per client by a mask built on the host; other buckets are
    not computed (the reference computes every bucket, since its shapes
    are static; a bucket no client selects adds nothing).  Each bucket
    stays straight-through, so f4 is compressed per client as f2.

    topk_frac (optional (N,) fraction per client, state["topk_frac"])
    runs the topk bucket at each client's own keep fraction
    (`_topk_sparsify_frac`); a uniform fraction equal to the bucket's
    static topk_frac is the static path bit for bit."""
    if all(c is None for c in compressors):
        return None
    cut_ids = [int(c) - 1 for c in torch.as_tensor(cuts).tolist()]
    idx = [int(k) for k in torch.as_tensor(choice).tolist()]
    dyn_topk = None
    if topk_frac is not None:
        frac = torch.as_tensor(topk_frac, dtype=torch.float32)
        dyn_topk = straight_through2(_topk_sparsify_frac)
    sel = {}
    for fid in set(cut_ids):
        for k, comp in enumerate(compressors):
            rows = [c == fid and j == k for c, j in zip(cut_ids, idx)]
            if comp is not None and any(rows):
                sel.setdefault(fid, []).append((comp, torch.tensor(rows)))

    def boundary(x, fid):
        out = x
        for comp, rows in sel.get(fid, ()):
            y = (dyn_topk(x, frac) if (dyn_topk is not None
                                       and comp.name == "topk")
                 else comp.apply(x))
            mask = rows.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
            out = torch.where(mask, y, out)
        return out

    boundary.fids = frozenset(sel)
    return boundary
