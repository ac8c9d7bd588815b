"""Analytic communication accounting (the paper's 'Comm Overhead' column).

A numpy copy of ``round_comm_bytes`` from src/repro/core/comm.py (the
port imports nothing of the JAX package); it reads the model only for its
shapes, and tests/test_torch_host.py pins it bitwise to the original.

Per global round, per client i with cut m_i:

  smashed up     = wire_bytes(B * S tokens of d_model)           (f2)
  smashed down   = same, for the returned gradient               (f4)
  adapter up     = sum_{l < m_i} r_eff(l) * (d_in+d_out) * bytes (b1)
  adapter down   = same (b3 broadcast)

r_eff comes from the C2 rank policy, so the saving from r_cut < r_others
is visible directly here.

The two channels compress independently:
  * adapters (b1/b3): top-k+EF / int8 in rounds.py; `compress_ratio`
    multiplies the adapter terms by the caller-measured ratio.
  * smashed (f2/f4): `smashed_compress` selects a repro.core.smashed
    compressor and the smashed terms become its MEASURED wire bytes
    (payload + scale/index side data), not a flat assumed ratio.  The
    achieved per-client ratio is reported as `smashed_ratio`.

The per-channel split is also what the multi-phase time model consumes
(runtime.straggler.SpeedModel.phase_times): `smashed_up` -> the f2
uplink phase, `smashed_down` -> the f4 downlink phase, `adapter_up` ->
the adapter-sync phase.  Shrinking a channel here directly shrinks its
wire phase — and under `overlap_comm` decides whether the pipeline is
bandwidth- or compute-bound.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core import smashed as smashed_lib
from repro_torch.models.model import Model


def round_comm_bytes(model: Model, *, cuts: Sequence[int], batch_size: int,
                     seq_len: int, dtype_bytes: int = 4,
                     compress_ratio: float = 1.0,
                     smashed_compress="none",
                     smashed_topk_frac=0.1,
                     rank_cut: Optional[Sequence[int]] = None
                     ) -> Dict[str, np.ndarray]:
    """smashed_compress: one compressor name for the whole fleet, or a
    per-client sequence of names (the co-controller's bucket choices).
    smashed_topk_frac: the topk keep fraction — one scalar, or a
    per-client (N,) array when the controller tunes the fraction
    continuously (state["topk_frac"]); a uniform array equals the
    scalar path exactly.  rank_cut: optional (N,) per-client
    rank-at-cut override — the adapter-channel bytes then charge each
    client ITS rank at the cut layer instead of the static
    LoRAConfig.r_cut, so the controller's rank decision is visible on
    the wire it optimizes."""
    arch = model.arch
    lora = arch.lora
    m = arch.model
    cuts = np.asarray(cuts, int)
    n = len(cuts)

    dense = float(batch_size * seq_len * m.d_model * dtype_bytes)
    names = ([smashed_compress] * n
             if isinstance(smashed_compress, str) or smashed_compress is None
             else list(smashed_compress))
    if len(names) != n:
        raise ValueError(f"smashed_compress sequence has {len(names)} "
                         f"entries for {n} clients")
    fracs = np.broadcast_to(
        np.asarray(smashed_topk_frac, np.float64), (n,))
    wire = np.array([smashed_lib.wire_bytes(
        nm, batch=batch_size, seq=seq_len, d_model=m.d_model,
        dtype_bytes=dtype_bytes, topk_frac=float(fr))
        for nm, fr in zip(names, fracs)], np.float64)
    smashed_up = wire.copy()
    smashed_down = wire.copy()

    spec = model.adapter_spec()
    flat_dims = {}
    for gname, targets in spec.items():
        g = model.group_by_name[gname]
        per_rank = sum(din + dout for din, dout in targets.values())
        for fid in g.layer_ids:
            flat_dims[fid] = per_rank

    rank_cut = None if rank_cut is None else np.asarray(rank_cut, int)
    # Adapter-channel bytes, vectorized over clients.  This runs on the
    # host every round AND once per co-controller candidate, so the old
    # O(N*L) Python loop bites at fleet scale.  Below a client's cut the
    # rank policy is r_others everywhere except the cut layer itself
    # (l == cut-1), so per-client totals decompose into an interior
    # prefix sum plus one rank-at-cut term:
    #   total_i = prefix[cut_i - 1] + r_last_i * per_rank[cut_i - 1]
    # Every term is an exact small integer in float64, so the prefix
    # cumsum reproduces the sequential loop bitwise (test-pinned).
    L = int(cuts.max()) if n else 0
    per_rank_vec = np.array([float(flat_dims.get(l, 0)) for l in range(L)],
                            np.float64)
    rank_tbl = np.array([float(lora.rank_for_layer(l, L + 2))
                         for l in range(L)], np.float64)
    prefix = np.concatenate(([0.0], np.cumsum(rank_tbl * per_rank_vec)))
    if L:
        last = np.maximum(cuts - 1, 0)
        r_last = (np.full(n, float(lora.r_cut), np.float64)
                  if rank_cut is None else rank_cut.astype(np.float64))
        totals = (prefix[last] + r_last * per_rank_vec[last]) \
            * (cuts > 0)
    else:
        totals = np.zeros(n, np.float64)
    adapter_up = totals * dtype_bytes * compress_ratio
    adapter_down = adapter_up.copy()

    return {
        "smashed_up": smashed_up,
        "smashed_down": smashed_down,
        "smashed_dense": np.full(n, dense, np.float64),
        "smashed_ratio": dense / wire,
        "adapter_up": adapter_up,
        "adapter_down": adapter_down,
        "total": smashed_up + smashed_down + adapter_up + adapter_down,
    }
