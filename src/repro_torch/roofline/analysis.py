"""Three-term roofline of a dry-run cell on NVIDIA H100s.

Port of src/repro/roofline/analysis.py:

  compute_s    = FLOPs_per_device / peak_FLOPs
  memory_s     = HBM_bytes_per_device / HBM_bw
  collective_s = collective_bytes_per_device / link_bw

Hardware (``HW``): one H100 SXM, NVIDIA's data sheet: 989e12 dense bf16
FLOP/s (the cells' base weights are bf16) and 3.35e12 B/s of HBM, the
constants ``chip_smoke.py`` bounds its kernels with.  Between cards,
NVLink 4 at 450e9 B/s each way (NVIDIA's H100 data sheet: 900 GB/s of
NVLink bandwidth in both directions together).  A cell on one card
moves no collective bytes, so its collective term is zero.

The reference also has ``collective_bytes`` and ``roofline_from_compiled``,
which parse the HLO text of an XLA executable.  The port compiles no HLO:
its FLOPs, bytes and peak come from ``repro_torch.roofline.counting``,
and ``roofline_record`` composes them as ``roofline_from_compiled`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

HW = {
    "peak_flops": 989e12,        # bf16 dense per card
    "hbm_bw": 3.35e12,           # bytes/s
    "link_bw": 450e9,            # NVLink bytes/s, one direction
}


def roofline_terms(flops: float, bytes_: float, coll_bytes: float,
                   *, hw: Dict[str, float] = HW) -> Dict[str, float]:
    compute_s = flops / hw["peak_flops"]
    memory_s = bytes_ / hw["hbm_bw"]
    collective_s = coll_bytes / hw["link_bw"]
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    bound = max(compute_s, memory_s, collective_s)
    terms.update({
        "dominant": dom,
        "step_s_lower_bound": bound,
        "compute_fraction": compute_s / bound if bound else 0.0,
    })
    return terms


def roofline_record(flops: float, bytes_: float, *, coll_bytes: float = 0.0,
                    model_flops: Optional[float] = None,
                    num_devices: int = 1) -> Dict[str, Any]:
    """The dry-run's roofline record of one cell from its counted FLOPs
    and HBM bytes per device (``counting.count``), with the useful
    fraction and the model-FLOPs step time when ``model_flops`` is
    given, as the reference's ``roofline_from_compiled`` gives them."""
    rec: Dict[str, Any] = {"flops_per_dev": flops, "bytes_per_dev": bytes_,
                           "collective_bytes_per_dev": coll_bytes,
                           **roofline_terms(flops, bytes_, coll_bytes)}
    if model_flops:
        rec["model_flops"] = model_flops
        per_dev = model_flops / num_devices
        rec["useful_fraction"] = per_dev / flops if flops else 0.0
        rec["model_step_s"] = per_dev / HW["peak_flops"]
        rec["roofline_fraction"] = (rec["model_step_s"]
                                    / rec["step_s_lower_bound"]
                                    if rec["step_s_lower_bound"] else 0.0)
    return rec


def model_flops_for(arch, shape, *, lora_only: bool = True) -> float:
    """MODEL_FLOPS = 6 N D (train, dense) / 6 N_active D (MoE); serving
    fwd-only = 2 N D.  LoRA training backward skips dW for the frozen
    base, so the honest train multiplier is ~4ND (fwd 2 + dx 2) plus the
    small adapter terms; we report the 6ND convention AND expose 4ND."""
    m = arch.model
    n_active = m.active_param_count()
    tokens = shape.seq_len * shape.global_batch
    if shape.kind == "train":
        mult = 4.0 if lora_only else 6.0
    elif shape.kind == "prefill":
        mult = 2.0
    else:
        mult = 2.0
        tokens = shape.global_batch          # one token per sequence
    return mult * n_active * tokens
