"""Public wrapper for the indexed (multi-adapter) LoRA projection.

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
hand-written kernel (csrc/lora_indexed.cu) or raises.  Inference only:
the serving path has no gradient.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lora_matmul import ref

MAX_RANK = 64


def lora_matmul_indexed(x, w, a_pool, b_pool, scale, ids):
    """x: (B, ..., K); w: (K, N); a_pool: (P, K, r); b_pool: (P, r, N);
    scale: (P,) fp32; ids: (B,) int32 -> y (B, ..., N) in x's dtype."""
    if x.device.type == "cpu":
        return ref.lora_matmul_indexed(x, w, a_pool, b_pool, scale, ids)
    if x.device.type != "cuda":
        raise ValueError(f"lora_matmul_indexed: unsupported device {x.device}")
    lead = x.shape[:-1]
    k_dim = x.shape[-1]
    n = w.shape[1]
    p, _, r = a_pool.shape
    if w.shape != (k_dim, n) or a_pool.shape != (p, k_dim, r) \
            or b_pool.shape != (p, r, n) or scale.shape != (p,) \
            or ids.shape != lead[:1]:
        raise ValueError(
            f"lora_matmul_indexed: shapes x{tuple(x.shape)} w{tuple(w.shape)} "
            f"A{tuple(a_pool.shape)} B{tuple(b_pool.shape)} "
            f"scale{tuple(scale.shape)} ids{tuple(ids.shape)} do not agree")
    for name, t in (("w", w), ("a_pool", a_pool), ("b_pool", b_pool)):
        if t.dtype != x.dtype:
            raise ValueError(f"lora_matmul_indexed: {name} dtype {t.dtype} "
                             f"!= x dtype {x.dtype}")
    if scale.dtype != torch.float32 or ids.dtype != torch.int32:
        raise ValueError("lora_matmul_indexed: scale must be float32 and "
                         "ids int32")
    tensors = (x, w, a_pool, b_pool, scale, ids)
    if any(t.device != x.device for t in tensors):
        raise ValueError("lora_matmul_indexed: all tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lora_matmul_indexed: tensors must be contiguous")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"lora_matmul_indexed: rank {r} not in 1..{MAX_RANK}")
    code = _build.dtype_code(x.dtype)
    rid = ref.row_ids(ids, lead)
    m = rid.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    xa = torch.empty((m, r), dtype=torch.float32, device=x.device)
    lib = _build.library()
    err = lib.lora_indexed(x.data_ptr(), w.data_ptr(), a_pool.data_ptr(),
                           b_pool.data_ptr(), scale.data_ptr(),
                           rid.data_ptr(), xa.data_ptr(), y.data_ptr(), m,
                           k_dim, n, r, p,
                           code,
                           torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "lora_indexed")
    lora_matmul_indexed.launches += 1
    return y.reshape(*lead, n)


lora_matmul_indexed.launches = 0
