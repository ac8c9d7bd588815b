"""Public wrappers for the smashed-activation int8 quantizers.

A CPU tensor runs the plain version (ref.py); a CUDA tensor launches the
hand-written kernels (csrc/smashed_quant.cu) or raises.  There is no other
dispatch and no fallback.

As in the reference's wrappers, inputs (..., d) are canonicalized to
(G, M, d): dim 0 is the message (client) axis for 3-D and larger inputs,
a 2-D input is one message.  Scales come back as (G, d), or (d,) for 2-D
inputs.  The straight-through gradient lives in repro_torch.core.smashed.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.smashed_quant import ref


def _canon(x):
    """(..., d) -> ((G, M, d) contiguous, original shape)."""
    if x.dim() < 2:
        raise ValueError(f"need at least (M, d), got {tuple(x.shape)}")
    if x.dim() == 2:
        return x[None].contiguous(), x.shape
    return x.reshape(x.shape[0], -1, x.shape[-1]).contiguous(), x.shape


def _launch(name, *args):
    err = getattr(_build.library(), name)(*args)
    _build.check(err, name)


def _cuda(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return torch.cuda.current_stream(x.device).cuda_stream


def int8_quantize_smashed(x):
    """x (..., d) -> (q int8 same shape, scale (G, d) | (d,) float32)."""
    x3, shape = _canon(x)
    if x.device.type == "cpu":
        q, scale = ref.quantize(x3)
    else:
        stream = _cuda(x, "int8_quantize_smashed")
        g, m, d = x3.shape
        q = torch.empty(x3.shape, dtype=torch.int8, device=x.device)
        scale = torch.empty((g, d), dtype=torch.float32, device=x.device)
        _launch("smashed_quantize", x3.data_ptr(), q.data_ptr(),
                scale.data_ptr(), g, m, d, _build.dtype_code(x.dtype), stream)
        int8_quantize_smashed.launches += 1
    return q.reshape(shape), (scale[0] if len(shape) == 2 else scale)


int8_quantize_smashed.launches = 0


def int8_dequantize_smashed(q, scale, dtype=torch.float32):
    """Inverse of int8_quantize_smashed (per-channel expand) in `dtype`."""
    q3, shape = _canon(q)
    scale3 = (scale[None] if len(shape) == 2 else scale).float().contiguous()
    if q.dtype != torch.int8 or scale3.shape != (q3.shape[0], q3.shape[2]):
        raise ValueError(f"int8_dequantize_smashed: q {q.dtype} "
                         f"{tuple(q.shape)} and scale {tuple(scale.shape)} "
                         f"do not agree")
    if q.device.type == "cpu":
        x = ref.dequantize(q3, scale3, dtype)
    else:
        stream = _cuda(q, "int8_dequantize_smashed")
        if scale3.device != q.device:
            raise ValueError("int8_dequantize_smashed: q and scale on one "
                             "device")
        g, m, d = q3.shape
        x = torch.empty(q3.shape, dtype=dtype, device=q.device)
        _launch("smashed_dequantize", q3.data_ptr(), scale3.data_ptr(),
                x.data_ptr(), g, m, d, _build.dtype_code(dtype), stream)
        int8_dequantize_smashed.launches += 1
    return x.reshape(shape)


int8_dequantize_smashed.launches = 0


def int8_roundtrip_smashed(x):
    """Fused wire round trip dequant(quant(x)), same shape and dtype as x."""
    x3, shape = _canon(x)
    if x.device.type == "cpu":
        y = ref.roundtrip(x3)
    else:
        stream = _cuda(x, "int8_roundtrip_smashed")
        g, m, d = x3.shape
        y = torch.empty_like(x3)
        _launch("smashed_roundtrip", x3.data_ptr(), y.data_ptr(), g, m, d,
                _build.dtype_code(x.dtype), stream)
        int8_roundtrip_smashed.launches += 1
    return y.reshape(shape)


int8_roundtrip_smashed.launches = 0
