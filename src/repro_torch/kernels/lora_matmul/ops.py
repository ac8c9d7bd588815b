"""Public wrappers for the LoRA projections.

A CPU tensor runs the plain versions (ref.py); a CUDA tensor launches the
hand-written kernels or raises.  There is no other dispatch and no
fallback.

  * ``lora_matmul`` -- one adapter, y = x @ W + s (x @ A) @ B, as a
    ``torch.autograd.Function`` (the reference's ``custom_vjp`` with
    ``lora_only=True``): the forward (csrc/lora_fused.cu) keeps the fp32
    ``xa`` residual and the backward (same source) computes dx, dA, dB and
    dscale from it.  W is frozen (LoRA fine-tuning): it gets no gradient
    and dW is never computed.  The backward's dA/dB pass splits M over
    CTAs and combines the slices in the same launch: it takes a workspace
    (allocated per call) and a counter per column tile, kept zeroed
    between calls (``_build.counters``).
  * ``lora_matmul_indexed`` -- a pool of adapters, one per leading row
    (csrc/lora_indexed.cu); inference only, the serving path has no
    gradient.  The kernel splits K over CTAs and combines the slices in
    one launch: it takes a workspace (allocated per call) and a counter
    per output tile, kept zeroed between calls (``_build.counters``).
    The workspace grows with M, so a long prefill's rows go through the
    kernel in chunks (``row_chunks``), one launch each into the slices of
    one output; a row does not depend on the rows beside it, so the
    chunks give the one-launch result bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lora_matmul import ref

MAX_RANK = 64

# The indexed kernel's tiling (csrc/lora_indexed.cu: BM, BN, KSL): its
# fp32 workspace holds a BM x (BN + r) tile per (row tile, column tile,
# K slice).  One launch takes at most INDEXED_WORK_CAP bytes of it and at
# most INDEXED_MAX_ROW_TILES row tiles (the grid's z limit).
INDEXED_BM, INDEXED_BN, INDEXED_KSL = 16, 64, 64
INDEXED_WORK_CAP = 512 * 2**20
INDEXED_MAX_ROW_TILES = 65535


def indexed_work_bytes(m: int, k: int, n: int, r: int) -> int:
    """Bytes of fp32 workspace one launch over m rows takes (the kernel's
    ``lora_indexed_work`` times 4)."""
    tiles = (-(-m // INDEXED_BM) * -(-n // INDEXED_BN)
             * -(-k // INDEXED_KSL))
    return 4 * tiles * INDEXED_BM * (INDEXED_BN + r)


def row_chunks(m: int, k: int, n: int, r: int):
    """The row ranges [(lo, hi), ...] the indexed kernel's launches take
    for an (m, k) x (k, n) product at rank r: whole row tiles, as many as
    keep a launch's workspace within INDEXED_WORK_CAP and its grid within
    INDEXED_MAX_ROW_TILES (at least one), covering [0, m) in order."""
    per_tile = indexed_work_bytes(INDEXED_BM, k, n, r)
    tiles = max(1, min(INDEXED_WORK_CAP // per_tile, INDEXED_MAX_ROW_TILES))
    rows = tiles * INDEXED_BM
    return [(lo, min(lo + rows, m)) for lo in range(0, m, rows)]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_fused(name, x, w, a, b, scale, *others):
    m, k_dim = x.shape
    n, r = w.shape[1], a.shape[1]
    if w.shape != (k_dim, n) or a.shape != (k_dim, r) or b.shape != (r, n) \
            or scale.numel() != 1:
        raise ValueError(f"{name}: shapes x{tuple(x.shape)} w{tuple(w.shape)} "
                         f"A{tuple(a.shape)} B{tuple(b.shape)} "
                         f"scale{tuple(scale.shape)} do not agree")
    for label, t in (("w", w), ("a", a), ("b", b)):
        if t.dtype != x.dtype:
            raise ValueError(f"{name}: {label} dtype {t.dtype} != x dtype "
                             f"{x.dtype}")
    if scale.dtype != torch.float32:
        raise ValueError(f"{name}: scale must be float32")
    tensors = (x, w, a, b, scale) + others
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: all tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"{name}: rank {r} not in 1..{MAX_RANK}")
    return _build.dtype_code(x.dtype)


def lora_matmul_fwd(x, w, a, b, scale):
    """x (M, K); w (K, N); a (K, r); b (r, N); scale () fp32 ->
    (y (M, N) in x's dtype, xa (M, r) fp32 residual)."""
    if x.device.type == "cpu":
        return ref.lora_matmul_fwd(x, w, a, b, scale)
    if x.device.type != "cuda":
        raise ValueError(f"lora_matmul: unsupported device {x.device}")
    code = _check_fused("lora_matmul", x, w, a, b, scale)
    m, k_dim = x.shape
    n, r = w.shape[1], a.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    xa = torch.empty((m, r), dtype=torch.float32, device=x.device)
    err = _build.library().lora_fused_fwd(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        scale.data_ptr(), xa.data_ptr(), y.data_ptr(), m, k_dim, n, r, code,
        _stream(x))
    _build.check(err, "lora_fused_fwd")
    lora_matmul_fwd.launches += 1
    return y, xa


lora_matmul_fwd.launches = 0


def lora_matmul_bwd(x, w, a, b, scale, g, xa):
    """The frozen-W backward: g (M, N) cotangent, xa (M, r) fp32 residual
    -> (dx like x, dA like a, dB like b, dscale () fp32).  dscale =
    sum(xa * gb) is one torch op, as in the reference's wrapper."""
    if x.device.type == "cpu":
        return ref.lora_matmul_bwd(x, w, a, b, scale, g, xa)
    if x.device.type != "cuda":
        raise ValueError(f"lora_matmul: unsupported device {x.device}")
    code = _check_fused("lora_matmul_bwd", x, w, a, b, scale, g, xa)
    m, k_dim = x.shape
    n, r = w.shape[1], a.shape[1]
    if g.shape != (m, n) or g.dtype != x.dtype \
            or xa.shape != (m, r) or xa.dtype != torch.float32:
        raise ValueError("lora_matmul_bwd: g must be (M, N) like x and xa "
                         "(M, r) float32")
    lib = _build.library()
    gb = torch.empty((m, r), dtype=torch.float32, device=x.device)
    work = torch.empty((lib.lora_fused_dab_work(m, k_dim, n, r),),
                       dtype=torch.float32, device=x.device)
    ctr = _build.counters("lora_fused_dab", x.device,
                          lib.lora_fused_dab_counters(k_dim, n))
    dx = torch.empty_like(x)
    da = torch.empty_like(a)
    db = torch.empty_like(b)
    err = lib.lora_fused_bwd(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        scale.data_ptr(), g.data_ptr(), xa.data_ptr(), gb.data_ptr(),
        work.data_ptr(), ctr.data_ptr(), dx.data_ptr(), da.data_ptr(),
        db.data_ptr(), m, k_dim, n, r, code, _stream(x))
    _build.check(err, "lora_fused_bwd")
    lora_matmul_bwd.launches += 1
    return dx, da, db, (xa * gb).sum()


lora_matmul_bwd.launches = 0


class _LoRAMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, a, b, scale):
        k_dim, n = w.shape
        x2 = x.reshape(-1, k_dim).contiguous()
        s = scale.float().reshape(()).contiguous()
        y, xa = lora_matmul_fwd(x2, w, a, b, s)
        ctx.save_for_backward(x2, w, a, b, s, xa)
        ctx.x_shape = x.shape
        ctx.scale_like = (scale.shape, scale.dtype)
        return y.reshape(*x.shape[:-1], n)

    @staticmethod
    def backward(ctx, g):
        x2, w, a, b, s, xa = ctx.saved_tensors
        g2 = g.reshape(-1, w.shape[1]).contiguous()
        dx, da, db, ds = lora_matmul_bwd(x2, w, a, b, s, g2, xa)
        shape, dtype = ctx.scale_like
        return (dx.reshape(ctx.x_shape), None, da, db,
                ds.to(dtype).reshape(shape))


def lora_matmul(x, w, a, b, scale):
    """y = x @ W + scale * (x @ A) @ B, differentiable in x, A, B and
    scale; W is frozen.  x: (..., K); w: (K, N); a: (K, r); b: (r, N);
    scale: scalar tensor."""
    return _LoRAMatmul.apply(x, w, a.contiguous(), b.contiguous(),
                             torch.as_tensor(scale, device=x.device))


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
    lib = _build.library()
    xs = x.reshape(m, k_dim)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    chunks = row_chunks(m, k_dim, n, r)
    rows = max((hi - lo for lo, hi in chunks), default=0)
    work = torch.empty((lib.lora_indexed_work(rows, k_dim, n, r),),
                       dtype=torch.float32, device=x.device)
    ctr = _build.counters("lora_indexed", x.device,
                          lib.lora_indexed_counters(rows, n))
    for lo, hi in chunks:
        err = lib.lora_indexed(
            xs[lo:hi].data_ptr(), w.data_ptr(), a_pool.data_ptr(),
            b_pool.data_ptr(), scale.data_ptr(), rid[lo:hi].data_ptr(),
            work.data_ptr(), ctr.data_ptr(), y[lo:hi].data_ptr(), hi - lo,
            k_dim, n, r, p, code, _stream(x))
        _build.check(err, "lora_indexed")
        lora_matmul_indexed.launches += 1
    return y.reshape(*lead, n)


lora_matmul_indexed.launches = 0
