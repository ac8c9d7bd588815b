"""FLOPs, HBM bytes and peak live bytes of a callable, without running it
on data.

The port's counterpart of src/repro/roofline/hlo_parse.py, which reads
these numbers from an XLA executable's HLO text.  The port compiles no
HLO: ``count`` runs the callable on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes, dtypes and
strides without storage, so nothing the size of a cell is allocated)
under two dispatch modes, and reads

  * FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (2 per
    multiply-add of every matrix product, forward and backward);
  * HBM bytes by the reference's own model: 2 x the bytes that every
    op's outputs write (reads ~ writes).  A view writes nothing; an
    in-place op writes what its other tensor arguments hold, at most its
    output (a cache row copied into the cache writes the row);
  * the peak of live tensor bytes, the arguments included: each op's
    new outputs add their storage's bytes, which leave when the last
    tensor on that storage is freed (a tensor that autograd saves for
    the backward stays live until the backward frees it).

Kernels.  On the CPU each kernel's wrapper runs its plain version
(``kernels/*/ref.py``), which may hold far more than the kernel does:
the plain flash attention holds the (Sq, Sk) scores, the plain decode
attention an fp32 copy of the cache, the plain indexed LoRA each row's
adapter.  While counting, each plain version in ``KERNELS`` is charged
as the kernel it stands for: it moves its tensor arguments once and its
outputs once (the bytes of ``chip_smoke.py``'s kernel bounds: a decode
step reads its cache), its outputs are live, and so is its workspace
(the wrapper's scratch on the card) while it runs; its temporaries are
not counted.  Its FLOPs still come from the plain version's products,
so the flash kernel's FLOPs are the plain version's full Sq x Sk
products (a causal kernel computes about half of them), and the SSD
kernel's are its chunked plain version's.

Where autograd records a plain version's call (the SSD scan in a train
step: on the CPU its wrapper is the plain version itself), it is
counted as the card runs it (``kernels/ssd_scan/ops.py``): the forward
as the kernel, the backward a recompute of the plain version under
autograd, counted as the torch ops it is.  A kernel called again on
arguments of the same shapes, dtypes and options (every layer, every
microbatch), and such a backward, cost what their first call did: the
recorded FLOPs, bytes and peak are added again and the outputs made
empty, without running the plain version again.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import weakref
from typing import Any, Callable, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


def _decode_work(q, k, v, cache_len, **_):
    """csrc/decode_attention.cu's workspace: a (hd + 2)-float softmax
    state per (sequence, 64-position chunk, head)."""
    b, h, hd = q.shape
    return 4 * b * math.ceil(k.shape[1] / 64) * h * (hd + 2)


def _paged_work(q, k_pool, v_pool, page_table, cache_len, **_):
    b, h, hd = q.shape
    capacity = page_table.shape[1] * k_pool.shape[1]
    return 4 * b * math.ceil(capacity / 64) * h * (hd + 2)


def _indexed_work(x, w, a_pool, b_pool, scale, ids):
    from repro_torch.kernels.lora_matmul import ops
    k, n, r = x.shape[-1], w.shape[1], a_pool.shape[-1]
    chunks = ops.row_chunks(x.numel() // k, k, n, r)
    rows = max((hi - lo for lo, hi in chunks), default=0)
    return ops.indexed_work_bytes(rows, k, n, r)


def _ssd_work(x, dt, a, bm, c, h0=None, *, chunk=256, **_):
    """kernels/ssd_scan/ops.py's scratch: the cumulative decay (B*H, S),
    the chunk states (B*H*nc, P, N) and the C.B products (B*G*nc, Q, Q),
    fp32."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    q = min(chunk, s)
    nc = s // q
    return 4 * (b * h * s + b * h * nc * p * n + b * g * nc * q * q)


def _flash_bwd_work(q, k, v, out, lse, do, **_):
    """The wrapper's delta = rowsum(do * out), (B, H, Sq) fp32."""
    b, sq, h, _ = q.shape
    return 4 * b * h * sq


# (plain version's module, function) -> workspace bytes of its kernel
KERNELS: Dict[tuple, Optional[Callable]] = {
    ("repro_torch.kernels.flash_attention.ref", "attention_fwd"): None,
    ("repro_torch.kernels.flash_attention.ref", "attention_bwd"):
        _flash_bwd_work,
    ("repro_torch.kernels.decode_attention.ref", "decode_attention"):
        _decode_work,
    ("repro_torch.kernels.decode_attention.ref", "decode_attention_paged"):
        _paged_work,
    ("repro_torch.kernels.lora_matmul.ref", "lora_matmul_fwd"): None,
    ("repro_torch.kernels.lora_matmul.ref", "lora_matmul_bwd"): None,
    ("repro_torch.kernels.lora_matmul.ref", "lora_matmul_indexed"):
        _indexed_work,
    ("repro_torch.kernels.smashed_quant.ref", "quantize"): None,
    ("repro_torch.kernels.smashed_quant.ref", "dequantize"): None,
    ("repro_torch.kernels.smashed_quant.ref", "roundtrip"): None,
    ("repro_torch.kernels.ssd_scan.ref", "ssd_chunked"): _ssd_work,
}


@dataclasses.dataclass
class Counts:
    flops: float
    bytes: float                 # HBM bytes (module docstring)
    peak_bytes: int              # most live tensor bytes at once
    kernel_calls: Dict[str, int]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _Tracker(TorchDispatchMode):
    """HBM bytes and live bytes by storage, outside the kernels' plain
    versions (``depth`` > 0 inside one)."""

    def __init__(self, flops: FlopCounterMode):
        super().__init__()
        self.flops = flops
        self.live: Dict[int, list] = {}     # storage -> [bytes, tensors]
        self.cur = self.peak = 0
        self.bytes = 0
        self.depth = 0
        self.calls: Dict[str, int] = {}
        self.memo: Dict[tuple, tuple] = {}

    def track(self, t: torch.Tensor) -> bool:
        """Count t as live until it is freed; True when its storage is
        new."""
        st = t.untyped_storage()
        key = st._cdata
        entry = self.live.get(key)
        fresh = entry is None
        if fresh:
            entry = self.live[key] = [st.nbytes(), 0]
            self.cur += entry[0]
            self.peak = max(self.peak, self.cur)
        entry[1] += 1
        weakref.finalize(t, self._release, key)
        return fresh

    def _release(self, key: int) -> None:
        entry = self.live[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.cur -= entry[0]
            del self.live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.depth:
            return out
        for t in _tensors(out):
            if self.track(t):
                self.bytes += 2 * _nbytes(t)
            elif func._schema.is_mutable:
                # what the op's other tensor arguments hold, at most t
                src = [_nbytes(a) for a in _tensors((args, kwargs))[1:]]
                self.bytes += 2 * min(_nbytes(t), max(src, default=_nbytes(t)))
        return out

    @staticmethod
    def _key(name: str, tensors, args, kwargs) -> tuple:
        return (name,
                repr([None if t is None else (tuple(t.shape), t.stride(),
                                              t.dtype) for t in tensors]),
                repr([a for a in args if not isinstance(a, torch.Tensor)]),
                repr(sorted((k, v) for k, v in kwargs.items()
                            if not isinstance(v, torch.Tensor))))

    def _replay(self, key):
        """A memoized call's outputs, its FLOPs, bytes and peak added."""
        added, metas, nbytes, excess, single = self.memo[key]
        counts = self.flops.flop_counts["Global"]
        for op, n in added.items():
            counts[op] += n
        self.bytes += nbytes
        self.peak = max(self.peak, self.cur + excess)
        outer = self.depth
        self.depth += 1             # their bytes are in nbytes already
        try:
            outs = [None if m is None else torch.empty_strided(m[0], m[1],
                                                               dtype=m[2])
                    for m in metas]
        finally:
            self.depth -= 1
        if not outer:               # a backward's gradients: live now
            for t in outs:
                if t is not None:
                    self.track(t)
        return outs[0] if single else tuple(outs)

    def _record(self, key, call):
        """call()'s outputs, its FLOPs, bytes and peak over the live bytes
        kept under `key`."""
        counts = self.flops.flop_counts["Global"]
        before, b0, c0, p0 = dict(counts), self.bytes, self.cur, self.peak
        self.peak = c0
        out = call()
        excess, self.peak = self.peak - c0, max(p0, self.peak)
        single = isinstance(out, torch.Tensor)
        metas = [None if t is None else (tuple(t.shape), t.stride(), t.dtype)
                 for t in ([out] if single else out)]
        added = {op: n - before.get(op, 0) for op, n in counts.items()
                 if n != before.get(op, 0)}
        self.memo[key] = (added, metas, self.bytes - b0, excess, single)
        return out

    def _plain(self, name: str, fn: Callable, args, kwargs):
        """fn(*args, **kwargs) outside autograd, memoized."""
        key = self._key(name, _tensors((args, kwargs)), args, kwargs)
        if key in self.memo:
            return self._replay(key)
        return self._record(key, lambda: fn(*args, **kwargs))

    def _recomputed(self, name: str, fn: Callable, args, kwargs):
        """fn under autograd as the card runs it: a forward outside
        autograd, a backward that recomputes fn with autograd and takes
        its gradients (both memoized)."""
        idx = [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]
        rest = [None if i in idx else a for i, a in enumerate(args)]
        return _Recomputed.apply((self, name, fn, rest, idx, kwargs),
                                 *[args[i] for i in idx])

    def _recomputed_grads(self, call, ts, gs, need):
        """The gradients of a _Recomputed call's tensors `ts` from its
        outputs' gradients `gs`: fn recomputed under autograd."""
        _, name, fn, rest, idx, kwargs = call
        key = self._key(name + " backward", list(ts) + list(gs), rest,
                        kwargs)
        if key in self.memo:
            return self._replay(key)

        def grads():
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(r) for t, r in zip(ts, need)]
                out = fn(*_filled(rest, idx, ins), **kwargs)
                outs = [out] if isinstance(out, torch.Tensor) else out
                pairs = [(o, g) for o, g in zip(outs, gs)
                         if g is not None and o.requires_grad]
                got = iter(torch.autograd.grad(
                    [o for o, _ in pairs], [t for t in ins if t.requires_grad],
                    [g for _, g in pairs], allow_unused=True))
                return tuple(next(got) if r else None for r in need)
        return self._record(key, grads)

    def as_kernel(self, name: str, fn: Callable, work: Optional[Callable]):
        def run(*args, **kwargs):
            if self.depth:              # inside another kernel's plain version
                return fn(*args, **kwargs)
            graph = torch.is_grad_enabled() and any(
                t.requires_grad for t in _tensors((args, kwargs)))
            self.depth += 1
            try:
                out = (self._recomputed if graph else self._plain)(
                    name, fn, args, kwargs)
            finally:
                self.depth -= 1
            self.calls[name] = self.calls.get(name, 0) + 1
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            for t in _tensors(out):
                self.track(t)
                self.bytes += _nbytes(t)
            scratch = work(*args, **kwargs) if work is not None else 0
            self.peak = max(self.peak, self.cur + scratch)
            return out
        return run


def _filled(rest, idx, ts):
    """The argument list `rest` with the tensors `ts` at positions idx."""
    full = list(rest)
    for i, t in zip(idx, ts):
        full[i] = t
    return full


class _Recomputed(torch.autograd.Function):
    """A kernel's plain version where autograd records it (the tracker's
    _recomputed): call = (tracker, name, fn, rest, idx, kwargs)."""

    @staticmethod
    def forward(ctx, call, *ts):
        ctx.call = call
        ctx.save_for_backward(*ts)
        tracker, name, fn, rest, idx, kwargs = call
        return tracker._plain(name, fn, tuple(_filled(rest, idx, ts)),
                              kwargs)

    @staticmethod
    def backward(ctx, *gs):
        call = ctx.call
        grads = call[0]._recomputed_grads(call, ctx.saved_tensors, gs,
                                          ctx.needs_input_grad[1:])
        return (None,) + tuple(grads)


@contextlib.contextmanager
def _kernels_as_kernels(tracker: _Tracker):
    """Swap each plain version in KERNELS for one that the tracker
    charges as its kernel, for the duration of the count."""
    saved = []
    try:
        for (mod_name, fn_name), work in KERNELS.items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, fn_name)
            saved.append((mod, fn_name, fn))
            setattr(mod, fn_name, tracker.as_kernel(fn_name, fn, work))
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def fake_mode_of(args) -> FakeTensorMode:
    for t in tree_leaves(args):
        if isinstance(t, FakeTensor):
            return t.fake_mode
    raise ValueError("count: the arguments hold no fake tensor (build them "
                     "under a FakeTensorMode, as launch/cells.py does)")


def count(fn: Callable, *args: Any) -> Counts:
    """Run fn(*args) on the arguments' fake tensors and count its FLOPs,
    HBM bytes and peak live bytes (see the module docstring).  The
    arguments are fake tensors of one FakeTensorMode (nested dicts,
    lists and tuples of them, and constants)."""
    mode = fake_mode_of(args)
    flops = FlopCounterMode(display=False)
    tracker = _Tracker(flops)
    with mode:
        for t in _tensors(args):
            tracker.track(t)
        with _kernels_as_kernels(tracker), flops, tracker:
            out = fn(*args)
        del out
    return Counts(flops=float(flops.get_total_flops()),
                  bytes=float(tracker.bytes), peak_bytes=tracker.peak,
                  kernel_calls=dict(tracker.calls))
