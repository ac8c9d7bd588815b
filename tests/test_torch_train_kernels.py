"""Parity of the training slice's kernel modules against the JAX package.

The same numpy inputs go through the reference's Pallas functions in
interpret mode and through the port's plain versions (the path a CPU
tensor takes): the flash attention backward, the fused LoRA forward and
backward, and the smashed int8 quantize / round trip / dequantize.  The
port's autograd Functions are held against ``jax.vjp`` of the reference's
``custom_vjp`` wrappers, routed through the Pallas kernels
(REPRO_PALLAS_INTERPRET=1).  Tolerance: 2e-5 in fp32, the slice-1 kernel
tolerance; the int8 quantizers agree bit for bit (codes, scales and
dequantized values).  The CUDA kernels are held against these plain
versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import smashed as j_smashed  # noqa: E402
from repro.kernels.flash_attention import kernel as jfk  # noqa: E402
from repro.kernels.flash_attention import ops as jfops  # noqa: E402
from repro.kernels.lora_matmul import kernel as jlk  # noqa: E402
from repro.kernels.lora_matmul import ops as jlops  # noqa: E402
from repro.kernels.smashed_quant import kernel as jsk  # noqa: E402
from repro.kernels.smashed_quant import ops as jsops  # noqa: E402
from repro_torch.core import smashed as t_smashed  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfops  # noqa: E402
from repro_torch.kernels.lora_matmul import ops as tlops  # noqa: E402
from repro_torch.kernels.smashed_quant import ops as tsops  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got_t, want_j):
    np.testing.assert_allclose(got_t.detach().float().numpy(),
                               np.asarray(want_j, np.float32), **TOL)


# ---------------------------------------------------------------------------
# flash attention backward


FLASH_BWD = {
    # name: (H, KVH, causal, window, q_offset)
    "gqa_causal": (4, 2, True, 0, 0),
    "gqa_window": (4, 2, True, 5, 0),
    "gqa_offset": (4, 2, True, 0, 3),
    "bidirectional": (2, 1, False, 0, 0),
}


def _flash_inputs(h, kvh, b=2, s=16, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, hd), (b, s, kvh, hd), (b, s, kvh, hd),
                          (b, s, h, hd))]


@pytest.mark.parametrize("case", list(FLASH_BWD))
def test_flash_bwd_plain_matches_pallas(case):
    """Both backwards start from the Pallas forward's (out, lse)."""
    h, kvh, causal, window, q_offset = FLASH_BWD[case]
    q, k, v, do = _flash_inputs(h, kvh)
    kw = dict(causal=causal, window=window)
    out, lse = jfk.flash_attention_pallas(q, k, v, q_offset, bq=8, bk=8,
                                          interpret=True, **kw)
    want = jfk.flash_attention_bwd_pallas(q, k, v, out, lse, do, q_offset,
                                          bq=8, bk=8, interpret=True, **kw)
    got = tfops.flash_attention_bwd(_t(q), _t(k), _t(v), _t(out), _t(lse),
                                    _t(do), q_offset=q_offset, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("case", list(FLASH_BWD))
def test_flash_autograd_matches_reference_vjp(case, monkeypatch):
    """The port's autograd Function on the CPU vs jax.vjp of the
    reference's custom_vjp wrapper through the Pallas kernels."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    h, kvh, causal, window, q_offset = FLASH_BWD[case]
    q, k, v, do = _flash_inputs(h, kvh, seed=1)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out_j, vjp = jax.vjp(lambda a, b, c: jfops.flash_attention(a, b, c, **kw),
                         q, k, v)
    want = vjp(jnp.asarray(do))
    ins = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out_t = tfops.flash_attention(*ins, **kw)
    _close(out_t, out_j)
    got = torch.autograd.grad(out_t, ins, grad_outputs=_t(do))
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# fused LoRA, forward and backward


def _lora_inputs(m=16, k=32, n=32, r=5, seed=2):
    """Rank 5, which the reference's wrapper pads to 8 with zero columns;
    the last rank column is masked to zero, as mask_adapters does."""
    rng = np.random.default_rng(seed)
    mask = (np.arange(r) < r - 1).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    a = (rng.normal(size=(k, r)) * 0.1 * mask).astype(np.float32)
    b = (rng.normal(size=(r, n)) * 0.1 * mask[:, None]).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    return x, w, a, b, np.float32(2.0), g


def _pad_rank(a, b, to=8):
    r = a.shape[1]
    return (np.pad(a, ((0, 0), (0, to - r))), np.pad(b, ((0, to - r), (0, 0))))


def test_lora_fused_fwd_plain_matches_pallas():
    x, w, a, b, s, _ = _lora_inputs()
    a_p, b_p = _pad_rank(a, b)
    y_j, xa_j = jlk.lora_matmul_pallas(x, w, a_p, b_p, s, bm=8, bn=16, bk=16,
                                       interpret=True)
    y_t, xa_t = tlops.lora_matmul_fwd(_t(x), _t(w), _t(a), _t(b), _t(s))
    _close(y_t, y_j)
    _close(xa_t, np.asarray(xa_j)[:, :a.shape[1]])


def test_lora_fused_bwd_plain_matches_pallas():
    x, w, a, b, s, g = _lora_inputs(seed=3)
    a_p, b_p = _pad_rank(a, b)
    _, xa_j = jlk.lora_matmul_pallas(x, w, a_p, b_p, s, bm=8, bn=16, bk=16,
                                     interpret=True)
    dx_j, da_j, db_j, ds_j = jlk.lora_matmul_bwd_pallas(
        x, w, a_p, b_p, s, g, xa_j, bm=8, bn=16, bk=16, interpret=True)
    r = a.shape[1]
    dx, da, db, ds = tlops.lora_matmul_bwd(
        _t(x), _t(w), _t(a), _t(b), _t(s), _t(g),
        _t(np.asarray(xa_j)[:, :r]))
    _close(dx, dx_j)
    _close(da, np.asarray(da_j)[:, :r])
    _close(db, np.asarray(db_j)[:r])
    _close(ds, ds_j)


def test_lora_autograd_matches_reference_vjp(monkeypatch):
    """lora_matmul on (B, S, K) rows: dx, dA, dB, dscale against jax.vjp
    of the reference wrapper's Pallas custom_vjp with lora_only=True; W
    gets no gradient."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    x, w, a, b, s, g = _lora_inputs(seed=4)
    x3, g3 = x.reshape(2, 8, -1), g.reshape(2, 8, -1)
    y_j, vjp = jax.vjp(lambda x_, a_, b_, s_: jlops.lora_matmul(
        x_, w, a_, b_, s_, lora_only=True), x3, a, b, jnp.float32(s))
    want = vjp(jnp.asarray(g3))
    ins = [_t(v).requires_grad_(True) for v in (x3, a, b, s)]
    w_t = _t(w).requires_grad_(True)
    y_t = tlops.lora_matmul(ins[0], w_t, ins[1], ins[2], ins[3])
    _close(y_t, y_j)
    got = torch.autograd.grad(y_t, ins + [w_t], grad_outputs=_t(g3),
                              allow_unused=True)
    for gt, wt in zip(got[:4], want):
        _close(gt, wt)
    assert got[4] is None


# ---------------------------------------------------------------------------
# smashed int8 quantizers


def _acts(shape, seed):
    """Activations with a hot channel, an all-zero channel and exact ties."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x[..., 1] *= 40.0
    x[..., 2] = 0.0
    x[..., 0, 3] = 127.0
    x[..., 1, 3] = 2.5                        # x / scale = 2.5: a tie
    return x


def _padded(x, bm):
    g, m, d = x.shape
    return np.pad(x, ((0, 0), (0, (-m) % bm), (0, (-d) % 128))), m, d


@pytest.mark.parametrize("shape", [(2, 40, 24), (3, 64, 130)])
def test_smashed_plain_matches_pallas(shape):
    x = _acts(shape, seed=5)
    xp, m, d = _padded(x, 32 if shape[1] < 64 else 64)
    bm = 32 if shape[1] < 64 else 64
    q_j, scale_j = jsk.quantize_pallas(xp, bm=bm, interpret=True)
    q_t, scale_t = tsops.int8_quantize_smashed(_t(x))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j)[:, :m, :d])
    np.testing.assert_array_equal(scale_t.numpy(),
                                  np.asarray(scale_j)[:, :d])
    deq_j = jsk.dequantize_pallas(q_j, scale_j, bm=bm,
                                  interpret=True)[:, :m, :d]
    np.testing.assert_array_equal(
        tsops.int8_dequantize_smashed(q_t, scale_t).numpy(),
        np.asarray(deq_j))
    rt_j = jsk.roundtrip_pallas(xp, bm=bm, interpret=True)[:, :m, :d]
    np.testing.assert_array_equal(
        tsops.int8_roundtrip_smashed(_t(x)).numpy(), np.asarray(rt_j))


def test_smashed_wrappers_canonicalize_like_the_reference(monkeypatch):
    """(N, B, S, d) messages and a 2-D single message, through the
    reference's wrappers in interpret mode."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    x4 = _acts((3, 2, 20, 48), seed=6)
    np.testing.assert_array_equal(
        tsops.int8_roundtrip_smashed(_t(x4)).numpy(),
        np.asarray(jsops.int8_roundtrip_smashed(x4)))
    x2 = x4[0, 0]
    q_j, s_j = jsops.int8_quantize_smashed(x2)
    q_t, s_t = tsops.int8_quantize_smashed(_t(x2))
    assert q_t.shape == x2.shape and s_t.shape == (48,)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(
        tsops.int8_dequantize_smashed(q_t, s_t).numpy(),
        np.asarray(jsops.int8_dequantize_smashed(q_j, s_j)))


@pytest.mark.parametrize("name", ["int8", "fp8", "topk"])
def test_smashed_straight_through_matches_reference_vjp(name, monkeypatch):
    """The compressor and its straight-through backward (the same
    compressor on the cotangent) against jax.vjp of the reference's."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    x = _acts((3, 2, 8, 40), seed=7)
    g = _acts((3, 2, 8, 40), seed=8)
    comp_j = j_smashed.make_compressor(name, topk_frac=0.25)
    comp_t = t_smashed.make_compressor(name, topk_frac=0.25)
    y_j, vjp = jax.vjp(comp_j.apply, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    x_t = _t(x).requires_grad_(True)
    y_t = comp_t.apply(x_t)
    (got,) = torch.autograd.grad(y_t, x_t, grad_outputs=_t(g))
    _close(y_t, y_j)
    _close(got, want)
