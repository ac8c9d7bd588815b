"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked `cuda` and skips without a GPU; the file
imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-4 (the kernels sum in another order than the plain
versions), bf16 2e-2 (one rounding of the output to bf16); the int8
quantizers agree bit for bit (the same division and round-half-even).
The SSD scan's outputs grow with the chunk's sums, so its absolute
tolerance is scaled by max|y|.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import rounds, smashed  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.lora_matmul import ops as lops  # noqa: E402
from repro_torch.kernels.smashed_quant import ops as sops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import serving  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on "
                    "the card")
    return torch.device("cuda")


def _randn(gen, *shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dtype)


def _close(got, want, dtype):
    torch.testing.assert_close(got.cpu().float(), want.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


# Sq / Sk pairs that cross the kernels' edges: the 16-row warp tile, the
# 8-key accumulator tile, the 64-key tile, and lengths that divide none
FLASH_SIZES = [(s, s) for s in (1, 15, 16, 17, 63, 64, 65, 200)] + [
    (1, 200), (200, 1), (17, 65), (65, 17), (15, 64), (63, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("q_offset", [0, 4])
@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("sq,sk", FLASH_SIZES)
def test_flash_kernel_matches_plain(cuda, dtype, window, q_offset, hd, sq,
                                    sk):
    """Ragged lengths at every tile edge, GQA 4/2, each head dim, a q
    offset, and a 9-wide window."""
    gen = torch.Generator().manual_seed(sq * 1000 + sk)
    q = _randn(gen, 2, sq, 4, hd, dtype=dtype)
    k = _randn(gen, 2, sk, 2, hd, dtype=dtype)
    v = _randn(gen, 2, sk, 2, hd, dtype=dtype)
    out, lse = fops.flash_attention_fwd(q.to(cuda), k.to(cuda), v.to(cuda),
                                        window=window, q_offset=q_offset)
    want, want_lse = fops.flash_attention_fwd(q, k, v, window=window,
                                              q_offset=q_offset)
    _close(out, want, dtype)
    _close(lse, want_lse, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [5, 67])
def test_lora_indexed_kernel_matches_plain(cuda, dtype, m):
    gen = torch.Generator().manual_seed(1)
    k, n, r, p = 96, 80, 12, 3
    ranks = torch.tensor([12, 3, 7])
    mask = (torch.arange(r)[None, :] < ranks[:, None]).float()
    args = (_randn(gen, m, k, dtype=dtype),
            _randn(gen, k, n, dtype=dtype, scale=0.1),
            (_randn(gen, p, k, r, scale=0.1) * mask[:, None, :]).to(dtype),
            (_randn(gen, p, r, n, scale=0.1) * mask[:, :, None]).to(dtype),
            torch.tensor([0.5, 2.0, 1.0]),
            torch.randint(0, p, (m,), generator=gen, dtype=torch.int32))
    got = lops.lora_matmul_indexed(*[a.to(cuda) for a in args])
    _close(got, lops.lora_matmul_indexed(*args), dtype)
    # a row's result does not depend on the other rows of the launch
    one = lops.lora_matmul_indexed(*[a[:1].to(cuda) if i in (0, 5)
                                     else a.to(cuda)
                                     for i, a in enumerate(args)])
    assert torch.equal(one[0], got[0])


def _lora_pool_inputs(gen, dtype, m, k=768, n=768, r=16, p=4):
    """gpt2-small's q/k/v/o width: 4 adapters at r = 16 with effective
    ranks 16, 8, 16, 4 (masked rank columns)."""
    ranks = torch.tensor([16, 8, 16, 4])[:p].clamp(max=r)
    mask = (torch.arange(r)[None, :] < ranks[:, None]).float()
    return (_randn(gen, m, k, dtype=dtype),
            _randn(gen, k, n, dtype=dtype, scale=k ** -0.5),
            (_randn(gen, p, k, r, scale=r ** -0.5) * mask[:, None, :]).to(dtype),
            (_randn(gen, p, r, n, scale=0.02) * mask[:, :, None]).to(dtype),
            16.0 / ranks.float(),
            torch.randint(0, p, (m,), generator=gen, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_indexed_rows_do_not_depend_on_m(cuda, dtype):
    """At K = N = 768, r = 16: a row's bits are the same in launches of 1
    row (the serial reference's decode), 8 rows (the engine's tick) and
    128 rows (a prefill bucket), and two calls give the same bits."""
    gen = torch.Generator().manual_seed(15)
    x, w, a, b, s, ids = (t.to(cuda) for t in _lora_pool_inputs(gen, dtype,
                                                                 128))
    full = lops.lora_matmul_indexed(x, w, a, b, s, ids)
    _close(full, lops.lora_matmul_indexed(*(t.cpu() for t in
                                            (x, w, a, b, s, ids))), dtype)
    assert torch.equal(full, lops.lora_matmul_indexed(x, w, a, b, s, ids))
    tick = lops.lora_matmul_indexed(x[:8].contiguous(), w, a, b, s,
                                    ids[:8].contiguous())
    assert torch.equal(tick, full[:8])
    for i in (0, 5, 77, 127):
        one = lops.lora_matmul_indexed(x[i:i + 1].contiguous(), w, a, b, s,
                                       ids[i:i + 1].contiguous())
        assert torch.equal(one[0], full[i])


def _decode_edge_lens(s):
    """Cache lengths at the decode kernels' chunk edges (0, 1, CH - 1, CH,
    CH + 1, CH the kernels' positions per chunk) and the capacity s."""
    from repro_torch.kernels import _build
    ch = _build.library().decode_attention_chunk()
    return [0, 1, ch - 1, ch, ch + 1, s]


def _paged_copy(gen, k, v, ps=16):
    """The contiguous cache in a page pool behind a shuffled table; the
    table's entries past each valid prefix are garbage (the kernels clip
    them into the pool)."""
    b, s, kvh, hd = k.shape
    p_max = s // ps
    pt = (torch.randperm(b * p_max, generator=gen) + 1).reshape(b, p_max)
    pool_k = torch.zeros((1 + b * p_max, ps, kvh, hd), dtype=k.dtype)
    pool_v = torch.zeros_like(pool_k)
    pool_k[pt] = k.reshape(b, p_max, ps, kvh, hd)
    pool_v[pt] = v.reshape(b, p_max, ps, kvh, hd)
    return pool_k, pool_v, pt.to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("hd", [64, 112, 128])
def test_decode_kernels_at_chunk_edges(cuda, dtype, window, hd):
    """Cache lengths at the chunk edges and S, GQA 8 / 2, contiguous and
    paged against the plain version; paged bit-equal to contiguous; exact
    zeros at cache_len 0."""
    gen = torch.Generator().manual_seed(16 + hd)
    lens = _decode_edge_lens(208)
    b, s, h, kvh = len(lens), 208, 8, 2
    q = _randn(gen, b, h, hd, dtype=dtype)
    k = _randn(gen, b, s, kvh, hd, dtype=dtype)
    v = _randn(gen, b, s, kvh, hd, dtype=dtype)
    clen = torch.tensor(lens, dtype=torch.int32)
    kp, vp, pt = _paged_copy(gen, k, v)
    pt[1, 1:] = torch.tensor([-3, 10 ** 6] * 6, dtype=torch.int32)[:12]
    got = dops.decode_attention(*(t.to(cuda) for t in (q, k, v, clen)),
                                window=window)
    _close(got, dops.decode_attention(q, k, v, clen, window=window), dtype)
    assert torch.equal(got[0].cpu(), torch.zeros_like(got[0].cpu()))
    paged = dops.decode_attention_paged(
        *(t.to(cuda) for t in (q, kp, vp, pt, clen)), window=window)
    _close(paged, dops.decode_attention_paged(q, kp, vp, pt, clen,
                                              window=window), dtype)
    assert torch.equal(paged, got)


def _tick_decode_inputs(gen, dtype, cuda):
    """The serving tick: 8 slots, 12 heads of 64, max_len 256, cache
    lengths 128..156, the cache also in 16-position pages."""
    b, s, h, hd = 8, 256, 12, 64
    q = _randn(gen, b, h, hd, dtype=dtype)
    k = _randn(gen, b, s, h, hd, dtype=dtype)
    v = _randn(gen, b, s, h, hd, dtype=dtype)
    clen = torch.tensor([128 + 4 * i for i in range(b)], dtype=torch.int32)
    kp, vp, pt = _paged_copy(gen, k, v)
    return [t.to(cuda) for t in (q, k, v, clen, kp, vp, pt)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_rows_do_not_depend_on_b(cuda, dtype):
    """At the tick's shape a sequence's output is the same bits in a B = 1
    launch (the serial reference) as in the B = 8 launch (the engine),
    contiguous and paged; two calls give the same bits."""
    q, k, v, clen, kp, vp, pt = _tick_decode_inputs(
        torch.Generator().manual_seed(17), dtype, cuda)
    full = dops.decode_attention(q, k, v, clen)
    fullp = dops.decode_attention_paged(q, kp, vp, pt, clen)
    assert torch.equal(full, dops.decode_attention(q, k, v, clen))
    for i in range(q.shape[0]):
        sl = slice(i, i + 1)
        one = dops.decode_attention(q[sl], k[sl], v[sl], clen[sl])
        assert torch.equal(one[0], full[i])
        onep = dops.decode_attention_paged(q[sl], kp, vp, pt[sl], clen[sl])
        assert torch.equal(onep[0], fullp[i])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_paged_equals_contiguous_at_tick(cuda, dtype):
    """At the tick's shape the paged kernel gives the contiguous kernel's
    bits (paged and contiguous serving must give the same tokens), and
    both match the plain version."""
    q, k, v, clen, kp, vp, pt = _tick_decode_inputs(
        torch.Generator().manual_seed(18), dtype, cuda)
    got = dops.decode_attention(q, k, v, clen)
    assert torch.equal(dops.decode_attention_paged(q, kp, vp, pt, clen), got)
    _close(got, dops.decode_attention(*(t.cpu() for t in (q, k, v, clen))),
           dtype)


@pytest.mark.cuda
def test_decode_rejects_head_dims_it_does_not_take(cuda):
    q = torch.zeros(1, 2, 20, device=cuda)
    kv = torch.zeros(1, 16, 2, 20, device=cuda)
    clen = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        dops.decode_attention(q, kv, kv, clen)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_kernels_match_plain(cuda, dtype, window):
    gen = torch.Generator().manual_seed(2)
    b, s, h, kvh, hd, ps = 4, 96, 8, 2, 64, 16
    q = _randn(gen, b, h, hd, dtype=dtype)
    k = _randn(gen, b, s, kvh, hd, dtype=dtype)
    v = _randn(gen, b, s, kvh, hd, dtype=dtype)
    clen = torch.tensor([0, 1, 65, 96], dtype=torch.int32)
    got = dops.decode_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                clen.to(cuda), window=window)
    want = dops.decode_attention(q, k, v, clen, window=window)
    _close(got, want, dtype)
    assert torch.equal(got[0].cpu(), torch.zeros_like(got[0].cpu()))
    # the same cache in a page pool behind a shuffled table with garbage
    p_max = s // ps
    pt = (torch.randperm(b * p_max, generator=gen) + 1).reshape(b, p_max)
    pool_k = torch.zeros((1 + b * p_max, ps, kvh, hd), dtype=dtype)
    pool_v = torch.zeros_like(pool_k)
    pool_k[pt] = k.reshape(b, p_max, ps, kvh, hd)
    pool_v[pt] = v.reshape(b, p_max, ps, kvh, hd)
    pt = pt.to(torch.int32)
    pt[1, 1:] = torch.tensor([0, -7, 9999, 3, 2], dtype=torch.int32)
    args = (q, pool_k, pool_v, pt, clen)
    got = dops.decode_attention_paged(*[a.to(cuda) for a in args],
                                      window=window)
    _close(got, dops.decode_attention_paged(*args, window=window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [0, 16])
def test_engine_on_card_matches_serial_reference(cuda, page_size):
    arch = reduced(get_config("gpt2-small"), d_model=64, vocab=256,
                   seq_len=32)
    model = build_model(arch, device=cuda)
    params = model.init_params(torch.Generator().manual_seed(0))
    pool = serving.build_adapter_pool(model, torch.Generator().manual_seed(1),
                                      3, ranks=[4, 2, 4])
    rng = np.random.default_rng(3)
    reqs = [serving.Request(rid=i, adapter=i % 3,
                            tokens=rng.integers(3, 250, size=5 + 3 * i),
                            max_new=6) for i in range(5)]
    want, logits = serving.serial_reference(model, params, pool, reqs,
                                            max_len=64, return_logits=True)
    launches = lops.lora_matmul_indexed.launches
    res = serving.ServingEngine(
        model, params, pool,
        serving.ServeConfig(num_slots=2, max_len=64, page_size=page_size),
        device=cuda).run(reqs)
    assert lops.lora_matmul_indexed.launches > launches
    for r in res:
        # compare up to the first near tie: the batched and the one-row
        # head/MLP matmuls may round differently in the last bit
        top2 = torch.topk(logits[r["rid"]], 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        upto = next((i for i, g in enumerate(gaps) if g < 1e-4), len(gaps))
        assert r["tokens"][:upto] == want[r["rid"]][:upto]


def _flash_inputs(gen, dtype, b=2, sq=37, sk=41, h=4, kvh=2, hd=64):
    return (_randn(gen, b, sq, h, hd, dtype=dtype),
            _randn(gen, b, sk, kvh, hd, dtype=dtype),
            _randn(gen, b, sk, kvh, hd, dtype=dtype),
            _randn(gen, b, sq, h, hd, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("q_offset", [0, 4])
@pytest.mark.parametrize("hd", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("sq,sk", FLASH_SIZES)
def test_flash_bwd_kernel_matches_plain(cuda, dtype, window, q_offset, hd,
                                        sq, sk):
    """dQ/dK/dV from the same residuals: ragged lengths at every tile
    edge, GQA 4/2, each head dim, a q offset and a 9-wide window (rows
    that see no key included)."""
    gen = torch.Generator().manual_seed(4 + sq * 1000 + sk)
    q, k, v, do = _flash_inputs(gen, dtype, sq=sq, sk=sk, hd=hd)
    kw = dict(window=window, q_offset=q_offset)
    out, lse = fops.flash_attention_fwd(q, k, v, **kw)
    want = fops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    got = fops.flash_attention_bwd(*[t.to(cuda) for t in
                                     (q, k, v, out, lse, do)], **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_row_without_keys_is_zero(cuda, dtype):
    """Rows whose 9-wide window ends before the first key (position 4 +
    qi >= 9 with one key) get zeros, lse 0 and zero gradients, never NaN."""
    gen = torch.Generator().manual_seed(6)
    q, k, v, do = _flash_inputs(gen, dtype, sq=17, sk=1)
    kw = dict(window=9, q_offset=4)
    q, k, v, do = (t.to(cuda) for t in (q, k, v, do))
    out, lse = fops.flash_attention_fwd(q, k, v, **kw)
    dq, dk, dv = fops.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    blind = slice(5, None)                 # 4 + qi >= 9
    assert torch.equal(out[:, blind].cpu(), torch.zeros_like(out[:, blind].cpu()))
    assert torch.equal(lse.reshape(2, 4, 17)[..., blind].cpu(),
                       torch.zeros(2, 4, 12))
    assert torch.equal(dq[:, blind].cpu(), torch.zeros_like(dq[:, blind].cpu()))
    for t in (out, lse, dq, dk, dv):
        assert torch.isfinite(t.float()).all()
    assert out[:, :5].abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,bucket,window", [(37, 64, 0), (37, 128, 0),
                                             (100, 256, 9), (1, 16, 0),
                                             (64, 65, 0)])
def test_flash_padded_prompt_rows_are_bit_equal(cuda, dtype, n, bucket,
                                                window):
    """A prompt's rows equal, bit for bit, the same prompt's rows padded to
    a serving bucket with large garbage: masked keys contribute exact
    zeros, whatever tile or grid the longer launch takes."""
    gen = torch.Generator().manual_seed(n + bucket)
    q, k, v = (_randn(gen, 1, n, 12, 64, dtype=dtype) for _ in range(3))

    def pad(t):
        junk = _randn(gen, 1, bucket - n, 12, 64, dtype=dtype, scale=100.0)
        return torch.cat([t, junk], 1).to(cuda)

    out, lse = fops.flash_attention_fwd(q.to(cuda), k.to(cuda), v.to(cuda),
                                        window=window)
    pout, plse = fops.flash_attention_fwd(pad(q), pad(k), pad(v),
                                          window=window)
    assert torch.equal(out, pout[:, :n])
    assert torch.equal(lse.reshape(12, n), plse.reshape(12, bucket)[:, :n])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_is_deterministic(cuda, dtype):
    """Two backward calls on the same inputs give the same bits (no
    atomics; the GQA group sum is a loop in one CTA)."""
    gen = torch.Generator().manual_seed(8)
    q, k, v, do = (t.to(cuda) for t in _flash_inputs(
        gen, dtype, b=3, sq=300, sk=300, h=8, kvh=2))
    out, lse = fops.flash_attention_fwd(q, k, v)
    first = fops.flash_attention_bwd(q, k, v, out, lse, do)
    again = fops.flash_attention_bwd(q, k, v, out, lse, do)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_autograd_on_card_matches_plain(cuda, dtype):
    """torch.autograd.grad through flash_attention on the card gives the
    plain version's dQ/dK/dV (the forward kernel alone has no grad_fn)."""
    gen = torch.Generator().manual_seed(5)
    q, k, v, do = _flash_inputs(gen, dtype, sq=41)
    grads = {}
    for dev in ("cpu", cuda):
        ins = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        out = fops.flash_attention(*ins)
        grads[str(dev)] = torch.autograd.grad(
            (out.float() * do.to(dev).float()).sum(), ins)
    for g, w in zip(grads[str(cuda)], grads["cpu"]):
        _close(g, w, dtype)


def _lora_fused_inputs(gen, dtype, m, r, k=96, n=80):
    mask = (torch.arange(r) < r - 2).float()        # two masked rank slots
    return (_randn(gen, m, k, dtype=dtype),
            _randn(gen, k, n, dtype=dtype, scale=0.1),
            (_randn(gen, k, r, scale=0.1) * mask).to(dtype),
            (_randn(gen, r, n, scale=0.1) * mask[:, None]).to(dtype),
            torch.tensor(2.0),
            _randn(gen, m, n, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,r", [(37, 5), (300, 16)])
def test_lora_fused_kernels_match_plain(cuda, dtype, m, r):
    """Forward (y, xa) and backward (dx, dA, dB, dscale) at ragged M and
    an odd rank; 300 rows span ten 32-row slices of the dA/dB pass."""
    gen = torch.Generator().manual_seed(6)
    x, w, a, b, s, g = _lora_fused_inputs(gen, dtype, m, r)
    want_y, want_xa = lops.lora_matmul_fwd(x, w, a, b, s)
    got_y, got_xa = lops.lora_matmul_fwd(*[t.to(cuda) for t in
                                           (x, w, a, b, s)])
    _close(got_y, want_y, dtype)
    _close(got_xa, want_xa, dtype)
    want = lops.lora_matmul_bwd(x, w, a, b, s, g, want_xa)
    got = lops.lora_matmul_bwd(*[t.to(cuda) for t in
                                 (x, w, a, b, s, g, want_xa)])
    for gt, wt in zip(got, want):
        assert gt.dtype == wt.dtype and gt.shape == wt.shape
        _close(gt, wt, dtype)


@pytest.mark.cuda
def test_lora_matmul_autograd_on_card_matches_plain(cuda):
    """dx, dA, dB and dscale through lora_matmul on the card; W frozen."""
    gen = torch.Generator().manual_seed(7)
    x, w, a, b, s, g = _lora_fused_inputs(gen, torch.float32, 60, 8)
    x = x.reshape(3, 20, -1)
    grads = {}
    for dev in ("cpu", cuda):
        ins = [t.to(dev).requires_grad_(True) for t in (x, a, b, s)]
        y = lops.lora_matmul(ins[0], w.to(dev), ins[1], ins[2], ins[3])
        grads[str(dev)] = torch.autograd.grad(
            (y * g.to(dev).reshape(3, 20, -1)).sum(), ins)
    for gt, wt in zip(grads[str(cuda)], grads["cpu"]):
        _close(gt, wt, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smashed_kernels_match_plain(cuda, dtype):
    """Quantize, dequantize and the round trip agree bit for bit, ties
    and an all-zero channel (scale 1e-12 / 127) included."""
    gen = torch.Generator().manual_seed(8)
    x = _randn(gen, 3, 2, 70, 40, dtype=dtype)        # (G, B, S, d)
    x[:, :, :, 5] = 0.0
    x[0, 0, 0, 7] = 127.0                             # x / scale = 1 exactly
    x[0, 0, 1, 7] = 0.5                               # a tie at .5 * scale
    q, scale = sops.int8_quantize_smashed(x.to(cuda))
    want_q, want_scale = sops.int8_quantize_smashed(x)
    assert torch.equal(q.cpu(), want_q) and torch.equal(scale.cpu(),
                                                        want_scale)
    got = sops.int8_dequantize_smashed(q, scale, dtype)
    assert torch.equal(got.cpu(), sops.int8_dequantize_smashed(
        want_q, want_scale, dtype))
    rt = sops.int8_roundtrip_smashed(x.to(cuda))
    assert rt.dtype == dtype and torch.equal(rt.cpu(),
                                             sops.int8_roundtrip_smashed(x))


@pytest.mark.cuda
def test_round_grads_on_card_match_cpu(cuda):
    """One round's per-client losses and adapter gradients (reduced
    gpt2-small, hd 16, cuts [1, 2, 3], int8 smashed) on the card and on
    the CPU plain path from one state.  Gradients to 1e-2 of the largest:
    a cotangent element within fp32 noise of an int8 rounding boundary
    takes the neighbouring code on one side, a step of one quantum (1/127
    of its channel's amax)."""
    arch = reduced(get_config("gpt2-small"), layers=4, d_model=64, vocab=256,
                   seq_len=32)
    rng = np.random.default_rng(9)
    toks = rng.integers(3, 256, size=(3, 2, 33)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(arch, device=dev)
        params = model.init_params(torch.Generator().manual_seed(0))
        state = rounds.init_state(model, torch.Generator().manual_seed(1),
                                  num_clients=3)
        gen = torch.Generator().manual_seed(2)
        for side in ("client_adapters", "server_adapters"):
            for targets in state[side].values():
                for leaf in targets.values():
                    leaf["B"] = _randn(gen, *leaf["B"].shape,
                                       scale=0.05).to(dev)
        state["cuts"] = torch.tensor([1, 2, 3], dtype=torch.int32)
        _, met, gc, gs = rounds.round_grads(
            model, params, state, batch, np.array([0.2, 0.3, 0.5]),
            boundary=smashed.make_boundary(smashed.make_compressor("int8"),
                                           state["cuts"]))
        out[str(dev)] = (met["ce"], tree_leaves(gc) + tree_leaves(gs))
    (ce_k, g_k), (ce_c, g_c) = out[str(cuda)], out["cpu"]
    torch.testing.assert_close(ce_k.cpu(), ce_c, rtol=1e-4, atol=1e-4)
    scale = max(float(g.abs().max()) for g in g_c)
    for gk, gc_ in zip(g_k, g_c):
        torch.testing.assert_close(gk.cpu(), gc_, rtol=1e-3,
                                   atol=1e-2 * scale)


def _llama_hd128(window=0):
    """Reduced llama3-8b at head dim 128: d_model 256 over 2 heads and 1
    kv head (GQA 2:1), RoPE; with a window on its odd layers when asked
    (gpt-neo's local_every_other on a RoPE model)."""
    arch = reduced(get_config("llama3-8b"), layers=3, d_model=256,
                   vocab=256, seq_len=48)
    return arch.replace(model=dataclasses.replace(
        arch.model, num_heads=2, num_kv_heads=1, head_dim=128,
        local_window=window, local_every_other=bool(window)))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 32])
def test_dense_hd128_round_grads_on_card_match_cpu(cuda, window):
    """One round's per-client losses and adapter gradients of reduced
    llama3-8b at head dim 128 (the hd-128 flash kernels, RoPE, GQA 2:1,
    and a 32-wide window on the odd layers at seq 48), uncompressed, on
    the card and on the CPU plain path from one state.  Gradients to
    1e-3 of the largest: fp32 sums in another order, and this reduced
    model is ill-conditioned there (the CPU's own fp32 gradients sit
    1.8e-4 of the largest from the same step with fp64 weights and
    adapters)."""
    arch = _llama_hd128(window)
    rng = np.random.default_rng(10)
    toks = rng.integers(3, 256, size=(3, 2, 49)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(arch, device=dev)
        params = model.init_params(torch.Generator().manual_seed(0))
        state = rounds.init_state(model, torch.Generator().manual_seed(1),
                                  num_clients=3)
        gen = torch.Generator().manual_seed(2)
        for side in ("client_adapters", "server_adapters"):
            for targets in state[side].values():
                for leaf in targets.values():
                    leaf["B"] = _randn(gen, *leaf["B"].shape,
                                       scale=0.05).to(dev)
        state["cuts"] = torch.tensor([1, 2, 2], dtype=torch.int32)
        _, met, gc, gs = rounds.round_grads(
            model, params, state, batch, np.array([0.2, 0.3, 0.5]),
            boundary=smashed.make_boundary(smashed.make_compressor("none"),
                                           state["cuts"]))
        out[str(dev)] = (met["ce"], tree_leaves(gc) + tree_leaves(gs))
    (ce_k, g_k), (ce_c, g_c) = out[str(cuda)], out["cpu"]
    torch.testing.assert_close(ce_k.cpu(), ce_c, rtol=1e-4, atol=1e-4)
    scale = max(float(g.abs().max()) for g in g_c)
    for gk, gc_ in zip(g_k, g_c):
        torch.testing.assert_close(gk.cpu(), gc_, rtol=1e-3,
                                   atol=1e-3 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [0, 8])
def test_dense_hd128_engine_on_card_matches_serial_reference(cuda,
                                                             page_size):
    """Reduced llama3-8b at head dim 128 with a 32-wide window on its odd
    layers, served on the card: prompts and generations past the window
    through the hd-128 prefill and decode kernels, tokens equal to the
    card's one-request serial reference up to a top-2 logit gap."""
    model = build_model(_llama_hd128(32), device=cuda)
    params = model.init_params(torch.Generator().manual_seed(0))
    pool = serving.build_adapter_pool(model, torch.Generator().manual_seed(1),
                                      3, ranks=[4, 2, 4])
    rng = np.random.default_rng(11)
    reqs = [serving.Request(rid=i, adapter=i % 3,
                            tokens=rng.integers(3, 250, size=20 + 5 * i),
                            max_new=10) for i in range(4)]
    res = serving.ServingEngine(
        model, params, pool,
        serving.ServeConfig(num_slots=2, max_len=48, page_size=page_size),
        device=cuda).run(reqs)
    want, logits = serving.serial_reference(model, params, pool, reqs,
                                            max_len=48, return_logits=True)
    for r in res:
        top2 = torch.topk(logits[r["rid"]], 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        upto = next((i for i, g in enumerate(gaps) if g < 1e-4), len(gaps))
        assert r["tokens"][:upto] == want[r["rid"]][:upto]


def _ssd_inputs(gen, dtype, b, s, h, p, g, n, dt_scale=1.0):
    """SSD inputs near mamba2's: dt = softplus(. + 0.5), A = -exp(.)."""
    x = _randn(gen, b, s, h, p, dtype=dtype)
    dt = torch.nn.functional.softplus(_randn(gen, b, s, h) + 0.5) * dt_scale
    a = -torch.exp(_randn(gen, h, scale=0.5))
    bm = _randn(gen, b, s, g, n, dtype=dtype, scale=0.3)
    c = _randn(gen, b, s, g, n, dtype=dtype, scale=0.3)
    return x, dt, a, bm, c


def _ssd_close(got, want, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(
        got.cpu().float(), want.float(), rtol=tol,
        atol=tol * max(1.0, float(want.float().abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 4, 16, 1, 16, 16),
                                   (1, 160, 4, 64, 2, 128, 80),
                                   (1, 512, 3, 64, 1, 128, 256)])
def test_ssd_kernel_matches_plain(cuda, dtype, shape):
    """G = 1 and 2; chunks of 16, 80 (not a multiple of the 64-row tile)
    and 256 with dt ~ 3, where a chunk's decay passes exp(88)."""
    b, s, h, p, g, n, chunk = shape
    gen = torch.Generator().manual_seed(10)
    ins = _ssd_inputs(gen, dtype, b, s, h, p, g, n,
                      dt_scale=3.0 if chunk == 256 else 1.0)
    got = ssd_ops.ssd_scan(*[t.to(cuda) for t in ins], chunk=chunk)
    want = ssd_ops.ref.ssd_chunked(*ins, chunk=chunk)
    assert got.dtype == dtype and torch.isfinite(got).all()
    _ssd_close(got, want, dtype)


@pytest.mark.cuda
def test_ssd_autograd_on_card_matches_plain(cuda):
    """The kernel's forward with the plain recompute backward on the card
    against plain autograd on the CPU, at chunk 256 past exp(88)."""
    gen = torch.Generator().manual_seed(11)
    ins = _ssd_inputs(gen, torch.float32, 1, 512, 2, 16, 1, 32)
    gy = _randn(gen, 1, 512, 2, 16)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_(True) for t in ins]
        y = ssd_ops.ssd_scan(*leaves, chunk=256)
        grads[str(dev)] = torch.autograd.grad((y * gy.to(dev)).sum(), leaves)
    for gk, gc in zip(grads[str(cuda)], grads["cpu"]):
        assert torch.isfinite(gk).all()
        torch.testing.assert_close(gk.cpu(), gc, rtol=1e-4,
                                   atol=1e-4 * float(gc.abs().max()))


# prefill shapes of the final state: (B, S, H, P, G, N, chunk, true
# length): a chunk of 1 (a one-token prompt), of 37 (a 37-token prompt),
# a 300-token prompt zero-padded to 512 at chunk 256 (dt = 0 on the
# padding), and zamba2's H = P = N = 64
SSD_STATE_SHAPES = [(2, 3, 4, 16, 1, 32, 1, 3), (1, 37, 8, 64, 1, 128, 37, 37),
                    (1, 512, 4, 64, 1, 128, 256, 300),
                    (2, 64, 64, 64, 1, 64, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_STATE_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_ssd_kernel_final_state_matches_plain(cuda, dtype, shape):
    """ssd_scan(return_state=True) on the card launches the kernel (its
    own counter, not the plain scan) and its y and final state match
    ref.ssd_chunked(return_state=True); the state comes back in x's
    dtype as the reference's does, and equals the recurrence's at the
    prompt's true length."""
    b, s, h, p, g, n, chunk, true_len = shape
    gen = torch.Generator().manual_seed(s + chunk)
    ins = list(_ssd_inputs(gen, dtype, b, s, h, p, g, n))
    ins[1][:, true_len:] = 0.0
    before = (ssd_ops.ssd_scan_fwd_state.launches,
              ssd_ops.ssd_scan_fwd.launches)
    y, st = ssd_ops.ssd_scan(*[t.to(cuda) for t in ins], chunk=chunk,
                             return_state=True)
    assert (ssd_ops.ssd_scan_fwd_state.launches,
            ssd_ops.ssd_scan_fwd.launches) == (before[0] + 1, before[1])
    want_y, want_st = ssd_ops.ref.ssd_chunked(*ins, chunk=chunk,
                                              return_state=True)
    assert st.dtype == dtype and torch.isfinite(st.float()).all()
    _ssd_close(y, want_y, dtype)
    _ssd_close(st, want_st, dtype)
    _, at_len = ssd_ops.ref.ssd_sequential(
        *[t[:, :true_len] if t.dim() > 1 else t for t in ins],
        return_state=True)
    _ssd_close(st, at_len, dtype)
    y2, st2 = ssd_ops.ssd_scan(*[t.to(cuda) for t in ins], chunk=chunk,
                               return_state=True)
    assert torch.equal(y2, y) and torch.equal(st2, st)


@pytest.mark.cuda
def test_ssd_final_state_autograd_on_card_matches_plain(cuda):
    """Gradients through y and the final state (the plain recompute
    backward) on the card against plain autograd on the CPU."""
    gen = torch.Generator().manual_seed(12)
    ins = _ssd_inputs(gen, torch.float32, 1, 128, 2, 16, 1, 32)
    gy, gs = _randn(gen, 1, 128, 2, 16), _randn(gen, 1, 2, 16, 32)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_(True) for t in ins]
        y, st = ssd_ops.ssd_scan(*leaves, chunk=64, return_state=True)
        loss = (y * gy.to(dev)).sum() + (st * gs.to(dev)).sum()
        grads[str(dev)] = torch.autograd.grad(loss, leaves)
    for gk, gc in zip(grads[str(cuda)], grads["cpu"]):
        torch.testing.assert_close(gk.cpu(), gc, rtol=1e-4,
                                   atol=1e-4 * float(gc.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 37])
@pytest.mark.parametrize("k,n", [(1536, 6448), (2048, 8384), (3072, 1536),
                                 (4096, 2048)])
def test_lora_indexed_kernel_at_ssm_widths(cuda, dtype, m, k, n):
    """The served SSD layers' projections: ssm_in of mamba2 (K = 1536,
    N = 6448) and zamba2 (K = 2048, N = 8384), neither N a multiple of
    128, and ssm_out (K = 3072 and 4096), at a decode row and a
    37-token prefill, r = 16 over 2 adapters."""
    gen = torch.Generator().manual_seed(k + n + m)
    x, w, a, b, scale, ids = _lora_pool_inputs(gen, dtype, m, k=k, n=n, p=2)
    got = lops.lora_matmul_indexed(*(t.to(cuda) for t in
                                     (x, w, a, b, scale, ids)))
    _close(got, lops.lora_matmul_indexed(x, w, a, b, scale, ids), dtype)


def _ssm_serving_pair(name, dev):
    arch = reduced(get_config(name), layers=3, d_model=64, vocab=256)
    model = build_model(arch, device=dev)
    params = model.init_params(torch.Generator().manual_seed(0))
    pool = serving.build_adapter_pool(model, torch.Generator().manual_seed(1),
                                      2, ranks=[4, 2])
    return model, params, pool


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-1.2b"])
def test_ssm_prefill_and_decode_on_card_match_cpu(cuda, name):
    """Reduced mamba2 and zamba2 served one request at a time on the card
    (prefill through the SSD kernel with the final state, decode through
    the recurrence, the indexed LoRA, and zamba2's attention through the
    flash and decode kernels) against the CPU plain path: prompts of 2,
    3, 17 and 40 tokens (40 pads to 48 at chunk 16), 6 new tokens, logits
    at 1e-3 (fp32 sums in another order), and tokens equal up to a top-2
    logit gap."""
    rng = np.random.default_rng(3)
    reqs = [serving.Request(rid=i, adapter=i % 2,
                            tokens=rng.integers(3, 250, size=plen),
                            max_new=6)
            for i, plen in enumerate((2, 3, 17, 40))]
    out = {}
    for dev in ("cpu", cuda):
        model, params, pool = _ssm_serving_pair(name, dev)
        out[str(dev)] = serving.serial_reference(
            model, params, pool, reqs, max_len=48, return_logits=True)
    (tok_c, log_c), (tok_g, log_g) = out["cpu"], out[str(cuda)]
    for r in reqs:
        torch.testing.assert_close(log_g[r.rid], log_c[r.rid], rtol=1e-3,
                                   atol=1e-3)
        top2 = torch.topk(log_c[r.rid], 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        upto = next((i for i, g in enumerate(gaps) if g < 1e-4), len(gaps))
        assert tok_g[r.rid][:upto] == tok_c[r.rid][:upto]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(130, 1536, 6448), (2560, 1536, 6448),
                                   (2560, 3072, 1536)])
def test_lora_fused_forward_at_mamba2_ragged_width(cuda, m, k, n):
    """mamba2's ssm_in (K = 1536, N = 6448, not a multiple of the 64-wide
    tile) and ssm_out (K = 3072, N = 1536), rank 16, at a ragged M and at
    the eval step's M = 5 clients x batch 1 x seq 512."""
    gen = torch.Generator().manual_seed(12)
    x, w, a, b, s, _ = _lora_fused_inputs(gen, torch.float32, m, 16,
                                          k=k, n=n)
    want_y, want_xa = lops.lora_matmul_fwd(x, w, a, b, s)
    got_y, got_xa = lops.lora_matmul_fwd(*[t.to(cuda) for t in
                                           (x, w, a, b, s)])
    _close(got_y, want_y, torch.float32)
    _close(got_xa, want_xa, torch.float32)


# the fused LoRA at the wide pass's tile edges: (M, K, N, r); K = 61 and
# 97 and N = 83 leave rows not 16-byte aligned; (300, 768, 6448) takes the
# 128-row CTAs with a ragged M and N
LORA_RAGGED = [(1, 61, 80, 1), (37, 96, 80, 5), (130, 97, 136, 8),
               (257, 96, 83, 64), (300, 768, 6448, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LORA_RAGGED,
                         ids=lambda c: "-".join(map(str, c)))
def test_lora_fused_ragged_matches_plain(cuda, dtype, case):
    """Forward (y, xa) and backward (dx, dA, dB, dscale) with M, K and N off
    the tiles, unaligned rows and r of 1 to 64."""
    m, k, n, r = case
    gen = torch.Generator().manual_seed(m + k + n + r)
    x, w, a, b, s, g = _lora_fused_inputs(gen, dtype, m, r, k=k, n=n)
    want_y, want_xa = lops.lora_matmul_fwd(x, w, a, b, s)
    got_y, got_xa = lops.lora_matmul_fwd(*[t.to(cuda) for t in
                                           (x, w, a, b, s)])
    _close(got_y, want_y, dtype)
    _close(got_xa, want_xa, dtype)
    want = lops.lora_matmul_bwd(x, w, a, b, s, g, want_xa)
    got = lops.lora_matmul_bwd(*[t.to(cuda) for t in
                                 (x, w, a, b, s, g, want_xa)])
    for i, (gt, wt) in enumerate(zip(got, want)):
        assert gt.dtype == wt.dtype and gt.shape == wt.shape
        if i == 0:
            _close(gt, wt, dtype)
        else:   # dA, dB, dscale reduce over M rows: tolerance scales
            _ssd_close(gt, wt, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_fused_is_deterministic(cuda, dtype):
    """Two forward and two backward calls on the same inputs give the same
    bits (fixed-order sums, no atomics)."""
    gen = torch.Generator().manual_seed(13)
    args = [t.to(cuda) for t in _lora_fused_inputs(gen, dtype, 2560, 16,
                                                   k=1536, n=6448)]
    x, w, a, b, s, g = args
    first = lops.lora_matmul_fwd(x, w, a, b, s)
    for u, v in zip(first, lops.lora_matmul_fwd(x, w, a, b, s)):
        assert torch.equal(u, v)
    grads = lops.lora_matmul_bwd(x, w, a, b, s, g, first[1])
    for u, v in zip(grads, lops.lora_matmul_bwd(x, w, a, b, s, g, first[1])):
        assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [10240, 1000, 4100])
def test_lora_dab_at_path_shape_and_ragged_slices(cuda, dtype, m):
    """dA and dB of the backward at the gpt2 eval shape (M = 10240, K = N =
    768, r = 16: 22 slices of 480 rows) and at M = 1000 and 4100 (slices of
    64 and 192 rows, the last one ragged) against the plain version on the
    card, with the tolerance scaled by max|want| (a sum over M rows); two
    calls give the same bits."""
    gen = torch.Generator().manual_seed(m)
    x, w, a, b, s, g = (t.to(cuda) for t in _lora_fused_inputs(
        gen, dtype, m, 16, k=768, n=768))
    xa = lops.ref.lora_matmul_fwd(x, w, a, b, s)[1]
    got = lops.lora_matmul_bwd(x, w, a, b, s, g, xa)
    want = lops.ref.lora_matmul_bwd(x, w, a, b, s, g, xa)
    for gt, wt in zip(got[1:3], want[1:3]):
        assert gt.dtype == wt.dtype and gt.shape == wt.shape
        _ssd_close(gt, wt.cpu(), dtype)
    for u, v in zip(got, lops.lora_matmul_bwd(x, w, a, b, s, g, xa)):
        assert torch.equal(u, v)


BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _same_bits(got, want):
    """Equal bit patterns (so +0 and -0 differ), dtypes and shapes."""
    got = got.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.is_floating_point():
        got, want = got.view(BITS[got.dtype]), want.view(BITS[want.dtype])
    assert torch.equal(got, want)


def _int8_inputs(seed, dtype, g, m, d):
    """x (G, M, d) with an all-zero channel 5 and, in message 0's channel
    7 (amax 127, so scale = 1 exactly), exact halfway ties and -0.5."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((g, m, d), generator=gen) * 3.0
    x[..., 5] = 0.0
    ties = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5])
    n = min(m, len(ties))
    x[0, :n, 7] = ties[:n]
    if m > n:
        x[0, n:, 7] = x[0, n:, 7].clamp(-100.0, 100.0)
    return x.to(dtype).contiguous()


# the gpt2 training path's shape (5 messages of 4 x 512 tokens, d 768) and
# the emulated test's ragged cases (tests/test_torch_int8_emulated.py)
INT8_SHAPES = [(5, 2048, 768), (2, 37, 136), (1, 1, 70), (3, 20, 64),
               (2, 45, 68), (1, 1100, 64), (1, 2100, 16), (1, 4200, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", INT8_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_int8_kernels_bit_equal_to_plain(cuda, dtype, shape):
    """Quantize (q, scale), dequantize and the round trip on the card
    against the plain version on the CPU, bit for bit, ties, -0 and an
    all-zero channel included; a second call gives the same bits."""
    g, m, d = shape
    x = _int8_inputs(g * 1000 + m + d, dtype, g, m, d)
    want_q, want_scale = sops.ref.quantize(x)
    xc = x.to(cuda)
    q, scale = sops.int8_quantize_smashed(xc)
    _same_bits(q, want_q)
    _same_bits(scale, want_scale)
    deq = sops.int8_dequantize_smashed(want_q.to(cuda), want_scale.to(cuda),
                                       dtype)
    _same_bits(deq, sops.ref.dequantize(want_q, want_scale, dtype))
    y = sops.int8_roundtrip_smashed(xc)
    _same_bits(y, sops.ref.roundtrip(x))
    _same_bits(sops.int8_roundtrip_smashed(xc), y.cpu())
    q2, scale2 = sops.int8_quantize_smashed(xc)
    _same_bits(q2, q.cpu())
    _same_bits(scale2, scale.cpu())


@pytest.mark.cuda
def test_int8_cluster_launch_is_not_refused(cuda):
    """Quantize and the round trip launch as clusters of 8 CTAs at the
    training path's shape: a refused launch would raise from the wrapper,
    and an error during the run shows at the synchronize."""
    assert _build.library().smashed_quant_cluster() == 8
    x = torch.randn(5, 2048, 768, device=cuda)
    before = (sops.int8_quantize_smashed.launches,
              sops.int8_roundtrip_smashed.launches)
    sops.int8_quantize_smashed(x)
    sops.int8_roundtrip_smashed(x)
    torch.cuda.synchronize()
    assert (sops.int8_quantize_smashed.launches,
            sops.int8_roundtrip_smashed.launches) == (before[0] + 1,
                                                      before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [16, 128, 256])
@pytest.mark.parametrize("chunk", [16, 64, 256])
@pytest.mark.parametrize("heads_per_group", [1, 2, 4, 8])
@pytest.mark.parametrize("groups", [1, 2, 3])
def test_ssd_kernel_grouped_matches_plain(cuda, dtype, n, chunk,
                                          heads_per_group, groups):
    """C.B^T once per group: G of 1 to 3 with H / G of 1 to 8, state widths
    16, 128 and 256, chunks of 16, 64 and 256 (dt ~ 3 at 256, where a
    chunk's decay passes exp(88))."""
    h = groups * heads_per_group
    gen = torch.Generator().manual_seed(groups * 1000 + heads_per_group * 100
                                        + chunk + n)
    ins = _ssd_inputs(gen, dtype, 1, 512, h, 64 if h <= 8 else 16, groups,
                      n, dt_scale=3.0 if chunk == 256 else 1.0)
    got = ssd_ops.ssd_scan(*[t.to(cuda) for t in ins], chunk=chunk)
    want = ssd_ops.ref.ssd_chunked(*ins, chunk=chunk)
    assert got.dtype == dtype and torch.isfinite(got).all()
    _ssd_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_is_deterministic(cuda, dtype):
    """Two calls at the mamba2 path's shape give the same bits."""
    gen = torch.Generator().manual_seed(14)
    ins = [t.to(cuda) for t in _ssd_inputs(gen, dtype, 5, 512, 48, 64, 1,
                                           128)]
    first = ssd_ops.ssd_scan(*ins, chunk=256)
    assert torch.equal(first, ssd_ops.ssd_scan(*ins, chunk=256))


@pytest.mark.cuda
def test_system_rounds_on_the_card_match_the_cpu(cuda):
    """Two SplitFTSystem rounds of reduced gpt2-small (int8 smashed, the
    accuracy controller) from one seed on the card and on the CPU: the
    per-round loss and per-client ce within rtol 1e-4, the eval ce within
    1e-3, comm bytes equal, and cuts equal while the eval accuracies
    agree."""
    import dataclasses

    from repro_torch.core.system import SplitFTSystem, SystemConfig

    arch = reduced(get_config("gpt2-small"), layers=6, d_model=64,
                   vocab=2048, seq_len=64, batch=4)
    arch = arch.replace(
        train=dataclasses.replace(arch.train, lr_client=3e-3,
                                  lr_server=3e-3),
        data=dataclasses.replace(arch.data, partition="dirichlet",
                                 alpha=0.9, num_clients=5))
    cfg = SystemConfig(num_samples=400, eval_samples=64,
                       smashed_compress="int8")
    hist = {dv: SplitFTSystem(arch, cfg, seed=0, device=dv).run(
        2, log_every=0) for dv in (cuda, "cpu")}
    for a, b in zip(hist[cuda], hist["cpu"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_allclose(a["ce"], b["ce"], rtol=1e-4)
        np.testing.assert_allclose(a["eval_ce"], b["eval_ce"], rtol=1e-3)
        np.testing.assert_array_equal(a["comm"], b["comm"])
        np.testing.assert_array_equal(a["cuts"], b["cuts"])
        if not np.array_equal(a["eval_accuracy"], b["eval_accuracy"]):
            break


@pytest.mark.cuda
def test_population_rounds_on_the_card_match_the_cpu(cuda):
    """Two rounds of reduced gpt2-small in population mode (a cohort of 3
    from 12, int8 smashed) from one seed on the card and on the CPU: the
    same cohorts, the losses within rtol 1e-4, comm bytes equal; after a
    gather every leaf is on the device and in the dtype it had (the
    policy and bookkeeping leaves stay host tensors)."""
    from repro_torch.core.system import SplitFTSystem, SystemConfig
    from repro_torch.tree import tree_leaves_with_path

    arch = reduced(get_config("gpt2-small"), layers=2, d_model=64,
                   vocab=512, seq_len=32)
    cfg = SystemConfig(num_samples=80, eval_samples=16, population=12,
                       smashed_compress="int8", straggler_sim=True)
    systems = {dv: SplitFTSystem(arch, cfg, seed=0, device=dv)
               for dv in (cuda, "cpu")}
    pids = {dv: [] for dv in systems}
    hist = {dv: s.run(2, log_every=0, callback=lambda rec, dv=dv: pids[
        dv].append(systems[dv]._cohort_pids.copy()))
        for dv, s in systems.items()}
    for a, b in zip(pids[cuda], pids["cpu"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(hist[cuda], hist["cpu"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
        np.testing.assert_array_equal(a["comm"], b["comm"])
    s = systems[cuda]
    before = {keys: (leaf.device, leaf.dtype)
              for keys, leaf in tree_leaves_with_path(s.state)}
    assert before[("client_adapters",) + next(iter(tree_leaves_with_path(
        s.state["client_adapters"])))[0]][0].type == "cuda"
    assert before[("cuts",)][0].type == "cpu"
    got = s.store.gather(s.state, s._cohort_pids)
    assert {keys: (leaf.device, leaf.dtype) for keys, leaf in
            tree_leaves_with_path(got)} == before


def _small_state(model, dev, cuts, seed=1):
    state = rounds.init_state(model, torch.Generator().manual_seed(seed),
                              num_clients=len(cuts))
    gen = torch.Generator().manual_seed(seed + 1)
    for side in ("client_adapters", "server_adapters"):
        for targets in state[side].values():
            for leaf in targets.values():
                leaf["B"] = _randn(gen, *leaf["B"].shape, scale=0.05).to(dev)
    state["cuts"] = torch.tensor(cuts, dtype=torch.int32)
    return state


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_through_the_ssd_kernel_matches_cpu(cuda, remat):
    """Reduced mamba2 (2 layers, seq 64 in chunks of 16) under layer
    recompute: on the card each layer's recompute relaunches the SSD
    kernel and its backward recomputes the plain scan, whose own chunk
    checkpoints then nest inside the outer recompute.  The card's remat
    step equals its "none" step and the CPU's within the fp32 tolerances
    of test_round_grads_on_card_match_cpu without compression
    (chip_smoke.py reports whether remat is bitwise); the SSD kernel
    launches twice per layer."""
    arch = reduced(get_config("mamba2-780m"), layers=2, d_model=64,
                   vocab=256, seq_len=64)
    rng = np.random.default_rng(3)
    toks = rng.integers(3, 256, size=(2, 2, 65)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    out = {}
    for dev, mode in (("cpu", remat), (cuda, "none"), (cuda, remat)):
        model = build_model(arch, device=dev)
        params = model.init_params(torch.Generator().manual_seed(0))
        state = _small_state(model, dev, [1, 2])
        before = ssd_ops.ssd_scan_fwd.launches
        _, met, gc, gs = rounds.round_grads(
            model, params, state, batch, np.array([0.25, 0.75]),
            remat=mode)
        out[str(dev), mode] = (met["ce"].cpu(), [
            g.cpu() for g in tree_leaves(gc) + tree_leaves(gs)],
            ssd_ops.ssd_scan_fwd.launches - before)
    (ce_r, g_r, n_r), (ce_n, g_n, n_n) = (out[str(cuda), remat],
                                          out[str(cuda), "none"])
    assert (n_n, n_r) == (2, 4)
    ce_c, g_c, _ = out["cpu", remat]
    scale = max(float(g.abs().max()) for g in g_c)
    for ce, grads in ((ce_n, g_n), (ce_c, g_c)):
        torch.testing.assert_close(ce_r, ce, rtol=1e-4, atol=1e-4)
        for gk, gw in zip(g_r, grads):
            torch.testing.assert_close(gk, gw, rtol=1e-3, atol=1e-4 * scale)


@pytest.mark.cuda
def test_multi_boundary_int8_bucket_matches_cpu(cuda):
    """The co-controller's per-client boundary on the card: clients at
    cuts [1, 2, 2] choosing int8, topk (keep fraction 0.25) and int8;
    outputs and straight-through cotangents bit for bit against the CPU
    (the int8 quantizers agree bit for bit, topk is a selection), and
    one int8 round trip per cut layer where a client chose int8, forward
    and backward."""
    gen = torch.Generator().manual_seed(4)
    x = _randn(gen, 3, 2, 64, 768)
    g = _randn(gen, 3, 2, 64, 768)
    comps = tuple(smashed.make_compressor(c, topk_frac=0.1)
                  for c in ("none", "int8", "topk"))
    cuts, choice = torch.tensor([1, 2, 2]), torch.tensor([1, 2, 1])
    frac = torch.tensor([0.1, 0.25, 0.1])
    got = {}
    for dev in ("cpu", cuda):
        bnd = smashed.make_multi_boundary(comps, cuts, choice,
                                          topk_frac=frac)
        before = sops.int8_roundtrip_smashed.launches
        for fid in range(3):
            xd = x.to(dev).requires_grad_(True)
            y = bnd(xd, fid)
            (gx,) = torch.autograd.grad(y, xd, g.to(dev))
            got[str(dev), fid] = (y.detach().cpu(), gx.cpu())
        got[str(dev)] = sops.int8_roundtrip_smashed.launches - before
    assert got[str(cuda)] == 4
    for fid in range(3):
        for a, b in zip(got[str(cuda), fid], got["cpu", fid]):
            assert torch.equal(a, b), fid


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_smashed_ef_under_remat_is_bitwise_on_card(cuda, remat):
    """Smashed top-k with error feedback under layer recompute on the
    card: the residual is an output of the recomputed layer, so two
    rounds under remat equal two rounds without it bit for bit (losses,
    residual, adapters); and the card's residual agrees with the CPU's to
    1e-2 of its largest (a magnitude within fp32 noise of the k-th
    largest is kept on one side only)."""
    arch = reduced(get_config("gpt2-small"), layers=4, d_model=64, vocab=256,
                   seq_len=32, batch=2)
    rng = np.random.default_rng(11)
    toks = rng.integers(3, 256, size=(3, 2, 33)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    w, act = np.array([0.2, 0.3, 0.5], np.float32), np.ones(3, np.float32)
    out = {}
    for dev, mode in ((cuda, "none"), (cuda, remat), ("cpu", remat)):
        model = build_model(arch, device=dev)
        params = model.init_params(torch.Generator().manual_seed(0))
        state = rounds.with_smashed_ef(_small_state(model, dev, [1, 2, 3]),
                                       model)
        step = rounds.make_train_step(model, smashed_compress="topk",
                                      remat=mode)
        for _ in range(2):
            state, met = step(params, state, batch, w, act, 1e-2, 1e-2)
        out[str(dev), mode] = (met["ce"].cpu(), state["smashed_ef"].cpu(),
                               [x.cpu() for x in
                                tree_leaves(state["client_adapters"])])
    (ce_n, ef_n, ad_n), (ce_r, ef_r, ad_r) = (out[str(cuda), "none"],
                                              out[str(cuda), remat])
    assert torch.equal(ce_n, ce_r) and torch.equal(ef_n, ef_r)
    assert all(torch.equal(a, b) for a, b in zip(ad_n, ad_r))
    ce_c, ef_c, _ = out["cpu", remat]
    torch.testing.assert_close(ce_r, ce_c, rtol=1e-4, atol=1e-4)
    assert float(ef_c.abs().max()) > 0
    torch.testing.assert_close(ef_r, ef_c, rtol=1e-3,
                               atol=1e-2 * float(ef_c.abs().max()))


@pytest.mark.cuda
def test_adapter_compression_on_card_matches_cpu(cuda):
    """Adapter top-k with error feedback and the int8 round trip on card
    tensors: bit for bit the CPU's on the same inputs (distinct
    magnitudes, so both select the same entries; int8 divides and rounds
    alike), and the same wire bytes."""
    from repro_torch.optim import compression

    gen = torch.Generator().manual_seed(12)
    tree = {"a": _randn(gen, 2, 5, 96, 16), "b": _randn(gen, 2, 5, 16, 96)}
    resid = {k: _randn(gen, *v.shape, scale=0.1) for k, v in tree.items()}
    on = {k: v.to(cuda) for k, v in tree.items()}
    r_on = {k: v.to(cuda) for k, v in resid.items()}
    d_k, e_k, n_k = compression.ErrorFeedback.apply(on, r_on, 0.05)
    d_c, e_c, n_c = compression.ErrorFeedback.apply(tree, resid, 0.05)
    assert n_k == n_c
    q_k = compression.int8_dequantize(compression.int8_quantize(on))
    q_c = compression.int8_dequantize(compression.int8_quantize(tree))
    for k in tree:
        assert torch.equal(d_k[k].cpu(), d_c[k])
        assert torch.equal(e_k[k].cpu(), e_c[k])
        assert torch.equal(q_k[k].cpu(), q_c[k])


ENGINE_OPTIONS = {
    "local_steps": (dict(max_local_steps=2, smashed_compress="topk",
                         compress="topk"), 1e-2),
    "async": (dict(async_buffer=True, buffer_size=2), 1e-4),
    "edge_groups": (dict(num_edges=2, compress="int8",
                         smashed_compress="int8"), 1e-2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ENGINE_OPTIONS))
def test_engine_options_on_card_match_cpu(cuda, name):
    """One SGD step of the local-steps engine (budgets [1, 2], smashed
    top-k + EF, adapter top-k), an async tick that fills a buffer of 2 at
    staleness [2, 1], and a two-tier round with int8 adapter deltas, on
    reduced gpt2-small: per-client losses within 1e-4 and the adapter
    deltas within 1e-3 relative plus the case's share of max|delta| (a
    top-k or int8 element next to the k-th magnitude or a rounding
    boundary moves on one side only)."""
    opt, share = ENGINE_OPTIONS[name]
    arch = reduced(get_config("gpt2-small"), layers=4, d_model=64, vocab=256,
                   seq_len=32, batch=2)
    arch = arch.replace(train=dataclasses.replace(arch.train,
                                                  optimizer="sgd"))
    rng = np.random.default_rng(13)
    toks = rng.integers(3, 256, size=(2, 3, 2, 33)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if opt.get("max_local_steps", 1) == 1:
        batch = {k: v[0] for k, v in batch.items()}
    w, act = np.array([0.2, 0.3, 0.5], np.float32), np.ones(3, np.float32)
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(arch, device=dev)
        params = model.init_params(torch.Generator().manual_seed(0))
        state = rounds.prepare_state(
            _small_state(model, dev, [1, 2, 3]),
            max_local_steps=opt.get("max_local_steps", 1),
            async_buffer=opt.get("async_buffer", False),
            edge_groups=opt.get("num_edges", 1))
        if "max_local_steps" in opt:
            state["step_budgets"] = torch.tensor([1, 2, 2],
                                                 dtype=torch.int32)
            state = rounds.with_smashed_ef(rounds.with_error_feedback(state),
                                           model)
        if opt.get("async_buffer"):
            state["global_version"] = torch.tensor(2, dtype=torch.int32)
            state["adapter_version"] = torch.tensor([0, 1, 2],
                                                    dtype=torch.int32)
            act = np.array([1, 1, 0], np.float32)
        start = [x.clone() for x in tree_leaves(state["client_adapters"])]
        new, met = rounds.make_train_step(model, **opt)(
            params, state, batch, w, act, 1e-2, 1e-2)
        out[str(dev)] = (met["ce"].cpu(), [
            (a - b).cpu() for a, b in
            zip(tree_leaves(new["client_adapters"]), start)])
    (ce_k, d_k), (ce_c, d_c) = out[str(cuda)], out["cpu"]
    torch.testing.assert_close(ce_k, ce_c, rtol=1e-4, atol=1e-4)
    scale = max(float(d.abs().max()) for d in d_c)
    for a, b in zip(d_k, d_c):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=share * scale)


# ---------------------------------------------------------------------------
# Head dim 112 and the MoE family (kimi-k2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 112, 128])
@pytest.mark.parametrize("sq,sk,window", [(17, 65, 0), (200, 200, 9),
                                          (512, 512, 0), (1024, 1024, 0)])
def test_flash_gqa8_matches_plain(cuda, dtype, hd, sq, sk, window):
    """GQA 8:1 (kimi-k2, llama4-maverick, internvl2-76b), 8 query heads
    over 1 kv head, forward and backward, at ragged lengths and at 512
    and 1024 (64 and 128 query tiles for each key tile: the fp32 dk/dv
    kernel adds its partial sums into the outputs every 8), at kimi-k2's
    head dim 112, at the others' 128 and at 64."""
    gen = torch.Generator().manual_seed(hd + sq)
    q, do = (_randn(gen, 2, sq, 8, hd, dtype=dtype) for _ in range(2))
    k, v = (_randn(gen, 2, sk, 1, hd, dtype=dtype) for _ in range(2))
    out, lse = fops.flash_attention_fwd(q.to(cuda), k.to(cuda), v.to(cuda),
                                        window=window)
    want, want_lse = fops.flash_attention_fwd(q, k, v, window=window)
    _close(out, want, dtype)
    _close(lse, want_lse, dtype)
    got = fops.flash_attention_bwd(*[t.to(cuda) for t in
                                     (q, k, v, want, want_lse, do)],
                                   window=window)
    for g, w in zip(got, fops.flash_attention_bwd(q, k, v, want, want_lse,
                                                  do, window=window)):
        _close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_hd112_gqa8_matches_plain(cuda, dtype):
    """Decode at kimi-k2's head dim and GQA 8:1 (64 heads over 8 at full
    width), at every chunk edge, contiguous and paged; paged bit-equal to
    contiguous."""
    gen = torch.Generator().manual_seed(1128)
    lens = _decode_edge_lens(208)
    b, s, h, kvh, hd = len(lens), 208, 16, 2, 112
    q = _randn(gen, b, h, hd, dtype=dtype)
    k = _randn(gen, b, s, kvh, hd, dtype=dtype)
    v = _randn(gen, b, s, kvh, hd, dtype=dtype)
    clen = torch.tensor(lens, dtype=torch.int32)
    kp, vp, pt = _paged_copy(gen, k, v)
    got = dops.decode_attention(*(t.to(cuda) for t in (q, k, v, clen)))
    _close(got, dops.decode_attention(q, k, v, clen), dtype)
    paged = dops.decode_attention_paged(*(t.to(cuda) for t in
                                          (q, kp, vp, pt, clen)))
    _close(paged, dops.decode_attention_paged(q, kp, vp, pt, clen), dtype)
    assert torch.equal(paged, got)


def _kimi_hd112():
    """Reduced kimi-k2 at head dim 112: d_model 448 over 4 heads and 2 kv
    heads, 8 experts top-2 with a shared expert, capacity factor 1.25
    (pairs are dropped at seq 48)."""
    arch = reduced(get_config("kimi-k2-1t-a32b"), layers=3, d_model=448,
                   vocab=256, seq_len=48, experts=8)
    return arch.replace(model=dataclasses.replace(arch.model,
                                                  moe_capacity_factor=1.25))


def _kimi_routes():
    """Records each MoE layer's top-k choices (transformer.moe_route)."""
    from repro_torch.models import transformer

    calls, route = [], transformer.moe_route

    def recording(cfg, yg, router):
        got = route(cfg, yg, router)
        calls.append((got[2].cpu(), int((got[3] >= got[4]).sum())))
        return got

    return calls, route, recording


@pytest.mark.cuda
def test_moe_hd112_forward_and_round_on_card_match_cpu(cuda):
    """Reduced kimi-k2 at head dim 112 on the card and on the CPU plain
    path from one draw of the weights: the same top-k choices in every
    layer (with drops), logits within 1e-3, then one round's per-client
    losses (aux included) within 1e-4 and adapter gradients within 1e-2
    of the largest, uncompressed: this reduced model is ill-conditioned
    there (the CPU's own fp32 gradients sit 1.5e-3 of the largest from
    the same step with the weights and adapters in float64)."""
    from repro_torch.models import transformer

    arch = _kimi_hd112()
    assert arch.model.head_dim == 112
    rng = np.random.default_rng(12)
    toks = rng.integers(3, 256, size=(3, 2, 49)).astype(np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(arch, device=dev)
        params = model.init_params(torch.Generator().manual_seed(0))
        calls, route, recording = _kimi_routes()
        transformer.moe_route = recording
        try:
            with torch.no_grad():
                x, aux, _ = model.forward(params, None, {
                    "tokens": torch.as_tensor(toks[0, :, :-1], device=dev)})
                logits = model.head(params, x).cpu()
        finally:
            transformer.moe_route = route
        state = rounds.init_state(model, torch.Generator().manual_seed(1),
                                  num_clients=3)
        gen = torch.Generator().manual_seed(2)
        for side in ("client_adapters", "server_adapters"):
            for targets in state[side].values():
                for leaf in targets.values():
                    leaf["B"] = _randn(gen, *leaf["B"].shape,
                                       scale=0.05).to(dev)
        state["cuts"] = torch.tensor([1, 2, 2], dtype=torch.int32)
        _, met, gc, gs = rounds.round_grads(
            model, params, state, batch, np.array([0.2, 0.3, 0.5]),
            boundary=smashed.make_boundary(smashed.make_compressor("none"),
                                           state["cuts"]))
        out[str(dev)] = (calls, logits, met["ce"] + met["aux"],
                         tree_leaves(gc) + tree_leaves(gs))
    (r_k, lg_k, ce_k, g_k), (r_c, lg_c, ce_c, g_c) = out[str(cuda)], out["cpu"]
    assert len(r_k) == len(r_c) == 3
    for (ik, dk), (ic, dc) in zip(r_k, r_c):
        assert torch.equal(ik, ic) and dk == dc
    assert sum(d for _, d in r_c) > 0
    torch.testing.assert_close(lg_k, lg_c, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(ce_k.cpu(), ce_c, rtol=1e-4, atol=1e-4)
    scale = max(float(g.abs().max()) for g in g_c)
    for gk, gc_ in zip(g_k, g_c):
        torch.testing.assert_close(gk.cpu(), gc_, rtol=1e-3,
                                   atol=1e-2 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [0, 8])
def test_moe_hd112_engine_on_card_matches_serial_reference(cuda, page_size):
    """Reduced kimi-k2 at head dim 112 served on the card: prompts of a
    bucket's length (16 and 32), so the engine's prefill has the serial
    reference's capacity; tokens equal to the card's one-request serial
    reference up to a top-2 logit gap."""
    model = build_model(_kimi_hd112(), device=cuda)
    params = model.init_params(torch.Generator().manual_seed(0))
    pool = serving.build_adapter_pool(model, torch.Generator().manual_seed(1),
                                      3, ranks=[4, 2, 4])
    rng = np.random.default_rng(14)
    reqs = [serving.Request(rid=i, adapter=i % 3,
                            tokens=rng.integers(3, 250, size=plen),
                            max_new=10) for i, plen in enumerate((16, 32, 16))]
    res = serving.ServingEngine(
        model, params, pool,
        serving.ServeConfig(num_slots=2, max_len=48, page_size=page_size),
        device=cuda).run(reqs)
    want, logits = serving.serial_reference(model, params, pool, reqs,
                                            max_len=48, return_logits=True)
    for r in res:
        top2 = torch.topk(logits[r["rid"]], 2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        upto = next((i for i, g in enumerate(gaps) if g < 1e-4), len(gaps))
        assert r["tokens"][:upto] == want[r["rid"]][:upto]
