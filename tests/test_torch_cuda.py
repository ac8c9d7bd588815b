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

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import rounds, smashed  # noqa: E402
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
@pytest.mark.parametrize("hd", [16, 32, 64])
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
@pytest.mark.parametrize("hd", [16, 32, 64])
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
    an odd rank; 300 rows span two split-M slices of the backward."""
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
