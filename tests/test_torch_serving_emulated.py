"""The serving tick's CUDA sources, run on the CPU by the warp emulator.

src/repro_torch/csrc/lora_indexed.cu (the indexed multi-adapter LoRA)
and decode_attention.cu (flash-decode, contiguous and paged) are compiled
with g++ against tests/cuda_emu/ (tests/cuda_emu/build.py): every CUDA
thread is a fiber, shuffles, mma.sync and 16-byte cp.async run as on the
card, and blocks run one after another, so the last CTA of each
reduction (the one that finds its counter at the end) is the last one
launched.  The emulated MMA multiplies exactly and sums in double, so the
numbers are close to, not equal to, the card's; the tolerances are the
card tests' (tests/test_torch_cuda.py TOL).  What this holds on the CPU is
the kernels' logic: the K split and its combine, the chunk split and its
merge, the counters left at zero for the next call, ragged and unaligned
edges, clamped ids and pages, rows that do not depend on the rest of the
launch, paged equal to contiguous and bit-equal repeated calls.
"""

import ctypes
import importlib.util
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402
from repro_torch.kernels.lora_matmul import ref as lref  # noqa: E402

EMU = Path(__file__).resolve().parent / "cuda_emu"
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CODE = {torch.float32: 0, torch.bfloat16: 1}
P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _emu_build():
    spec = importlib.util.spec_from_file_location("emu_build",
                                                  EMU / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    so = _emu_build().build(tmp_path_factory.mktemp("serve_emu"),
                            ["lora_indexed", "decode_attention"],
                            name="serve_emu")
    lib = ctypes.CDLL(str(so))
    lib.lora_indexed.argtypes = [P_] * 9 + [I_] * 6 + [P_]
    lib.lora_indexed_work.argtypes = [I_] * 4
    lib.lora_indexed_work.restype = ctypes.c_longlong
    lib.lora_indexed_counters.argtypes = [I_, I_]
    lib.decode_attention.argtypes = [P_] * 7 + [I_] * 6 + [F_, I_, P_]
    lib.decode_attention_paged.argtypes = [P_] * 8 + [I_] * 8 + [F_, I_, P_]
    lib.decode_attention_work.argtypes = [I_] * 4
    lib.decode_attention_work.restype = ctypes.c_longlong
    lib.decode_attention_chunk.argtypes = []
    lib.lora_indexed_ctas.argtypes = [I_] * 3
    return lib


def _ptr(t):
    return t.data_ptr()


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


# ---- indexed LoRA ---------------------------------------------------------

def _lora(lib, x, w, a, b, s, ids):
    m, k = x.shape
    n, (p, _, r) = w.shape[1], a.shape
    y = torch.full((m, n), float("nan"), dtype=x.dtype)
    work = torch.full((lib.lora_indexed_work(m, k, n, r),), float("nan"))
    ctr = torch.zeros(lib.lora_indexed_counters(m, n), dtype=torch.int32)
    assert lib.lora_indexed(*map(_ptr, (x, w, a, b, s, ids, work, ctr, y)), m,
                            k, n, r, p, CODE[x.dtype], None) == 0
    assert not ctr.any(), "the counters must be left at zero"
    return y


def _lora_inputs(seed, dtype, m, k, n, r, p=3):
    gen = torch.Generator().manual_seed(seed)
    ranks = torch.tensor([r, max(1, r // 4), max(1, r - 3)])[:p]
    mask = (torch.arange(r)[None, :] < ranks[:, None]).float()

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    ids = torch.randint(0, p, (m,), generator=gen, dtype=torch.int32)
    ids[0], ids[-1] = -1, p + 2                 # clamped into the pool
    return (rnd(m, k).to(dtype), rnd(k, n, scale=0.1).to(dtype),
            (rnd(p, k, r, scale=0.1) * mask[:, None, :]).to(dtype),
            (rnd(p, r, n, scale=0.1) * mask[:, :, None]).to(dtype),
            torch.tensor([0.5, 2.0, 1.0])[:p], ids)


# (M, K, N, r): the card test's shape; several row tiles with K = 61 and N
# = 83 (rows not 16-byte aligned, ragged K slice and column tile) at r = 64;
# one full row tile at r = 1 over two K slices
LORA_CASES = [(5, 96, 80, 12), (37, 61, 83, 64), (16, 128, 64, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", LORA_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_emulated_lora_indexed_matches_plain(lib, dtype, case):
    m, k, n, r = case
    args = _lora_inputs(m + k + n + r, dtype, m, k, n, r)
    _close(_lora(lib, *args), lref.lora_matmul_indexed(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_lora_indexed_rows_do_not_depend_on_m(lib, dtype):
    """A row's bits are the same in launches of 1, 8 and 40 rows (the
    serial reference's one-row calls against the engine's batches)."""
    x, w, a, b, s, ids = _lora_inputs(7, dtype, 40, 128, 128, 16)
    full = _lora(lib, x, w, a, b, s, ids)
    for m in (1, 8):
        part = _lora(lib, x[:m].contiguous(), w, a, b, s, ids[:m].contiguous())
        assert torch.equal(part, full[:m])
    one = _lora(lib, x[29:30].contiguous(), w, a, b, s,
                ids[29:30].contiguous())
    assert torch.equal(one[0], full[29])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_lora_indexed_is_deterministic(lib, dtype):
    args = _lora_inputs(9, dtype, 20, 96, 80, 16)
    assert torch.equal(_lora(lib, *args), _lora(lib, *args))


# ---- flash-decode, contiguous and paged ------------------------------------

def _decode(lib, q, k, v, clen, window):
    b, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    out = torch.full_like(q, float("nan"))
    work = torch.full((lib.decode_attention_work(b, s, h, hd),), float("nan"))
    ctr = torch.zeros(b * kvh, dtype=torch.int32)
    assert lib.decode_attention(*map(_ptr, (q, k, v, clen, work, ctr, out)),
                                b, s, h, kvh, hd, window, hd ** -0.5,
                                CODE[q.dtype], None) == 0
    assert not ctr.any(), "the counters must be left at zero"
    return out


def _decode_paged(lib, q, kp, vp, pt, clen, window):
    b, h, hd = q.shape
    n_pages, ps, kvh = kp.shape[:3]
    p_max = pt.shape[1]
    out = torch.full_like(q, float("nan"))
    work = torch.full((lib.decode_attention_work(b, p_max * ps, h, hd),),
                      float("nan"))
    ctr = torch.zeros(b * kvh, dtype=torch.int32)
    assert lib.decode_attention_paged(
        *map(_ptr, (q, kp, vp, pt, clen, work, ctr, out)), b, n_pages, ps,
        p_max, h, kvh, hd, window, hd ** -0.5, CODE[q.dtype], None) == 0
    assert not ctr.any(), "the counters must be left at zero"
    return out


def _decode_inputs(seed, dtype, lens, s, h, kvh, hd, ps=16):
    """q, the contiguous cache, and the same cache in a page pool behind a
    shuffled table whose entries past each valid prefix are garbage."""
    gen = torch.Generator().manual_seed(seed)
    b = len(lens)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype) for shape in
               ((b, h, hd), (b, s, kvh, hd), (b, s, kvh, hd)))
    p_max = s // ps
    pt = (torch.randperm(b * p_max, generator=gen) + 1).reshape(b, p_max)
    kp = torch.zeros((1 + b * p_max, ps, kvh, hd), dtype=dtype)
    vp = torch.zeros_like(kp)
    kp[pt] = k.reshape(b, p_max, ps, kvh, hd)
    vp[pt] = v.reshape(b, p_max, ps, kvh, hd)
    pt = pt.to(torch.int32)
    clen = torch.tensor(lens, dtype=torch.int32)
    for i, n in enumerate(lens):
        used = -(-n // ps)
        if used < p_max:
            pt[i, used:] = torch.tensor([-7, 9999, 0, 3], dtype=torch.int32
                                        ).repeat(p_max)[:p_max - used]
    return q, k, v, kp, vp, pt, clen


def _edge_lens(lib):
    """Cache lengths at the chunk edges (0, 1, CH - 1, CH, CH + 1, S), CH
    the kernel's positions per chunk."""
    ch = lib.decode_attention_chunk()
    return [0, 1, ch - 1, ch, ch + 1, 160]


# (hd, H, KVH): GQA groups of 1, 4 (hd 16), 3 (hd 112: rows of 28 fp32
# lanes), 8 (hd 112: kimi-k2's 64 / 8 heads; hd 128) and 4 (hd 128:
# llama3-8b's 32 / 8 heads)
DECODE_SHAPES = [(64, 2, 2), (16, 8, 2), (112, 3, 1), (112, 8, 1),
                 (128, 8, 1), (128, 8, 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 70])
@pytest.mark.parametrize("shape", DECODE_SHAPES,
                         ids=lambda c: "-".join(map(str, c)))
def test_emulated_decode_matches_plain(lib, dtype, window, shape):
    """Contiguous and paged against the plain version at every chunk edge;
    paged bit-equal to contiguous; cache_len 0 gives exact zeros."""
    hd, h, kvh = shape
    q, k, v, kp, vp, pt, clen = _decode_inputs(hd + h, dtype,
                                               _edge_lens(lib), 160, h, kvh,
                                               hd)
    got = _decode(lib, q, k, v, clen, window)
    _close(got, dref.decode_attention(q, k, v, clen, window=window), dtype)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    paged = _decode_paged(lib, q, kp, vp, pt, clen, window)
    _close(paged, dref.decode_attention_paged(q, kp, vp, pt, clen,
                                              window=window), dtype)
    assert torch.equal(paged, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_decode_rows_do_not_depend_on_b(lib, dtype):
    """A sequence's output is the same bits alone (B = 1) and in a batch,
    and two calls give the same bits."""
    q, k, v, _, _, _, clen = _decode_inputs(3, dtype, [150, 70, 129, 5], 160,
                                            4, 2, 64)
    full = _decode(lib, q, k, v, clen, 0)
    assert torch.equal(full, _decode(lib, q, k, v, clen, 0))
    for i in (0, 2):
        one = _decode(lib, q[i:i + 1].contiguous(), k[i:i + 1].contiguous(),
                      v[i:i + 1].contiguous(), clen[i:i + 1].contiguous(), 0)
        assert torch.equal(one[0], full[i])


def test_emulated_serving_grids_fill_the_card(lib):
    """At the decode tick's shape (8 slots, K = N = 768; 12 kv heads, cache
    lengths 128..156) each kernel runs at least one CTA per H100 SM (132)."""
    assert lib.lora_indexed_ctas(8, 768, 768) >= 132
    ch = lib.decode_attention_chunk()
    assert 12 * sum((n - 1) // ch + 1 for n in range(128, 160, 4)) >= 132
