"""The fused LoRA and SSD scan CUDA sources, run on the CPU by the warp
emulator.

src/repro_torch/csrc/lora_fused.cu and ssd_scan.cu (and their headers)
are compiled with g++ against tests/cuda_emu/ (tests/cuda_emu/build.py):
every CUDA thread is a fiber, and mma.sync, 16-byte cp.async with zero
fill and the shared-memory tiles run as on the card, one block after
another.  The fused LoRA library is built twice: with the wide pass's own
tile choice (64-row CTAs at these sizes) and with 128-row CTAs fixed
(-DREPRO_LORA_TILE_BM=128), the tile of the paths' shapes.  The emulated
MMA multiplies exactly and sums in double, so the numbers are close to,
not equal to, the card's; the tolerances are the card tests'
(tests/test_torch_cuda.py TOL, the SSD's scaled by max|y|).  What this
holds on the CPU is the kernels' logic: the cp.async ring, ragged and
unaligned edges, the rank-r k steps, the transposed dx operands, C.B^T
once per group, the chunk scan's causal blocks, the exponent formed only
where i <= t (chunk decays past 88) and bit-equal repeated calls.
"""

import ctypes
import importlib.util
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.lora_matmul import ref as lora_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as ssd_ref  # noqa: E402

EMU = Path(__file__).resolve().parent / "cuda_emu"
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CODE = {torch.float32: 0, torch.bfloat16: 1}
P_, I_ = ctypes.c_void_p, ctypes.c_int


def _emu_build():
    spec = importlib.util.spec_from_file_location("emu_build",
                                                  EMU / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{64: the library with the wide pass's own tile choice and the SSD
    scan, 128: fused LoRA with 128-row CTAs fixed}."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    build = _emu_build().build
    jobs = {64: (["lora_fused", "ssd_scan"], {}),
            128: (["lora_fused"],
                  {"lora_fused": ["-DREPRO_LORA_TILE_BM=128"]})}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {bm: pool.submit(build, tmp_path_factory.mktemp(f"emu{bm}"),
                                stems, defines, f"emu{bm}")
                for bm, (stems, defines) in jobs.items()}
        out = {}
        for bm, fut in futs.items():
            lib = ctypes.CDLL(str(fut.result()))
            lib.lora_fused_fwd.argtypes = [P_] * 7 + [I_] * 5 + [P_]
            lib.lora_fused_bwd.argtypes = [P_] * 13 + [I_] * 5 + [P_]
            lib.lora_fused_dab_work.argtypes = [I_] * 4
            lib.lora_fused_dab_work.restype = ctypes.c_longlong
            lib.lora_fused_dab_counters.argtypes = [I_, I_]
            lib.lora_fused_dab_ctas.argtypes = [I_] * 3
            lib.lora_fused_tile.argtypes = [I_, I_]
            if bm == 64:
                lib.ssd_scan_fwd.argtypes = [P_] * 8 + [I_] * 8 + [P_]
            out[bm] = lib
    return out


def _ptr(t):
    return t.data_ptr()


def _lora_fwd(lib, x, w, a, b, s):
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    y = torch.full((m, n), float("nan"), dtype=x.dtype)
    xa = torch.full((m, r), float("nan"))
    assert lib.lora_fused_fwd(*map(_ptr, (x, w, a, b, s, xa, y)), m, k, n, r,
                              CODE[x.dtype], None) == 0
    return y, xa


def _lora_bwd(lib, x, w, a, b, s, g, xa):
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    gb = torch.full((m, r), float("nan"))
    work = torch.full((lib.lora_fused_dab_work(m, k, n, r),), float("nan"))
    ctr = torch.zeros(lib.lora_fused_dab_counters(k, n), dtype=torch.int32)
    dx, da, db = (torch.full_like(t, float("nan")) for t in (x, a, b))
    assert lib.lora_fused_bwd(*map(_ptr, (x, w, a, b, s, g, xa, gb, work, ctr,
                                          dx, da, db)), m, k, n, r,
                              CODE[x.dtype], None) == 0
    assert not ctr.any(), "the counters must be left at zero"
    return dx, da, db, (xa * gb).sum()


def _lora_inputs(seed, dtype, m, k, n, r):
    gen = torch.Generator().manual_seed(seed)
    mask = (torch.arange(r) < max(1, r - 2)).float()   # masked rank slots

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    return (rnd(m, k).to(dtype), rnd(k, n, scale=0.1).to(dtype),
            (rnd(k, r, scale=0.1) * mask).to(dtype),
            (rnd(r, n, scale=0.1) * mask[:, None]).to(dtype),
            torch.tensor(2.0), rnd(m, n).to(dtype))


def _close(got, want, dtype, scaled=False):
    tol = TOL[dtype]
    atol = tol * (max(1.0, float(want.float().abs().max())) if scaled else 1)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=atol)


# (M, K, N, r): ragged M, K and N against the 64/128-row and 128-column
# tiles and the 32/64-deep k tiles; K = 61 and 33 leave x's rows (and the
# backward's W^T and A^T rows at r = 5) not 16-byte aligned; r = 1, 5, 16
# and 64 (two rank k tiles in fp32).  At these widths the dA/dB pass cuts
# M into 32-row slices: M = 300 and 270 span 10 and 9 slices with a ragged
# last one, at r = 1 (gb and xa rows not 16-byte aligned) and r = 64.
LORA_CASES = [(37, 96, 80, 5), (130, 96, 136, 64), (1, 61, 80, 1),
              (100, 33, 136, 16), (300, 40, 72, 1), (270, 72, 40, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("case", LORA_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_emulated_lora_fused_matches_plain(libs, dtype, bm, case):
    """y and xa of the forward, dx, dA, dB and dscale of the backward (dx
    through the same GEMM kernel, W^T and A^T read n-major)."""
    m, k, n, r = case
    lib = libs[bm]
    assert lib.lora_fused_tile(m, n) == bm
    x, w, a, b, s, g = _lora_inputs(m + k + n + r, dtype, m, k, n, r)
    y, xa = _lora_fwd(lib, x, w, a, b, s)
    want_y, want_xa = lora_ref.lora_matmul_fwd(x, w, a, b, s)
    _close(y, want_y, dtype)
    _close(xa, want_xa, dtype)
    got = _lora_bwd(lib, x, w, a, b, s, g, want_xa)
    for i, (gt, wt) in enumerate(zip(got, lora_ref.lora_matmul_bwd(
            x, w, a, b, s, g, want_xa))):
        _close(gt, wt, dtype, scaled=i > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_lora_fused_is_deterministic(libs, dtype):
    x, w, a, b, s, g = _lora_inputs(3, dtype, 130, 96, 136, 16)
    first = _lora_fwd(libs[128], x, w, a, b, s)
    for u, v in zip(first, _lora_fwd(libs[128], x, w, a, b, s)):
        assert torch.equal(u, v)
    grads = _lora_bwd(libs[64], x, w, a, b, s, g, first[1])
    for u, v in zip(grads, _lora_bwd(libs[64], x, w, a, b, s, g, first[1])):
        assert torch.equal(u, v)


def test_emulated_lora_dab_grid_fills_the_card(libs):
    """At the gpt2 eval shape (M = 10240, K = N = 768) the dA/dB pass runs
    at least one CTA per H100 SM (132) and at most four; at M = 1 and 37 it
    runs one slice per column tile."""
    assert 132 <= libs[64].lora_fused_dab_ctas(10240, 768, 768) <= 4 * 132
    assert libs[64].lora_fused_dab_ctas(1, 768, 768) == 24
    assert libs[64].lora_fused_dab_ctas(37, 768, 768) == 48


def _ssd_inputs(seed, dtype, b, s, h, p, g, n, dt_scale):
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    x = rnd(b, s, h, p).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, s, h) + 0.5) * dt_scale
    a = -torch.exp(rnd(h, scale=0.5))
    return (x, dt, a, rnd(b, s, g, n, scale=0.3).to(dtype),
            rnd(b, s, g, n, scale=0.3).to(dtype))


def _ssd(lib, x, dt, a, bm, c, chunk):
    b, s, h, p = x.shape
    g, n = bm.shape[2:]
    nc = s // chunk
    y = torch.full_like(x, float("nan"))
    cum = torch.full((b * h, s), float("nan"))
    work = torch.full((b * h * nc * p * n + b * g * nc * chunk * chunk,),
                      float("nan"))
    assert lib.ssd_scan_fwd(*map(_ptr, (x, dt, a, bm, c, y, cum, work)), b,
                            s, h, g, p, n, chunk, CODE[x.dtype], None) == 0
    return y


def _decay(dt, a, chunk):
    b, s, h = dt.shape
    return float(-(dt * a).reshape(b, s // chunk, chunk, h).sum(2).min())


# (G, chunk, dt scale): G = 1 and 2 (H / G = 4 and 2), one and four
# chunks; dt x 3 at chunk 64 takes a chunk's decay past 88
SSD_CASES = [(1, 16, 1.0), (2, 16, 1.0), (1, 64, 1.0), (2, 64, 3.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_emulated_ssd_scan_matches_plain(libs, dtype, case):
    """B = 1, S = 64, H = 4, P = 16, N = 32 against ref.ssd_chunked."""
    g, chunk, dt_scale = case
    ins = _ssd_inputs(g * 100 + chunk, dtype, 1, 64, 4, 16, g, 32, dt_scale)
    if dt_scale > 1:
        assert _decay(ins[1], ins[2], chunk) > 88
    y = _ssd(libs[64], *ins, chunk)
    assert torch.isfinite(y.float()).all()
    _close(y, ssd_ref.ssd_chunked(*ins, chunk=chunk), dtype, scaled=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_ssd_scan_is_deterministic(libs, dtype):
    ins = _ssd_inputs(5, dtype, 1, 64, 4, 16, 2, 32, 1.0)
    assert torch.equal(_ssd(libs[64], *ins, 16), _ssd(libs[64], *ins, 16))
