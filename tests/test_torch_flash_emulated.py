"""The flash kernels' CUDA source, run on the CPU by a warp emulator.

The kernels (src/repro_torch/csrc/flash_fwd.cu, flash_bwd.cu and their
headers) are compiled with g++ against the headers in tests/cuda_emu/
(tests/cuda_emu/build.py): every CUDA thread is a fiber,
__syncthreads a barrier, and the warp-level instructions (shuffles,
mma.sync with PTX's fragment layouts, 16-byte cp.async with zero fill)
are emulated per warp.  Each inline-asm statement of the sources is
rewritten into the emulator call of the same instruction; an asm the
rewriter does not know fails the test.  The emulated MMA multiplies
exactly and sums in double, so its numbers are close to, not equal to,
the card's; the tolerances are the card tests' (tests/test_torch_cuda.py
TOL).  What the emulation holds on
the CPU is the kernels' own logic: tiles, fragments, masks, the online
softmax, ragged edges, the choice of warps per CTA, bit-equal rows for a
padded prompt and a deterministic backward.  On the card,
tests/test_torch_cuda.py holds the compiled kernels themselves.
"""

import ctypes
import importlib.util
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ref  # noqa: E402

EMU = Path(__file__).resolve().parent / "cuda_emu"
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CODE = {torch.float32: 0, torch.bfloat16: 1}


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
    so = _emu_build().build(tmp_path_factory.mktemp("flash_emu"),
                            ["flash_fwd", "flash_bwd"], name="flash_emu")
    lib = ctypes.CDLL(str(so))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_fwd.argtypes = [P] * 5 + [I] * 9 + [F, I, P]
    lib.flash_bwd.argtypes = [P] * 9 + [I] * 9 + [F, I, P]
    return lib


def _fwd(lib, q, k, v, causal=True, window=0, q_offset=0):
    b, sq, h, hd = q.shape
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b * h, sq, 1), float("nan"))
    assert lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), lse.data_ptr(), b, sq, k.shape[1], h,
                         k.shape[2], hd, q_offset, int(causal), window,
                         hd ** -0.5, CODE[q.dtype], None) == 0
    return out, lse


def _bwd(lib, q, k, v, out, lse, do, causal=True, window=0, q_offset=0):
    b, sq, h, hd = q.shape
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    grads = [torch.full_like(t, float("nan")) for t in (q, k, v)]
    assert lib.flash_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                         *[g.data_ptr() for g in grads], b, sq, k.shape[1], h,
                         k.shape[2], hd, q_offset, int(causal), window,
                         hd ** -0.5, CODE[q.dtype], None) == 0
    return grads


def _inputs(seed, dtype, b, sq, sk, h, kvh, hd):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dtype) for shape in
            ((b, sq, h, hd), (b, sk, kvh, hd), (b, sk, kvh, hd),
             (b, sq, h, hd))]


def _close(got, want, dtype):
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


# (Sq, Sk, H, KVH, hd, causal, window, q_offset): the 16-row, 8-key,
# 32-key and 64-key tile edges, GQA, windows, offsets, non-causal, and rows
# that see no key (200 x 1, window 9, offset 4)
CASES = [(1, 1, 2, 1, 16, True, 0, 0), (17, 65, 4, 2, 32, True, 9, 4),
         (65, 17, 4, 2, 64, True, 0, 0), (64, 64, 3, 1, 64, False, 0, 0),
         (200, 1, 4, 2, 64, True, 9, 4), (130, 130, 2, 2, 64, True, 0, 0),
         (63, 200, 2, 1, 16, False, 9, 0)]


# head dim 128 (the llama, phi4, qwen, mistral, llama4 and internvl2
# layers): GQA 4:1 with a window and an offset over ragged lengths, a
# ragged non-causal block, GQA 2:1 causal past one 64-key tile, and GQA
# 8:1 past it (16 query tiles for a key tile: the fp32 dk/dv flush)
CASES_128 = [(33, 80, 4, 1, 128, True, 17, 3),
             (65, 17, 2, 2, 128, False, 0, 0),
             (70, 70, 4, 2, 128, True, 0, 0),
             (70, 70, 8, 1, 128, True, 0, 0)]

# head dim 112 (kimi-k2: 7168 over 64 heads; 14 TF32 and 7 bf16 k steps,
# rows of 116 and 120 elements): GQA 8:1 with a window and an offset over
# ragged lengths, a ragged non-causal block, GQA 8:1 causal past one
# 64-key tile
CASES_112 = [(33, 80, 8, 1, 112, True, 17, 3),
             (65, 17, 2, 2, 112, False, 0, 0),
             (70, 70, 8, 1, 112, True, 0, 0)]


# whisper's cross-attention shapes at hd 64, non-causal with Sq != Sk:
# 40 decoder queries over 200 encoder keys (3 full 64-key tiles and a
# ragged tail), and 530 queries over 24 keys (past 8 query tiles: the
# fp32 dk/dv flush, then a ragged 18-row tile)
CASES_CROSS = [(40, 200, 2, 2, 64, False, 0, 0),
               (530, 24, 1, 1, 64, False, 0, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES + CASES_128 + CASES_112 + CASES_CROSS,
                         ids=lambda c: "-".join(map(str, c)))
def test_emulated_kernels_match_plain(lib, dtype, case):
    sq, sk, h, kvh, hd, causal, window, q_offset = case
    q, k, v, do = _inputs(sq * 7 + sk, dtype, 1, sq, sk, h, kvh, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = _fwd(lib, q, k, v, **kw)
    want, want_lse = ref.attention_fwd(q, k, v, **kw)
    _close(out, want, dtype)
    _close(lse, want_lse, dtype)
    got = _bwd(lib, q, k, v, want, want_lse, do, **kw)
    for g, w in zip(got, ref.attention_bwd(q, k, v, want, want_lse, do, **kw)):
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,bucket,window", [(37, 128, 0), (100, 130, 9)])
def test_emulated_padded_prompt_rows_are_bit_equal(lib, dtype, n, bucket,
                                                   window):
    """A prompt's rows agree bit for bit with the same rows of the prompt
    padded to a bucket with large garbage (a longer grid, more tiles)."""
    q, k, v, _ = _inputs(n, dtype, 1, bucket, bucket, 4, 4, 64)
    k[:, n:] *= 100.0
    v[:, n:] *= 100.0
    out, lse = _fwd(lib, q[:, :n].contiguous(), k[:, :n].contiguous(),
                    v[:, :n].contiguous(), window=window)
    pout, plse = _fwd(lib, q, k, v, window=window)
    assert torch.equal(out, pout[:, :n])
    assert torch.equal(lse.reshape(4, n), plse.reshape(4, bucket)[:, :n])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_backward_is_deterministic(lib, dtype):
    q, k, v, do = _inputs(3, dtype, 1, 100, 100, 4, 2, 32)
    out, lse = ref.attention_fwd(q, k, v)
    first = _bwd(lib, q, k, v, out, lse, do)
    for a, b in zip(first, _bwd(lib, q, k, v, out, lse, do)):
        assert torch.equal(a, b)
