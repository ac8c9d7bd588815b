"""The int8 smashed quantizer's CUDA source, run on the CPU by the warp
emulator.

src/repro_torch/csrc/smashed_quant.cu is compiled with g++ against
tests/cuda_emu/ (tests/cuda_emu/build.py).  Quantize and the round trip
are thread block clusters: the emulator runs the CTAs of one cluster at
once as fibers of one scheduler, the cluster barrier is a barrier between
them and mapa reads another CTA's own shared memory, so the split of M
over the cluster and the combine of its column amax run as on the card.
The kernels must agree with the plain version (kernels/smashed_quant/
ref.py) bit for bit: max is exact, x / scale is a true division and the
rounding is half to even, so nothing is left to a tolerance.  The cases
take M off the cluster's split and at 1, d off the 64-channel tile and
off the 4 (fp32) or 8 (bf16) channels of a 16-byte load (the element
paths), all-zero columns, exact halfway ties of x / scale and -0.
"""

import ctypes
import importlib.util
import shutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.smashed_quant import ref  # noqa: E402

EMU = Path(__file__).resolve().parent / "cuda_emu"
CODE = {torch.float32: 0, torch.bfloat16: 1}
BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
P_, I_ = ctypes.c_void_p, ctypes.c_int


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
    so = _emu_build().build(tmp_path_factory.mktemp("int8_emu"),
                            ["smashed_quant"], name="int8_emu")
    lib = ctypes.CDLL(str(so))
    lib.smashed_roundtrip.argtypes = [P_, P_] + [I_] * 4 + [P_]
    lib.smashed_quantize.argtypes = [P_] * 3 + [I_] * 4 + [P_]
    lib.smashed_dequantize.argtypes = [P_] * 3 + [I_] * 4 + [P_]
    lib.smashed_quant_cluster.argtypes = []
    lib.smashed_quant_ctas.argtypes = [I_, I_]
    lib.smashed_dequant_ctas.argtypes = [I_] * 3
    return lib


def _same_bits(got, want):
    """Equal bit patterns (so +0 and -0 differ), dtypes and shapes."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.is_floating_point():
        got, want = got.view(BITS[got.dtype]), want.view(BITS[want.dtype])
    assert torch.equal(got, want)


def _inputs(seed, dtype, g, m, d):
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


def _quantize(lib, x):
    g, m, d = x.shape
    q = torch.full((g, m, d), 99, dtype=torch.int8)
    scale = torch.full((g, d), float("nan"))
    assert lib.smashed_quantize(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                                g, m, d, CODE[x.dtype], None) == 0
    return q, scale


def _dequantize(lib, q, scale, dtype):
    g, m, d = q.shape
    x = torch.full((g, m, d), float("nan"), dtype=dtype)
    assert lib.smashed_dequantize(q.data_ptr(), scale.data_ptr(), x.data_ptr(),
                                  g, m, d, CODE[dtype], None) == 0
    return x


def _roundtrip(lib, x):
    g, m, d = x.shape
    y = torch.full_like(x, float("nan"))
    assert lib.smashed_roundtrip(x.data_ptr(), y.data_ptr(), g, m, d,
                                 CODE[x.dtype], None) == 0
    return y


# (G, M, d): M off the cluster's 8-way split (37: 5 rows a CTA, the last
# 2; 45), M = 1 (one CTA of the cluster has rows), M = 1100, 2100 and
# 4200 (rows a CTA up to and past the 256 that its threads keep in
# registers; past them the rest is streamed and read again); d = 136 (a
# ragged channel tile, 16-byte loads), 68 (16-byte loads in fp32, the
# element path in bf16), 70 (the element path in both), 64 and 16
# (dequantize's 16-channel loads and stores)
INT8_CASES = [(2, 37, 136), (1, 1, 70), (3, 20, 64), (2, 45, 68),
              (1, 1100, 64), (1, 2100, 16), (1, 4200, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", INT8_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_emulated_int8_matches_plain_bit_for_bit(lib, dtype, case):
    """Quantize (q, scale), dequantize and the round trip against the plain
    version, bit for bit; a second call of each gives the same bits."""
    g, m, d = case
    x = _inputs(g * 1000 + m + d, dtype, g, m, d)
    want_q, want_scale = ref.quantize(x)
    if m >= 5:
        # the ties are real: x / scale is k + 0.5 in fp32
        assert torch.equal(x[0, 1:5, 7].float() / want_scale[0, 7],
                           torch.tensor([0.5, 1.5, 2.5, -0.5]))
    q, scale = _quantize(lib, x)
    _same_bits(q, want_q)
    _same_bits(scale, want_scale)
    assert float(scale[0, 5]) == pytest.approx(1e-12 / 127, rel=1e-6)
    deq = _dequantize(lib, want_q, want_scale, dtype)
    _same_bits(deq, ref.dequantize(want_q, want_scale, dtype))
    y = _roundtrip(lib, x)
    _same_bits(y, ref.roundtrip(x))
    again = (_quantize(lib, x), _dequantize(lib, want_q, want_scale, dtype),
             _roundtrip(lib, x))
    _same_bits(again[0][0], q)
    _same_bits(again[0][1], scale)
    _same_bits(again[1], deq)
    _same_bits(again[2], y)


def test_emulated_int8_grids_fill_the_card(lib):
    """At the gpt2 training path's shape (G = 5 messages, M = 2048, d = 768)
    quantize and the round trip run clusters of 8 CTAs, 480 CTAs in all
    (3.6 per H100 SM), and dequantize about 4 CTAs per SM."""
    assert lib.smashed_quant_cluster() == 8
    assert lib.smashed_quant_ctas(5, 768) == 8 * 12 * 5
    assert 4 * 132 <= lib.smashed_dequant_ctas(5, 2048, 768) < 4 * 132 + 5
