"""The flash kernels' tensor-core arithmetic, modelled in numpy on the CPU.

The fp32 flash kernels (src/repro_torch/csrc/flash_fwd.cu, flash_bwd.cu)
run their products on the tensor cores as 3xTF32: every operand x is split
into big = x truncated to TF32 and small = tf32(x - big), and a product
a*b is summed as small_a*big_b + big_a*small_b + big_a*big_b in fp32
(csrc/flash_mma.cuh).  The kernels cannot run here, so these tests hold
the design on the CPU:

  * an attention forward whose products are 3xTF32 stays within a tenth
    of the card tolerance (chip_smoke.py TOL["float32"]) of an fp64
    oracle at hd 64 and S 512, and one-pass TF32 is at least 10x worse:
    the unchanged fp32 tolerance needs the three passes;
  * the fragment index mapping of csrc/flash_mma.cuh (PTX's mma.sync
    layouts, the permuted k order that turns an accumulator tile into an
    A operand, the padded shared-memory rows) composes to the right
    products and is free of bank conflicts.

TF32 rounding is cvt.rna: round to nearest, ties away from zero, 10
mantissa bits, i.e. (u + 0x1000) & 0xFFFFE000 on the fp32 bit pattern;
truncation is u & 0xFFFFE000.  One-pass TF32 is modelled with rounding,
its more accurate form.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"


def _card_tol() -> float:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.TOL["float32"]


def _bits(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)


def tf32(x):
    """cvt.rna.tf32.f32 on an fp32 array (finite values)."""
    return ((_bits(x) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
            ).view(np.float32)


def tf32_trunc(x):
    return (_bits(x) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """The kernels' split: (big, small) with x ~= big + small."""
    big = tf32_trunc(x)
    return big, tf32(x - big)


def mm_3xtf32(a, b):
    """a @ b with 3xTF32 products and fp32 sums, in the kernels' order."""
    (a_big, a_small), (b_big, b_small) = split(a), split(b)
    acc = a_small @ b_big
    acc += a_big @ b_small
    acc += a_big @ b_big
    return acc


def mm_1xtf32(a, b):
    return tf32(a.astype(np.float32)) @ tf32(b.astype(np.float32))


def attention(q, k, v, mm):
    """Causal attention per head, products through `mm`, softmax in fp32
    (scale folded in after the product, as the kernels do)."""
    s_len, hd = q.shape[-2:]
    scale = np.float32(hd ** -0.5)
    mask = np.tril(np.ones((s_len, s_len), bool))
    outs = []
    for qh, kh, vh in zip(q, k, v):
        s = mm(qh, kh.T)
        s = np.where(mask, s, -np.inf).astype(np.float32)
        m = s.max(-1, keepdims=True)
        p = np.exp((s - m) * scale).astype(np.float32)
        outs.append(mm(p, vh) / p.sum(-1, keepdims=True))
    return np.stack(outs)


def attention_fp64(q, k, v):
    s_len, hd = q.shape[-2:]
    s = np.einsum("hqd,hkd->hqk", q, k) * hd ** -0.5
    s = np.where(np.tril(np.ones((s_len, s_len), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("hqk,hkd->hqd", p / p.sum(-1, keepdims=True), v)


@pytest.fixture(scope="module")
def errors():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 512, 64)).astype(np.float32)
               for _ in range(3))
    oracle = attention_fp64(*(t.astype(np.float64) for t in (q, k, v)))
    return {name: float(np.abs(attention(q, k, v, mm) - oracle).max())
            for name, mm in (("3xtf32", mm_3xtf32), ("1xtf32", mm_1xtf32))}


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)               # TF32's unit at 1.0
    half = np.float32(2.0 ** -11)
    x = np.array([one + half, -(one + half), one + half * 0.99,
                  one + ulp + half, 3.0], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0],
                    np.float32)
    np.testing.assert_array_equal(tf32(x), want)
    np.testing.assert_array_equal(tf32_trunc(x[:3]),
                                  np.array([one, -one, one], np.float32))


def test_split_keeps_fp32_class_accuracy():
    """|x - big| < 2^-10 |x| and small rounds it to 11 bits: big + small
    misses x by < 2^-21 |x|, and a 3xTF32 product misses x*y by < 2^-19."""
    rng = np.random.default_rng(1)
    x, y = (rng.standard_normal(100000).astype(np.float32) for _ in range(2))
    (bx, sx), (by, sy) = split(x), split(y)
    assert (np.abs(x - bx) < 2.0 ** -10 * np.abs(x)).all()
    assert (np.abs(bx.astype(np.float64) + sx - x) < 2.0 ** -21 * np.abs(x)
            ).all()
    prod = (sx.astype(np.float64) * by + bx.astype(np.float64) * sy
            + bx.astype(np.float64) * by)
    exact = x.astype(np.float64) * y
    assert (np.abs(prod - exact) < 2.0 ** -19 * np.abs(exact)).all()


def test_3xtf32_attention_is_within_a_tenth_of_the_fp32_tolerance(errors):
    assert errors["3xtf32"] <= _card_tol() / 10, errors


def test_one_pass_tf32_is_at_least_10x_worse(errors):
    assert errors["1xtf32"] >= 10 * errors["3xtf32"], errors
    assert errors["1xtf32"] > _card_tol() / 10, errors


# ---- fragment layouts (PTX ISA, mma.sync .row.col; lane = 4 g + t) ----

LANES = [(lane // 4, lane % 4) for lane in range(32)]


def ptx_a(frags, k):
    """A (16 x k) from per-lane registers: tf32 k8 a0..a3 at (g, t),
    (g+8, t), (g, t+4), (g+8, t+4); bf16 k16 register pairs at columns
    (2t, 2t+1) and (2t+8, 2t+9)."""
    a = np.full((16, k), np.nan)
    for (g, t), r in zip(LANES, frags):
        if k == 8:
            a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = r
        else:
            for h in range(2):
                a[g, 2 * t + h], a[g + 8, 2 * t + h] = r[0][h], r[1][h]
                a[g, 2 * t + 8 + h], a[g + 8, 2 * t + 8 + h] = r[2][h], r[3][h]
    return a


def ptx_b(frags, k):
    """B (k x 8): tf32 b0, b1 at (t, g), (t+4, g); bf16 pairs at rows
    (2t, 2t+1) and (2t+8, 2t+9) of column g."""
    b = np.full((k, 8), np.nan)
    for (g, t), r in zip(LANES, frags):
        if k == 8:
            b[t, g], b[t + 4, g] = r
        else:
            for h in range(2):
                b[2 * t + h, g], b[2 * t + 8 + h, g] = r[0][h], r[1][h]
    return b


def accumulators(c):
    """Per-lane registers of a 16 x 8 accumulator tile c."""
    return [(c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t],
             c[g + 8, 2 * t + 1]) for g, t in LANES]


# the kernels' loaders (flash_mma.cuh Mma<float> / Mma<__nv_bfloat16>)
def load_a(x, k):
    if k == 8:
        return [(x[g, t], x[g + 8, t], x[g, t + 4], x[g + 8, t + 4])
                for g, t in LANES]
    return [((x[g, 2 * t], x[g, 2 * t + 1]),
             (x[g + 8, 2 * t], x[g + 8, 2 * t + 1]),
             (x[g, 2 * t + 8], x[g, 2 * t + 9]),
             (x[g + 8, 2 * t + 8], x[g + 8, 2 * t + 9])) for g, t in LANES]


def load_b_nk(x, k):
    """B[kk][n] = x[n][kk]"""
    if k == 8:
        return [(x[g, t], x[g, t + 4]) for g, t in LANES]
    return [((x[g, 2 * t], x[g, 2 * t + 1]), (x[g, 2 * t + 8], x[g, 2 * t + 9]))
            for g, t in LANES]


def load_b_kn(x, k):
    """B[kk][n] = x[kk][n]; for tf32 rows in the permuted k order"""
    if k == 8:
        return [(x[2 * t, g], x[2 * t + 1, g]) for g, t in LANES]
    return [((x[2 * t, g], x[2 * t + 1, g]), (x[2 * t + 8, g], x[2 * t + 9, g]))
            for g, t in LANES]


def a_from_c(tiles, k):
    """The A operand of one k step from accumulator tiles (one for tf32,
    two for bf16), as flash_mma.cuh builds it."""
    if k == 8:
        return [(c[0], c[2], c[1], c[3]) for c in accumulators(tiles[0])]
    return [((c0[0], c0[1]), (c0[2], c0[3]), (c1[0], c1[1]), (c1[2], c1[3]))
            for c0, c1 in zip(accumulators(tiles[0]), accumulators(tiles[1]))]


@pytest.mark.parametrize("k", [8, 16])
def test_fragments_compose_s_and_p_v(k):
    """S = Q K^T from load_a / load_b_nk, then O = P V from the S
    accumulators through a_from_c and load_b_kn, equal the matrix
    products: the tf32 k permutation of a_from_c and load_b_kn cancels."""
    rng = np.random.default_rng(k)
    q, kk = rng.standard_normal((16, k)), rng.standard_normal((k, k))
    s = ptx_a(load_a(q, k), k) @ ptx_b(load_b_nk(kk, k), k)[:, :8]
    np.testing.assert_allclose(s, q @ kk[:8].T, rtol=1e-12)
    p = rng.standard_normal((16, k))       # k keys: one or two 8-key tiles
    v = rng.standard_normal((k, 8))
    a = ptx_a(a_from_c([p[:, 8 * i:8 * i + 8] for i in range(k // 8)], k), k)
    np.testing.assert_allclose(a @ ptx_b(load_b_kn(v, k), k), p @ v,
                               rtol=1e-12)


def _pad(ctype):
    src = (CSRC / "flash_mma.cuh").read_text()
    return int(re.search(rf"Pad<{ctype}> {{ static constexpr int value = "
                         rf"(\d+);", src).group(1))


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("ctype,size", [("float", 4), ("__nv_bfloat16", 2)])
def test_padded_rows_make_fragment_loads_conflict_free(hd, ctype, size):
    """Each warp-wide shared-memory load of a fragment (one register per
    lane) touches every bank at most once per 32-bit word, and rows stay
    16-byte aligned for cp.async."""
    ld = hd + _pad(ctype)
    assert ld * size % 16 == 0
    k = 8 if size == 4 else 16
    mat = np.arange(64 * ld).reshape(64, ld)   # element index of each slot
    loads = [load_a(mat, k), load_b_nk(mat, k), load_b_kn(mat, k)]
    for frags in loads:
        for reg in range(len(frags[0])):
            parts = [np.atleast_1d(f[reg]) for f in frags]
            for half in range(len(parts[0])):
                words = {int(p[half]) * size // 4 for p in parts}
                banks = [w % 32 for w in words]
                assert len(banks) == len(set(banks)), (ctype, hd, reg)
