"""The fragment index mappings that the fused LoRA GEMM and the SSD scan
add to csrc/mma_sync.cuh, modelled in numpy on the CPU.

PTX's mma.sync layouts and flash's loaders are the models of
tests/test_torch_flash_tf32.py.  New here:

  * load_a_pk / load_b_nk_pk: for TF32 the k pair (2t, 2t+1) of a row in
    one 8-byte load, in load_b_kn's permuted k order (for bf16 they are
    load_a / load_b_nk); with load_b_kn (the forward's W and B) or
    load_b_nk_pk (the backward's W^T and A^T, the SSD's B_i and state)
    they compose to the products;
  * the SSD chunk state's A operand (w o x)^T, read from a staged x tile
    (rows i, columns p) and weighted per row in registers (XtW);
  * rows padded by PadPk keep the 8-byte loads free of bank conflicts per
    half-warp, and the transposed x reads of XtW per warp.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location(
    "flash_tf32", HERE / "test_torch_flash_tf32.py")
ft = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ft)
LANES = ft.LANES


def load_a_pk(x, k):
    """mma_sync.cuh Mma<T>::load_a_pk on a 16 x k block"""
    if k == 8:
        return [(x[g, 2 * t], x[g + 8, 2 * t], x[g, 2 * t + 1],
                 x[g + 8, 2 * t + 1]) for g, t in LANES]
    return ft.load_a(x, k)


def load_b_nk_pk(x, k):
    """B[kk][n] = x[n][kk], k pairs (2t, 2t+1) for TF32"""
    if k == 8:
        return [(x[g, 2 * t], x[g, 2 * t + 1]) for g, t in LANES]
    return ft.load_b_nk(x, k)


def xtw(xs, w, k):
    """ssd_scan.cu XtW<T>::load: A[p][kk] = xs[kk][p] * w[kk]"""
    a = lambda p, kk: xs[kk, p] * w[kk]  # noqa: E731
    if k == 8:
        return [(a(g, 2 * t), a(g + 8, 2 * t), a(g, 2 * t + 1),
                 a(g + 8, 2 * t + 1)) for g, t in LANES]
    return [((a(g, 2 * t), a(g, 2 * t + 1)),
             (a(g + 8, 2 * t), a(g + 8, 2 * t + 1)),
             (a(g, 2 * t + 8), a(g, 2 * t + 9)),
             (a(g + 8, 2 * t + 8), a(g + 8, 2 * t + 9))) for g, t in LANES]


def _ptx_a_permuted(frags, k):
    """The A the MMA sees, with TF32's k slots read back in load_b_kn's
    order (slot t is k 2t, slot t + 4 is k 2t + 1)."""
    a = ft.ptx_a(frags, k)
    if k == 8:
        a = a[:, [0, 4, 1, 5, 2, 6, 3, 7]]
    return a


def _ptx_b_permuted(frags, k):
    b = ft.ptx_b(frags, k)
    if k == 8:
        b = b[[0, 4, 1, 5, 2, 6, 3, 7]]
    return b


@pytest.mark.parametrize("k", [8, 16])
def test_gemm_fragments_compose_both_layouts(k):
    """x @ W with W k-major (load_b_kn) and n-major (load_b_nk_pk), A from
    load_a_pk: one MMA step equals the product."""
    rng = np.random.default_rng(k)
    x, w = rng.standard_normal((16, k)), rng.standard_normal((k, 8))
    a = ft.ptx_a(load_a_pk(x, k), k)
    b_kn = ft.ptx_b(ft.load_b_kn(w, k), k)
    b_nk = ft.ptx_b(load_b_nk_pk(np.ascontiguousarray(w.T), k), k)
    np.testing.assert_allclose(a @ b_kn, x @ w, rtol=1e-12)
    np.testing.assert_allclose(a @ b_nk, x @ w, rtol=1e-12)
    # the k order the MMA sees is the same permutation on both sides
    np.testing.assert_allclose(_ptx_a_permuted(load_a_pk(x, k), k), x)
    np.testing.assert_allclose(_ptx_b_permuted(ft.load_b_kn(w, k), k), w)


@pytest.mark.parametrize("k", [8, 16])
def test_chunk_state_operand_composes(k):
    """upd = (w o x)^T @ B from XtW and load_b_kn."""
    rng = np.random.default_rng(10 + k)
    xs = rng.standard_normal((k, 16))        # rows i, columns p
    w = rng.standard_normal(k)
    bm = rng.standard_normal((k, 8))         # rows i, columns n
    a = ft.ptx_a(xtw(xs, w, k), k)
    np.testing.assert_allclose(a @ ft.ptx_b(ft.load_b_kn(bm, k), k),
                               (xs * w[:, None]).T @ bm, rtol=1e-12)


def _pads():
    import re
    src = (HERE.parent / "src" / "repro_torch" / "csrc" /
           "mma_sync.cuh").read_text()
    return {ct: int(re.search(rf"PadPk<{ct}> {{ static constexpr int value "
                              rf"= (\d+);", src).group(1))
            for ct in ("float", "__nv_bfloat16")}


@pytest.mark.parametrize("cols", [16, 32, 128, 256])
def test_pk_rows_make_8_byte_loads_conflict_free(cols):
    """TF32 rows of cols + PadPk floats: each half-warp's 8-byte loads of
    load_a_pk / load_b_nk_pk touch 32 distinct banks (the LoRA x and W^T
    tiles at 32 + pad, the SSD C/B/state rows at N + pad), and rows stay
    16-byte aligned."""
    ld = cols + _pads()["float"]
    assert ld * 4 % 16 == 0
    mat = np.arange(64 * ld).reshape(64, ld)
    # each 8-byte load fills two registers; its lower word is A's register
    # 0 (row g) or 1 (row g + 8), B's register 0
    for frags, lows in ((load_a_pk(mat, 8), (0, 1)),
                        (load_b_nk_pk(mat, 8), (0,))):
        for reg in lows:
            for half in (range(16), range(16, 32)):
                words = [int(frags[lane][reg]) for lane in half]
                banks = [(wd + e) % 32 for wd in words for e in (0, 1)]
                assert len(banks) == len(set(banks)), (cols, reg)


@pytest.mark.parametrize("pt", [16, 32, 64])
def test_chunk_state_x_reads_are_conflict_free(pt):
    """XtW reads x tile rows 2t, 2t+1 at columns g, g+8 (TF32): with rows of
    pt + 4 floats a warp's 32 reads hit 32 banks."""
    ld = pt + 4
    mat = np.arange(64 * ld).reshape(64, ld)
    frags = xtw(mat, np.ones(64, dtype=np.int64), 8)
    for reg in range(4):
        banks = [int(f[reg]) % 32 for f in frags]
        assert len(banks) == len(set(banks)), (pt, reg)
