"""Kernel parity of the PyTorch port against the JAX package.

Each port kernel's plain version (the path a CPU tensor takes) is held
against the Pallas kernel in interpret mode and against the JAX oracle,
on the same numpy inputs: fp32 at 2e-5, bf16 at 2e-2 (the bands of
tests/test_serving.py).  The decode kernels' contract is exact zeros at
cache_len = 0, where the JAX oracle gives NaN, so the oracle is compared
only on rows with cache_len > 0.  The CUDA kernels themselves are held
against these plain versions on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import kernel as jdk  # noqa: E402
from repro.kernels.decode_attention import ref as jdref  # noqa: E402
from repro.kernels.flash_attention import kernel as jfk  # noqa: E402
from repro.kernels.flash_attention import ref as jfref  # noqa: E402
from repro.kernels.lora_matmul import kernel as jlk  # noqa: E402
from repro.kernels.lora_matmul import ref as jlref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as tdops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tfops  # noqa: E402
from repro_torch.kernels.lora_matmul import ops as tlops  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(arr, dname):
    """The same values as a JAX array and a CPU torch tensor."""
    jd, td, _ = DTYPES[dname]
    j = jnp.asarray(arr, jnp.float32).astype(jd)
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(td)
    return j, t


def _close(got_t, want_j, tol):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# flash attention forward


FLASH_CASES = {
    # name: (B, S, H, KVH, hd, causal, window)
    "causal": (2, 16, 2, 2, 8, True, 0),
    "gqa": (1, 16, 4, 2, 8, True, 0),
    "window": (1, 16, 4, 2, 8, True, 5),
    "bidirectional": (1, 16, 2, 1, 8, False, 0),
}


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_matches_pallas_and_oracle(case, dname):
    b, s, h, kvh, hd, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng.normal(size=(b, s, h, hd)), dname)
    kj, kt = _pair(rng.normal(size=(b, s, kvh, hd)), dname)
    vj, vt = _pair(rng.normal(size=(b, s, kvh, hd)), dname)
    tol = DTYPES[dname][2]

    out, lse = tfops.flash_attention_fwd(qt, kt, vt, causal=causal,
                                         window=window)
    assert out.dtype == qt.dtype and lse.shape == (b * h, s, 1)
    want_out, want_lse = jfk.flash_attention_pallas(
        qj, kj, vj, causal=causal, window=window, bq=8, bk=8, interpret=True)
    _close(out, want_out, tol)
    _close(lse, want_lse, tol)
    _close(out, jfref.attention(qj, kj, vj, causal=causal, window=window),
           tol)


@pytest.mark.parametrize("q_offset", [0, 3])
def test_flash_plain_ragged_and_offset_match_oracle(q_offset):
    """Lengths that divide no block (the Pallas kernel refuses them; the
    port's kernel masks the tails) and a decode-style query offset."""
    rng = np.random.default_rng(1)
    sq, sk = 13 - q_offset, 13
    qj, qt = _pair(rng.normal(size=(1, sq, 4, 8)), "float32")
    kj, kt = _pair(rng.normal(size=(1, sk, 2, 8)), "float32")
    vj, vt = _pair(rng.normal(size=(1, sk, 2, 8)), "float32")
    got = tfops.flash_attention(qt, kt, vt, causal=True, q_offset=q_offset)
    want = jfref.attention(qj, kj, vj, causal=True, q_offset=q_offset)
    _close(got, want, 2e-5)


def test_flash_plain_empty_rows_give_zeros():
    """A window of 1 with a negative offset leaves early rows no key: the
    kernel contract is zeros and lse 0, where the oracle gives NaN."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(1, 4, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 4, 2, 8)).astype(np.float32))
    out, lse = tfops.flash_attention_fwd(q, k, k, causal=True, q_offset=-2)
    assert torch.equal(out[:, :2], torch.zeros_like(out[:, :2]))
    assert torch.equal(lse.reshape(2, 4)[:, :2], torch.zeros(2, 2))
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# indexed LoRA


def _lora_inputs(dname, *, b=5, s=3, k=32, n=48, r=8, p=4, seed=2):
    rng = np.random.default_rng(seed)
    ranks = np.array([8, 2, 4, 8])[:p]
    mask = (np.arange(r)[None, :] < ranks[:, None]).astype(np.float32)
    arrs = dict(
        x=rng.normal(size=(b, s, k)),
        w=rng.normal(size=(k, n)) * 0.05,
        a=rng.normal(size=(p, k, r)) * 0.05 * mask[:, None, :],
        b=rng.normal(size=(p, r, n)) * 0.05 * mask[:, :, None])
    out = {name: _pair(v, dname) for name, v in arrs.items()}
    scale = np.array([0.5, 2.0, 1.0, 0.25], np.float32)[:p]
    out["scale"] = (jnp.asarray(scale), torch.from_numpy(scale))
    ids = np.array([2, 0, 3, 0, 1], np.int32)[:b]
    out["ids"] = (jnp.asarray(ids), torch.from_numpy(ids))
    return out


@pytest.mark.parametrize("dname", list(DTYPES))
def test_lora_indexed_plain_matches_pallas_and_oracle(dname):
    """Masked heterogeneous ranks, repeated ids, (B, S, K) rows."""
    d = _lora_inputs(dname)
    tol = DTYPES[dname][2]
    got = tlops.lora_matmul_indexed(d["x"][1], d["w"][1], d["a"][1],
                                    d["b"][1], d["scale"][1], d["ids"][1])
    assert got.shape == (5, 3, 48) and got.dtype == d["x"][1].dtype
    want = jlref.lora_matmul_indexed(d["x"][0], d["w"][0], d["a"][0],
                                     d["b"][0], d["scale"][0], d["ids"][0])
    _close(got, want, tol)
    x2 = d["x"][0].reshape(-1, 32)
    row_ids = jnp.repeat(d["ids"][0], 3)
    pallas = jlk.lora_matmul_indexed_pallas(
        x2, d["w"][0], d["a"][0], d["b"][0], d["scale"][0], row_ids,
        bn=48, bk=32, interpret=True)
    _close(got.reshape(-1, 48), pallas, tol)


@pytest.mark.parametrize("perm", [[4, 3, 2, 1, 0], [1, 0, 4, 2, 3]])
def test_lora_indexed_plain_rows_follow_their_ids(perm):
    """Permuting rows with their ids permutes the output: each row's
    adapter is its own."""
    d = _lora_inputs("float32")
    x, w, a, b = (d[n][1] for n in ("x", "w", "a", "b"))
    scale, ids = d["scale"][1], d["ids"][1]
    p = torch.as_tensor(perm)
    out = tlops.lora_matmul_indexed(x, w, a, b, scale, ids)
    out_p = tlops.lora_matmul_indexed(x[p], w, a, b, scale, ids[p])
    torch.testing.assert_close(out_p, out[p], rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# flash-decode, contiguous and paged


def _decode_inputs(dname, *, b=4, s=16, h=4, kvh=2, hd=8, seed=3):
    rng = np.random.default_rng(seed)
    return (_pair(rng.normal(size=(b, h, hd)), dname),
            _pair(rng.normal(size=(b, s, kvh, hd)), dname),
            _pair(rng.normal(size=(b, s, kvh, hd)), dname))


def _clen(vals):
    a = np.asarray(vals, np.int32)
    return jnp.asarray(a), torch.from_numpy(a)


DECODE_LENS = {
    "ragged_and_zero": [3, 0, 9, 16],
    "exactly_full": [16, 16, 16, 16],
}


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("lens", list(DECODE_LENS))
def test_decode_plain_matches_pallas_and_oracle(lens, window, dname):
    (qj, qt), (kj, kt), (vj, vt) = _decode_inputs(dname)
    cj, ct = _clen(DECODE_LENS[lens])
    tol = DTYPES[dname][2]
    got = tdops.decode_attention(qt, kt, vt, ct, window=window)
    pallas = jdk.decode_attention_pallas(qj, kj, vj, cj, bs=8, window=window,
                                         interpret=True)
    _close(got, pallas, tol)
    live = np.asarray(DECODE_LENS[lens]) > 0
    oracle = np.asarray(jdref.decode_attention(qj, kj, vj, cj,
                                               window=window), np.float32)
    np.testing.assert_allclose(got.float().numpy()[live], oracle[live],
                               rtol=tol, atol=tol)
    assert torch.equal(got[~torch.from_numpy(live)],
                       torch.zeros_like(got[~torch.from_numpy(live)]))


def _paged_inputs(dname, seed=4):
    """Pools of 9 pages x 4 positions; each of 3 sequences owns 3 pages in
    a shuffled order."""
    rng = np.random.default_rng(seed)
    n_pages, ps, kvh, hd, h = 9, 4, 2, 8, 4
    q = _pair(rng.normal(size=(3, h, hd)), dname)
    kp = _pair(rng.normal(size=(n_pages, ps, kvh, hd)), dname)
    vp = _pair(rng.normal(size=(n_pages, ps, kvh, hd)), dname)
    pt = rng.permutation(np.arange(1, n_pages)).astype(np.int32)[:6]
    pt = np.concatenate([pt, [8, 0, 3]]).reshape(3, 3).astype(np.int32)
    return q, kp, vp, pt


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("window", [0, 3])
def test_paged_decode_plain_matches_pallas_and_oracle(window, dname):
    (qj, qt), (kj, kt), (vj, vt), pt = _paged_inputs(dname)
    cj, ct = _clen([5, 0, 12])            # ragged, idle, exactly full
    tol = DTYPES[dname][2]
    got = tdops.decode_attention_paged(qt, kt, vt, torch.from_numpy(pt), ct,
                                       window=window)
    pallas = jdk.decode_attention_paged_pallas(
        qj, kj, vj, jnp.asarray(pt), cj, window=window, interpret=True)
    _close(got, pallas, tol)
    oracle = np.asarray(jdref.decode_attention_paged(
        qj, kj, vj, jnp.asarray(pt), cj, window=window), np.float32)
    np.testing.assert_allclose(got.float().numpy()[[0, 2]], oracle[[0, 2]],
                               rtol=tol, atol=tol)
    assert torch.equal(got[1], torch.zeros_like(got[1]))


def test_paged_decode_plain_masks_garbage_table_entries():
    """Entries past the valid prefix may be trash or out of range: they
    are clipped into the pool and masked by cache_len."""
    (_, qt), (_, kt), (_, vt), pt = _paged_inputs("float32", seed=5)
    ct = torch.tensor([3, 4, 2], dtype=torch.int32)   # within page 0
    base = tdops.decode_attention_paged(qt, kt, vt, torch.from_numpy(pt), ct)
    trash = pt.copy()
    trash[:, 1:] = np.array([[0, 9999], [-3, 7], [12, -1]])
    got = tdops.decode_attention_paged(qt, kt, vt, torch.from_numpy(trash),
                                       ct)
    torch.testing.assert_close(got, base, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Build: no nvcc is an error, never a fallback


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(out_dir=tmp_path / "build")
    assert not (tmp_path / "build" / _build.LIB_NAME).exists()


def test_dtype_codes_reject_other_types():
    assert _build.dtype_code(torch.float32) == 0
    assert _build.dtype_code(torch.bfloat16) == 1
    with pytest.raises(TypeError):
        _build.dtype_code(torch.float16)
