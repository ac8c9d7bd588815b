"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked `cuda` and skips without a GPU; the file
imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 1e-4 (the kernels sum in another order than the plain
versions), bf16 2e-2 (one rounding of the output to bf16).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import reduced  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.lora_matmul import ops as lops  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.runtime import serving  # noqa: E402

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 9])
def test_flash_kernel_matches_plain(cuda, dtype, window):
    """Ragged lengths (37 divides no tile), GQA 4/2, and a q offset."""
    gen = torch.Generator().manual_seed(0)
    q = _randn(gen, 2, 37, 4, 64, dtype=dtype)
    k = _randn(gen, 2, 41, 2, 64, dtype=dtype)
    v = _randn(gen, 2, 41, 2, 64, dtype=dtype)
    out, lse = fops.flash_attention_fwd(q.to(cuda), k.to(cuda), v.to(cuda),
                                        window=window, q_offset=4)
    want, want_lse = fops.flash_attention_fwd(q, k, v, window=window,
                                              q_offset=4)
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
