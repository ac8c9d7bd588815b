"""Bitwise pins of the port's numpy host layers against the JAX package.

The port keeps its own copies of the reference's numpy modules (data,
the accuracy controller, the comm accounting), because it imports
nothing of the JAX package.  Each copy must give exactly the reference's
answer: the same corpus, partition and loader batches for a seed and
round, the same C3 weights and cuts, the same wire bytes and ranks.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import data as j_data  # noqa: E402
from repro.config import reduced as j_reduced  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import adaptive as j_adaptive  # noqa: E402
from repro.core import comm as j_comm  # noqa: E402
from repro.core import lora as j_lora  # noqa: E402
from repro.core import smashed as j_smashed  # noqa: E402
from repro.data.pipeline import stack_client_batches as j_stack  # noqa: E402
from repro.models.model import build_model as j_build_model  # noqa: E402
from repro_torch import data as t_data  # noqa: E402
from repro_torch.config import reduced as t_reduced  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.core import adaptive as t_adaptive  # noqa: E402
from repro_torch.core import comm as t_comm  # noqa: E402
from repro_torch.core import lora as t_lora  # noqa: E402
from repro_torch.core import smashed as t_smashed  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402


def _samples(data, vocab=2048, n=120, seed=3):
    tok = data.HashTokenizer(vocab)
    texts = data.synthetic_corpus(n, seed=seed, mean_len=40)
    return texts, [np.asarray(tok.encode(t), np.int32) for t in texts]


def test_corpus_and_tokenizer_are_the_reference():
    texts_j, toks_j = _samples(j_data)
    texts_t, toks_t = _samples(t_data)
    assert texts_t == texts_j
    for a, b in zip(toks_t, toks_j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strategy,alpha", [("dirichlet", 0.9),
                                            ("dirichlet", 0.1),
                                            ("iid", 0.9)])
def test_partitions_are_the_reference(strategy, alpha):
    _, toks = _samples(j_data)
    lengths = [len(t) for t in toks]
    got = t_data.partition_dataset(lengths, 5, strategy=strategy,
                                   alpha=alpha, seed=7)
    want = j_data.partition_dataset(lengths, 5, strategy=strategy,
                                    alpha=alpha, seed=7)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        t_data.length_dirichlet_partition(lengths, 3, alpha=0.5, seed=1)[2],
        j_data.length_dirichlet_partition(lengths, 3, alpha=0.5, seed=1)[2])


def test_client_loader_batches_are_the_reference():
    _, toks = _samples(j_data)
    parts = j_data.partition_dataset([len(t) for t in toks], 4,
                                     strategy="dirichlet", alpha=0.9)
    kw = dict(batch_size=3, seq_len=24, seed=11)
    lj = j_data.make_client_loaders(toks, parts, **kw)
    lt = t_data.make_client_loaders(toks, parts, **kw)
    assert [ld.num_samples() for ld in lt] == [ld.num_samples() for ld in lj]
    for r in (0, 5):
        got = t_data.stack_client_batches([ld.batch(r) for ld in lt])
        want = j_stack([ld.batch(r) for ld in lj])
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_c3_weights_and_cuts_are_the_reference():
    split_j = j_get_config("gpt2-small").split
    split_t = t_get_config("gpt2-small").split
    assert dataclasses.asdict(split_t) == dataclasses.asdict(split_j)
    accs = np.array([0.31, 0.29, 0.3005, 0.25, 0.36])
    np.testing.assert_array_equal(t_adaptive.update_weights(accs, 0.5),
                                  j_adaptive.update_weights(accs, 0.5))
    cuts = np.array([2, 4, 2, 6, 10])
    times = np.array([1.0, 1.1, 0.9, 3.0, 1.0])
    for kw in (dict(), dict(round_times=times),
               dict(round_times=times, active=[1, 1, 0, 1, 1]),
               dict(dead_band=0.05)):
        np.testing.assert_array_equal(
            t_adaptive.adjust_cuts(cuts, accs, split_t, 12, **kw),
            j_adaptive.adjust_cuts(cuts, accs, split_j, 12, **kw))


@pytest.mark.parametrize("smashed", ["none", "int8", "fp8", "topk"])
def test_round_comm_bytes_are_the_reference(smashed):
    arch_j = j_reduced(j_get_config("gpt2-small"), layers=6, d_model=64)
    arch_t = t_reduced(t_get_config("gpt2-small"), layers=6, d_model=64)
    model_j = j_build_model(arch_j)
    model_t = build_model(arch_t, device="cpu")
    for kw in (dict(cuts=[1, 3, 5, 2]), dict(cuts=[2, 2, 4, 5],
                                             rank_cut=[1, 2, 2, 1],
                                             compress_ratio=0.25)):
        got = t_comm.round_comm_bytes(model_t, batch_size=4, seq_len=64,
                                      smashed_compress=smashed, **kw)
        want = j_comm.round_comm_bytes(model_j, batch_size=4, seq_len=64,
                                       smashed_compress=smashed, **kw)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert t_smashed.wire_bytes(smashed, batch=4, seq=512, d_model=768) == \
        j_smashed.wire_bytes(smashed, batch=4, seq=512, d_model=768)


@pytest.mark.parametrize("two_side", [True, False])
def test_effective_ranks_are_the_reference(two_side):
    lora_j = dataclasses.replace(j_get_config("gpt2-small").lora,
                                 two_side_cut=two_side)
    lora_t = dataclasses.replace(t_get_config("gpt2-small").lora,
                                 two_side_cut=two_side)
    cuts = np.array([1, 2, 11, 6], np.int32)
    want = np.asarray(j_lora.effective_ranks(12, cuts, lora_j))
    got = t_lora.effective_ranks(12, torch.from_numpy(cuts), lora_t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    rc = np.array([4, 8, 2, 16], np.int32)
    np.testing.assert_array_equal(
        t_lora.effective_ranks(12, torch.from_numpy(cuts), lora_t,
                               r_cut=torch.from_numpy(rc)).numpy(),
        np.asarray(j_lora.effective_ranks(12, cuts, lora_j, r_cut=rc)))
