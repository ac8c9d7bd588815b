"""Synthetic corpus generator.

Deterministic Zipfian bigram text with heavy-tailed sample lengths.  The
length distribution matters: the paper's C4 partitioner buckets samples by
token length, so the corpus must produce a wide, skewed length spectrum
(Wikitext-2 articles range from one-liners to thousands of tokens).

Samples are learnable (bigram structure) so fine-tuning loss actually
falls — the paper's convergence comparisons need a signal, not noise.

A numpy copy of src/repro/data/corpus.py (the port imports nothing of the
JAX package); tests/test_torch_host.py pins it bitwise to the original.
"""

from __future__ import annotations

from typing import List

import numpy as np

_WORDS = None


def _word_table(n_words: int = 4096) -> List[str]:
    global _WORDS
    if _WORDS is None or len(_WORDS) != n_words:
        rng = np.random.RandomState(1234)
        syll = ["ba", "do", "ke", "li", "mo", "na", "pi", "ra", "su", "te",
                "vu", "za", "chi", "fro", "gle", "sta"]
        words = []
        for i in range(n_words):
            n = 1 + rng.randint(4)
            words.append("".join(syll[rng.randint(len(syll))]
                                 for _ in range(n)))
        _WORDS = words
    return _WORDS


def synthetic_corpus(num_samples: int, *, seed: int = 0,
                     mean_len: int = 180, n_words: int = 4096,
                     n_topics: int = 8) -> List[str]:
    """Returns `num_samples` text samples.

    Each sample draws a topic; topics bias both the bigram transition row
    offsets and the length scale, so length correlates with content — the
    property the paper's length-based Dirichlet partitioner exploits."""
    rng = np.random.RandomState(seed)
    words = _word_table(n_words)
    # Zipfian unigram over words
    ranks = np.arange(1, n_words + 1)
    base_p = 1.0 / ranks
    base_p /= base_p.sum()

    samples = []
    for _ in range(num_samples):
        topic = rng.randint(n_topics)
        # topic-dependent length: lognormal with topic-scaled mean
        scale = mean_len * (0.3 + 1.7 * topic / max(n_topics - 1, 1))
        length = max(8, int(rng.lognormal(np.log(scale), 0.6)))
        length = min(length, 2048)
        # topic shifts the word distribution (cheap "semantic cluster")
        shift = (topic * n_words) // n_topics
        idx = (rng.choice(n_words, size=length, p=base_p) + shift) % n_words
        # bigram smoothing: with prob .5 the next word is a deterministic
        # successor of the previous — gives the model something to learn
        for j in range(1, length):
            if rng.rand() < 0.5:
                idx[j] = (idx[j - 1] * 7 + 13) % n_words
        samples.append(" ".join(words[i] for i in idx))
    return samples
