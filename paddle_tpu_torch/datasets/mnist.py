"""MNIST reader (reference python/paddle/dataset/mnist.py): samples are
(784-float32 image in [-1, 1], int64 label)."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test"]


def _maybe_real(name, split):
    from . import real_reader
    return real_reader(name, split)

TRAIN_SIZE = 8192  # synthetic subset sizes (see datasets/__init__.py)
TEST_SIZE = 1024


def _reader(n, seed):
    def r():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(0, 10))
            img = rng.uniform(-1, 1, 784).astype(np.float32)
            # embed a label-dependent pattern so models can actually learn
            img[label * 8:(label + 1) * 8] += 2.0
            yield img, label
    return r


def train():
    return _maybe_real("mnist", "train") or _reader(TRAIN_SIZE, seed=1)


def test():
    return _maybe_real("mnist", "test") or _reader(TEST_SIZE, seed=2)
