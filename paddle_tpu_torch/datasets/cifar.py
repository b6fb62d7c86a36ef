"""CIFAR-10/100 readers (reference python/paddle/dataset/cifar.py):
samples are (3072-float32 image in [0, 1], int64 label)."""
from __future__ import annotations

import numpy as np

__all__ = ["train10", "test10", "train100", "test100"]


def _maybe_real(name, split):
    from . import real_reader
    return real_reader(name, split)


def _reader(n, n_classes, seed):
    def r():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(0, n_classes))
            img = rng.uniform(0, 1, 3072).astype(np.float32)
            img[label * 16:(label + 1) * 16] += 0.5
            yield img, label
    return r


def train10():
    return _maybe_real("cifar10", "train") or _reader(4096, 10, seed=3)


def test10():
    return _maybe_real("cifar10", "test") or _reader(512, 10, seed=4)


def train100():
    return _maybe_real("cifar100", "train") or _reader(4096, 100, seed=5)


def test100():
    return _maybe_real("cifar100", "test") or _reader(512, 100, seed=6)
