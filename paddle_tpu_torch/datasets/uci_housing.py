"""UCI housing reader (reference python/paddle/dataset/uci_housing.py):
samples are (13-float32 features, 1-float32 price); features are
feature-normalized like the reference's preprocessing."""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test"]


def _maybe_real(name, split):
    from . import real_reader
    return real_reader(name, split)

_W = None


def _w():
    global _W
    if _W is None:
        _W = np.random.RandomState(7).randn(13, 1).astype(np.float32)
    return _W


def _reader(n, seed):
    def r():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            x = rng.randn(13).astype(np.float32)
            y = (x @ _w() + 0.1 * rng.randn(1)).astype(np.float32)
            yield x, y
    return r


def train():
    return _maybe_real("uci_housing", "train") or _reader(404, seed=8)


def test():
    return _maybe_real("uci_housing", "test") or _reader(102, seed=9)
