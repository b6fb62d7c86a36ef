"""Built-in dataset readers: mnist, cifar, imdb, uci_housing, movielens
and wmt16, the JAX package's modules copied (each split yields the same
samples, byte for byte).

Each corpus is a deterministic synthetic generator with the reference
corpus's sample shapes, dtypes, vocabulary structure and reader API
(train()/test() returning nullary reader creators), so training
pipelines and feed shapes are drop-in; accuracy numbers are not
comparable to the real corpora. For mnist/cifar/uci_housing, set
PADDLE_TPU_DATA_HOME to a directory containing <corpus>_<split>.npz
files (arrays `x`, `y`) to train on real copies; the text corpora
(imdb/movielens/wmt16) are synthetic-only.
"""
import os

import numpy as np


def real_data(name: str, split: str):
    """Returns an (x, y) pair from $PADDLE_TPU_DATA_HOME/<name>_<split>.npz
    or None when no real copy is installed."""
    home = os.environ.get("PADDLE_TPU_DATA_HOME")
    if not home:
        return None
    path = os.path.join(home, f"{name}_{split}.npz")
    if not os.path.exists(path):
        return None
    blob = np.load(path)
    return blob["x"], blob["y"]


def real_reader(name: str, split: str):
    """Nullary reader creator over a real corpus copy, or None when the
    override is not installed (shared by mnist/cifar/uci_housing)."""
    pair = real_data(name, split)
    if pair is None:
        return None
    xs, ys = pair

    def r():
        yield from zip(xs, ys)
    return r


from . import cifar, imdb, mnist, movielens, uci_housing, wmt16  # noqa: F401,E402

__all__ = ["mnist", "cifar", "uci_housing", "imdb", "movielens", "wmt16",
           "real_data", "real_reader"]
