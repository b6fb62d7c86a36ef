"""Dygraph save/load (reference dygraph/checkpoint.py).

``save_dygraph(state_dict, path)`` writes ``<path>.pdparams.npz``, the
file the JAX package's ``save_dygraph`` writes (an npz, atomically), and
``load_dygraph(path)`` reads it back, so a state dict round-trips and a
JAX package's file loads in the port. (The JAX package's own
``load_dygraph`` looks for ``<path>.pdparams`` and does not find the file
its ``save_dygraph`` wrote.)
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["save_dygraph", "load_dygraph"]

_SUFFIX = ".pdparams.npz"


def save_dygraph(state_dict, model_path):
    from ..io import atomic_np_savez
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    atomic_np_savez(model_path + _SUFFIX,
                    {k: np.asarray(v) for k, v in state_dict.items()})


def load_dygraph(model_path):
    """(parameters, optimizer state): the state dict saved at
    `model_path`, and None (no optimizer state is saved)."""
    with np.load(model_path + _SUFFIX) as blob:
        return {k: blob[k] for k in blob.files}, None
