"""Weight carry from the JAX package: numpy arrays into a Scope.

``scope_from_numpy(params, scope, place)`` places the JAX package's
parameters, given as numpy arrays under their variable names, as tensors
on `place` in the port's Scope. ``io.load_inference_model`` goes through
it, so a model directory saved by the JAX package is itself a carry path.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.place import Place
from .core.scope import Scope


def tensor_from_numpy(arr: np.ndarray, device) -> torch.Tensor:
    """numpy -> a tensor of its own on `device` (never aliasing the
    caller's array). A bfloat16 array (ml_dtypes, as the JAX package
    produces) is reinterpreted bit for bit as torch.bfloat16."""
    arr = np.ascontiguousarray(arr)
    bf16 = arr.dtype.name == "bfloat16"
    if bf16:
        arr = arr.view(np.int16)
    t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    if bf16:
        t = t.view(torch.bfloat16)
    return t.to(device, copy=True)


def scope_from_numpy(params: Dict[str, np.ndarray], scope: Scope,
                     place: Place) -> Scope:
    """Set every array of `params` in `scope` under its own name, as a
    tensor on `place`. Returns the scope."""
    device = place.torch_device()
    for name, arr in params.items():
        scope.set(name, tensor_from_numpy(arr, device))
    return scope
