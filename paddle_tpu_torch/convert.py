"""Weight carry from the JAX package: numpy arrays into a Scope.

``scope_from_numpy(params, scope, place)`` places the JAX package's
parameters, given as numpy arrays under their variable names, as tensors
on `place` in the port's Scope. ``io.load_inference_model`` goes through
it, so a model directory saved by the JAX package is itself a carry path.

A training scope carries its optimizer state the same way: moments,
``beta*_pow``, EMA shadows, ModelAverage sums and counts, and the step
counters. The JAX package runs with 64-bit types off, so its scope holds
``@STEP_COUNTER@`` (declared int64) as int32; given the `program`, an
array of a var the program declares 64-bit is widened back to it.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.place import Place
from .core.scope import Scope

# declared 64-bit dtype -> (the dtype a JAX scope holds it in, its own)
_NARROWED = {"int64": (torch.int32, torch.int64),
             "float64": (torch.float32, torch.float64)}


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
                     place: Place, program=None) -> Scope:
    """Set every array of `params` in `scope` under its own name, as a
    tensor on `place`; with `program`, an array narrowed from a 64-bit
    var of the program's global block is widened back. Returns the
    scope."""
    device = place.torch_device()
    block = program.global_block() if program is not None else None
    for name, arr in params.items():
        t = tensor_from_numpy(arr, device)
        declared = block.var(name).dtype \
            if block is not None and block.has_var(name) else None
        narrow, wide = _NARROWED.get(declared, (None, None))
        if t.dtype == narrow:
            t = t.to(wide)
        scope.set(name, t)
    return scope


def layer_from_numpy(state: Dict[str, np.ndarray], layer):
    """Set every parameter of the dygraph `layer` from `state` (a
    ``state_dict()`` of the JAX package's model or of the port's) through
    ``layer.set_dict``. Raises KeyError if the names differ and
    ValueError if a shape does. Returns the layer."""
    params = dict(layer.named_parameters())
    if set(params) != set(state):
        raise KeyError(
            f"state dict and layer differ: missing "
            f"{sorted(set(params) - set(state))}, unexpected "
            f"{sorted(set(state) - set(params))}")
    for name, p in params.items():
        if tuple(np.shape(state[name])) != p.shape:
            raise ValueError(f"{name}: state has shape "
                             f"{tuple(np.shape(state[name]))}, the layer "
                             f"{p.shape}")
    layer.set_dict(state)
    return layer
