"""Dtype names for the Program IR.

Dtypes stay plain strings in the IR, exactly as in the JAX package, so a
program written by either package reads the same in the other. Here a
name resolves to a ``torch.dtype``; ``"bfloat16"`` is ``torch.bfloat16``
(numpy has no bfloat16 of its own, and this package does not depend on
``ml_dtypes``).
"""
from __future__ import annotations

import numpy as np
import torch

_ALIASES = {
    "float32": "float32", "fp32": "float32",
    "float64": "float64", "fp64": "float64",
    "float16": "float16", "fp16": "float16",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", "uint8": "uint8", "int16": "int16",
    "int32": "int32", "int64": "int64", "bool": "bool",
}

_TORCH = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH.items()}

_FLOATING = ("float16", "float32", "float64", "bfloat16")


def convert_dtype(dtype) -> str:
    """Canonicalise a dtype spec (str, np.dtype, torch.dtype) to its name."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAMES:
            raise ValueError(f"unsupported dtype {dtype!r}")
        return _NAMES[dtype]
    if isinstance(dtype, str):
        if dtype not in _ALIASES:
            raise ValueError(f"unsupported dtype {dtype!r}")
        return _ALIASES[dtype]
    d = np.dtype(dtype)
    # an ml_dtypes bfloat16 array handed in by a caller still names itself
    return "bfloat16" if d.name == "bfloat16" else convert_dtype(d.name)


def as_torch_dtype(dtype) -> torch.dtype:
    return _TORCH[convert_dtype(dtype)]


def as_np_dtype(dtype) -> np.dtype:
    """The numpy dtype a host array of this dtype takes: bfloat16 as
    float32 (exactly representable), to be cast on the device."""
    name = convert_dtype(dtype)
    return np.dtype("float32" if name == "bfloat16" else name)


def is_floating(dtype) -> bool:
    return convert_dtype(dtype) in _FLOATING
