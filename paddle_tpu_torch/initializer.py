"""Initializers: emit init ops into the startup program.

Each initializer appends a fill_constant, uniform_random,
gaussian_random, truncated_gaussian_random or assign_value op on the
parameter into the startup block; running the startup program
materialises the parameters in the Scope on the executor's device. The
`seed` arguments are accepted and not read, as in the JAX package: the
draws come from the program's seed (core/lowering.py).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "TruncatedNormal", "Xavier",
           "MSRA", "Bilinear", "NumpyArrayInitializer",
           "ConstantInitializer", "UniformInitializer", "NormalInitializer",
           "TruncatedNormalInitializer", "XavierInitializer",
           "MSRAInitializer", "BilinearInitializer", "force_init_on_cpu",
           "init_on_cpu"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "value": float(self.value)},
                        infer_shape=False)


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high = low, high

    def __call__(self, var, block):
        block.append_op("uniform_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "min": float(self.low),
                               "max": float(self.high)},
                        infer_shape=False)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale = loc, scale

    def __call__(self, var, block):
        block.append_op("gaussian_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": float(self.loc),
                               "std": float(self.scale)},
                        infer_shape=False)


class TruncatedNormalInitializer(Initializer):
    """N(loc, scale²) truncated at 2 standard deviations."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale = loc, scale

    def __call__(self, var, block):
        block.append_op("truncated_gaussian_random",
                        outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": float(self.loc),
                               "std": float(self.scale)},
                        infer_shape=False)


def _fans(var):
    """(fan_in, fan_out). FC weights are [in, out]; conv filters are
    [out_c, in_c, kh, kw]."""
    shape = var.shape
    if len(shape) < 2:
        return shape[0] if shape else 1, shape[0] if shape else 1
    if len(shape) == 2:
        return shape[0], shape[1]
    recept = math.prod(shape[2:])
    return shape[1] * recept, shape[0] * recept


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out = uniform, fan_in, fan_out

    def __call__(self, var, block):
        fin, fout = _fans(var)
        fin = self.fan_in if self.fan_in is not None else fin
        fout = self.fan_out if self.fan_out is not None else fout
        if self.uniform:
            limit = math.sqrt(6.0 / (fin + fout))
            UniformInitializer(-limit, limit)(var, block)
        else:
            NormalInitializer(0.0, math.sqrt(2.0 / (fin + fout)))(var, block)


class MSRAInitializer(Initializer):
    """He initialisation from the fan-in: uniform in ±sqrt(6/fan_in), or
    normal with std sqrt(2/fan_in)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in = uniform, fan_in

    def __call__(self, var, block):
        fin, _ = _fans(var)
        fin = self.fan_in if self.fan_in is not None else fin
        if self.uniform:
            limit = math.sqrt(6.0 / fin)
            UniformInitializer(-limit, limit)(var, block)
        else:
            NormalInitializer(0.0, math.sqrt(2.0 / fin))(var, block)


class BilinearInitializer(Initializer):
    """The bilinear upsampling kernel for a [C, K, H, W] conv_transpose
    filter, computed on the host and written by assign_value."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("Bilinear init needs a 4-D filter")
        c, k, h, w = shape
        f = math.ceil(w / 2.0)
        cc = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype="float32")
        for i in range(np.prod(shape)):
            x = i % w
            y = (i // w) % h
            v = (1 - abs(x / f - cc)) * (1 - abs(y / f - cc))
            weight[i // (w * h * k) % c, (i // (w * h)) % k, y, x] = v
        NumpyArrayInitializer(weight)(var, block)


class NumpyArrayInitializer(Initializer):
    """The given array, cast to the var's dtype (assign_value)."""

    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op("assign_value", outputs={"Out": [var.name]},
                        attrs={"shape": list(self.value.shape),
                               "dtype": var.dtype,
                               "values": self.value},
                        infer_shape=False)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
TruncatedNormal = TruncatedNormalInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


# Parameters are initialised where the startup program runs (the
# executor's device); there is no separate CPU-init path to select, so
# the context manager only sets what force_init_on_cpu() reads.
_force_init_on_cpu_flag = False


def force_init_on_cpu():
    return _force_init_on_cpu_flag


@contextlib.contextmanager
def init_on_cpu():
    global _force_init_on_cpu_flag
    prev = _force_init_on_cpu_flag
    _force_init_on_cpu_flag = True
    try:
        yield
    finally:
        _force_init_on_cpu_flag = prev
