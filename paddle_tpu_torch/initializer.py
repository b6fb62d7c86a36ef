"""Initializers: emit init ops into the startup program.

Each initializer appends a fill_constant, uniform_random or
gaussian_random op on the parameter into the startup block; running the
startup program materialises the parameters in the Scope on the
executor's device. Only the initializers the encoder's layers use are
here.
"""
from __future__ import annotations

import math

__all__ = ["Constant", "Uniform", "Normal", "Xavier",
           "ConstantInitializer", "UniformInitializer", "NormalInitializer",
           "XavierInitializer"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op("fill_constant", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "value": float(self.value)},
                        infer_shape=False)


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, var, block):
        block.append_op("uniform_random", outputs={"Out": [var.name]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "min": float(self.low),
                               "max": float(self.high)},
                        infer_shape=False)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc, self.scale = loc, scale

    def __call__(self, var, block):
        block.append_op("gaussian_random", outputs={"Out": [var.name]},
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
    def __init__(self, uniform=True, fan_in=None, fan_out=None):
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


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
