"""dygraph.Layer, the base of eager models (reference dygraph/layers.py:33).

It keeps the JAX package's API, not torch's: ``parameters()`` is a list
of ``VarBase`` (own parameters first, then each sublayer's in the order
they were set), ``state_dict()`` maps structured names to numpy arrays,
and ``train()`` / ``eval()`` set the guard-wide is_test.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from . import VarBase, _state, current_device

__all__ = ["Layer"]


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self._parameters: Dict[str, VarBase] = {}
        self._sub_layers: Dict[str, "Layer"] = {}
        self._full_name = name_scope or type(self).__name__.lower()
        self._dtype = dtype
        self.training = True

    def full_name(self):
        return self._full_name

    # -- parameter management -------------------------------------------
    def create_parameter(self, shape, dtype="float32", initializer=None,
                         is_bias=False, attr=None):
        """A trainable parameter drawn on the host from a torch.Generator
        seeded from the default startup program's random_seed and the
        parameter's count in the guard (so one seed gives the same
        weights on the card and on the CPU), then placed on the guard's
        device."""
        from ..core.dtypes import as_torch_dtype
        from ..core.lowering import _mix
        from ..framework import default_startup_program
        from ..initializer import Constant, Xavier
        init = initializer or (attr.initializer if attr is not None and
                               getattr(attr, "initializer", None) else None)
        shape = [int(s) for s in shape]
        if init is None:
            init = Constant(0.0) if is_bias else Xavier()
        _state["param_counter"] += 1
        gen = torch.Generator()
        gen.manual_seed(_mix(default_startup_program().random_seed,
                             _state["param_counter"]))
        value = _materialise_init(init, shape, gen)
        return VarBase(value.to(current_device(), as_torch_dtype(dtype)),
                       persistable=True, stop_gradient=False)

    def add_parameter(self, name, param):
        self._parameters[name] = param
        return param

    def add_sublayer(self, name, layer):
        self._sub_layers[name] = layer
        return layer

    def parameters(self, include_sublayers=True):
        out = list(self._parameters.values())
        if include_sublayers:
            for sub in self._sub_layers.values():
                out.extend(sub.parameters())
        return out

    def named_parameters(self, prefix="") -> Iterator[Tuple[str, VarBase]]:
        for n, p in self._parameters.items():
            yield (f"{prefix}.{n}" if prefix else n), p
        for sn, sub in self._sub_layers.items():
            yield from sub.named_parameters(
                f"{prefix}.{sn}" if prefix else sn)

    def sublayers(self, include_sublayers=True):
        out = list(self._sub_layers.values())
        if include_sublayers:
            for s in self._sub_layers.values():
                out.extend(s.sublayers())
        return out

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    # -- train/eval ------------------------------------------------------
    def train(self):
        _state["is_test"] = False
        self.training = True
        for s in self.sublayers():
            s.training = True

    def eval(self):
        _state["is_test"] = True
        self.training = False
        for s in self.sublayers():
            s.training = False

    # -- state dict ------------------------------------------------------
    def state_dict(self, include_sublayers=True):
        return {n: p.numpy() for n, p in self.named_parameters()}

    def set_dict(self, state, include_sublayers=True):
        """Each parameter named in `state` takes its array, on the
        parameter's device (convert.tensor_from_numpy: bfloat16 bit for
        bit, float64 narrowed to float32)."""
        for n, p in self.named_parameters():
            if n in state:
                p.set_value(state[n])

    load_dict = set_dict

    # -- call ------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError

    def __setattr__(self, name, value):
        if isinstance(value, VarBase) and value.persistable:
            self.__dict__.setdefault("_parameters", {})[name] = value
        elif isinstance(value, Layer):
            self.__dict__.setdefault("_sub_layers", {})[name] = value
        object.__setattr__(self, name, value)


def _materialise_init(init, shape, gen):
    """Run an initializer spec on the host in float32 (static initializers
    emit startup ops; eager mode materialises directly)."""
    from .. import initializer as I
    if isinstance(init, I.ConstantInitializer):
        return torch.full(shape, float(init.value))
    if isinstance(init, I.UniformInitializer):
        return _uniform(shape, init.low, init.high, gen)
    if isinstance(init, I.NormalInitializer):
        return torch.randn(shape, generator=gen) * init.scale + init.loc
    if isinstance(init, I.TruncatedNormalInitializer):
        from ..ops.tensor_ops import truncated_normal
        return truncated_normal(torch.rand(shape, generator=gen)) * \
            init.scale + init.loc
    if isinstance(init, I.XavierInitializer):
        fin, fout = I._fans(_Shaped(shape))
        fin = init.fan_in if init.fan_in is not None else fin
        fout = init.fan_out if init.fan_out is not None else fout
        if init.uniform:
            lim = math.sqrt(6.0 / (fin + fout))
            return _uniform(shape, -lim, lim, gen)
        return torch.randn(shape, generator=gen) * math.sqrt(
            2.0 / (fin + fout))
    if isinstance(init, I.MSRAInitializer):
        fin, _ = I._fans(_Shaped(shape))
        fin = init.fan_in if init.fan_in is not None else fin
        if init.uniform:
            lim = math.sqrt(6.0 / fin)
            return _uniform(shape, -lim, lim, gen)
        return torch.randn(shape, generator=gen) * math.sqrt(2.0 / fin)
    if isinstance(init, I.NumpyArrayInitializer):
        return torch.from_numpy(np.asarray(init.value, np.float32)
                                .reshape(shape).copy())
    raise TypeError(f"unsupported initializer {init!r} in dygraph")


def _uniform(shape, low, high, gen):
    return torch.rand(shape, generator=gen) * (high - low) + low


class _Shaped:
    def __init__(self, shape):
        self.shape = tuple(shape)
