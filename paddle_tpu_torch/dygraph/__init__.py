"""Dygraph: eager execution over the port's op registry, on torch autograd.

The JAX package's eager mode. ``trace_op`` runs an op's registered
lowering at once on the guard's device, and records it with torch's
autograd when one of its inputs needs a gradient. ``backward()`` is
``torch.autograd.backward`` from the loss: there is no tape and no
replay, so nothing pins a step's activations once the caller drops the
loss (the JAX package's tape keeps every step of a guard alive).

What the caller sees is the JAX package's: ``.grad`` accumulates over
backward calls until ``clear_gradient()``, a second ``backward()`` runs
again (the graph is retained), ``loss.gradient()`` is the seed of ones,
an intermediate ``VarBase`` the caller still holds reports its gradient,
and ``backward()`` outside a guard or under ``no_grad`` raises
RuntimeError.

``guard()`` without a place runs on the card (``CUDAPlace(0)``); tests
pass ``CPUPlace()``.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.dtypes import convert_dtype
from ..core.lowering import _mix
from ..core.place import default_place
from ..core.registry import REGISTRY
from ..core.scope import tensor_to_numpy

__all__ = ["guard", "enabled", "to_variable", "VarBase", "trace_op",
           "Layer", "no_grad", "save_dygraph", "load_dygraph"]

# grad: ops record autograd graphs (false outside a guard and under
# no_grad); capture: a list TracedLayer.trace fills for one call
_state = {"enabled": False, "grad": False, "op_counter": 0, "seed": 0,
          "is_test": False, "var_map": None, "place": None, "device": None,
          "param_counter": 0, "capture": None}


def enabled():
    return _state["enabled"]


@contextlib.contextmanager
def guard(place=None):
    place = place if place is not None else default_place()
    device = place.torch_device()  # raises where the place has no device
    old = dict(_state)
    # WeakValueDictionary: the name lookup of layers.* dispatch must not
    # pin a var; vars die with their last real reference
    _state.update(enabled=True, grad=True, op_counter=0, param_counter=0,
                  var_map=weakref.WeakValueDictionary(), place=place,
                  device=device, capture=None)
    try:
        yield
    finally:
        _state.update(old)


@contextlib.contextmanager
def no_grad():
    old = _state["grad"]
    _state["grad"] = False
    try:
        yield
    finally:
        _state["grad"] = old


def current_device() -> torch.device:
    """The guard's device; outside a guard the card's (raising where
    there is none)."""
    if _state["enabled"]:
        return _state["device"]
    return default_place().torch_device()


def as_tensor(value, device=None) -> torch.Tensor:
    """A tensor of its own on `device` (the guard's by default). numpy
    float64 narrows to float32, as the JAX package's arrays do with
    64-bit types off; integer ids stay int64 (torch indexes with it)."""
    from ..convert import tensor_from_numpy
    device = device if device is not None else current_device()
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return tensor_from_numpy(arr, device)


class VarBase:
    """Eager tensor and autograd node (imperative/layer.h:55): `value` is
    a torch.Tensor, `grad` the accumulated gradient."""

    _counter = [0]

    def __init__(self, value, name=None, stop_gradient=False,
                 persistable=False, trainable=True):
        # value=None creates an unbound placeholder (bound by the layer
        # dispatch in LayerHelper.append_op before anyone reads it)
        self.value = None if value is None else as_tensor(value)
        VarBase._counter[0] += 1
        self.name = name or f"eager_{VarBase._counter[0]}"
        self.stop_gradient = stop_gradient
        self.persistable = persistable
        self.trainable = trainable
        self.grad: Optional[torch.Tensor] = None
        # name -> var, so name-keyed layers.* calls resolve eager vars
        vm = _state.get("var_map")
        if _state["enabled"] and vm is not None:
            vm[self.name] = self

    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return convert_dtype(self.value.dtype)

    def numpy(self):
        return tensor_to_numpy(self.value)

    def set_value(self, v):
        device = self.value.device if self.value is not None else None
        self.value = as_tensor(v, device)

    def clear_gradient(self):
        self.grad = None

    def gradient(self):
        return None if self.grad is None else tensor_to_numpy(self.grad)

    def detach(self):
        return VarBase(self.value.detach(), stop_gradient=True)

    def astype(self, dtype):
        return trace_op("cast", {"X": [self]},
                        {"out_dtype": str(dtype)})["Out"][0]

    def backward(self):
        _run_backward(self)

    # operator sugar
    def _scalar(self, value):
        return VarBase(torch.tensor(value, dtype=self.value.dtype,
                                    device=self.value.device),
                       stop_gradient=True)

    def _bin(self, other, op):
        if not isinstance(other, VarBase):
            other = self._scalar(other)
        return trace_op(op, {"X": [self], "Y": [other]}, {})["Out"][0]

    def __add__(self, o):
        return self._bin(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin(o, "elementwise_sub")

    def __mul__(self, o):
        return self._bin(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin(o, "elementwise_div")

    def __rsub__(self, o):
        return self._scalar(o)._bin(self, "elementwise_sub")

    def __rtruediv__(self, o):
        return self._scalar(o)._bin(self, "elementwise_div")

    def __pow__(self, o):
        return trace_op("pow", {"X": [self]}, {"factor": float(o)})["Out"][0]

    def __neg__(self):
        return trace_op("scale", {"X": [self]},
                        {"scale": -1.0, "bias": 0.0})["Out"][0]

    def __matmul__(self, o):
        return self._bin(o, "matmul")

    def _reduce(self, op_type, dim=None, keep_dim=False):
        attrs = {"dim": list(dim) if dim is not None else None,
                 "keep_dim": keep_dim,
                 "reduce_all": dim is None}
        return trace_op(op_type, {"X": [self]}, attrs)["Out"][0]

    def mean(self, dim=None, keep_dim=False):
        return self._reduce("reduce_mean", dim, keep_dim)

    def sum(self, dim=None, keep_dim=False):
        return self._reduce("reduce_sum", dim, keep_dim)

    def max(self, dim=None, keep_dim=False):
        return self._reduce("reduce_max", dim, keep_dim)

    def min(self, dim=None, keep_dim=False):
        return self._reduce("reduce_min", dim, keep_dim)

    def reshape(self, shape):
        return trace_op("reshape2", {"X": [self]},
                        {"shape": list(shape)})["Out"][0]

    def transpose(self, perm):
        return trace_op("transpose2", {"X": [self]},
                        {"axis": list(perm)})["Out"][0]

    def __repr__(self):
        return f"VarBase({self.name}, shape={self.shape})\n{self.numpy()}"


def to_variable(value, name=None, zero_copy=None):
    if isinstance(value, VarBase):
        return value
    return VarBase(value, name=name, stop_gradient=True)


class _EagerCtx:
    """What the port's lowerings read from the static path's op context:
    the device, is_test (the guard's, or the op's attr), the attrs, the
    slot names, wants() (every output is wanted), persistable() (the
    var's flag) and a generator per op, seeded from the guard's seed and
    the op's counter."""

    def __init__(self, device, attrs, op_id, ins, outs):
        self.device = device
        self.is_test = _state["is_test"] or bool(attrs.get("is_test", False))
        self.attrs = attrs
        self.block = None
        self._op_id = op_id
        self._vars = {v.name: v for vs in ins.values() for v in vs}
        self.inputs = {s: [v.name for v in vs] for s, vs in ins.items()}
        self.outputs = {s: [v.name for v in vs]
                        for s, vs in (outs or {}).items()}

    def wants(self, slot):
        return True

    def persistable(self, name):
        v = self._vars.get(name)
        return v is not None and v.persistable

    @property
    def generator(self):
        g = torch.Generator(device=self.device)
        g.manual_seed(_mix(_state["seed"], self._op_id))
        return g

    def rand(self, shape, device=None):
        return torch.rand(shape, generator=self.generator,
                          device=device or self.device)

    def randn(self, shape, device=None):
        return torch.randn(shape, generator=self.generator,
                           device=device or self.device)


class _TracedOp:
    """One op run during a TracedLayer.trace call."""
    __slots__ = ("op_type", "attrs", "ins", "outs")

    def __init__(self, op_type, attrs, ins, outs):
        self.op_type = op_type
        self.attrs = attrs
        self.ins = ins      # {slot: [VarBase]}
        self.outs = outs    # {slot: [VarBase]}


def _operand(v, differentiable):
    """The tensor an op reads for `v`: detached where no gradient may flow
    through it. A floating var that should get a gradient and holds a
    tensor that takes none (a to_variable input whose stop_gradient was
    cleared) gets a leaf that does; a differentiable leaf enters the var
    map, so backward() finds it whatever guard it was made in."""
    t = v.value
    if t is None:
        raise ValueError(f"dygraph var {v.name!r} has no value")
    if v.stop_gradient or not differentiable:
        return t.detach() if t.requires_grad else t
    if not t.requires_grad and t.is_floating_point():
        t = v.value = t.detach().requires_grad_()
    if t.is_leaf and t.requires_grad and _state["var_map"] is not None:
        _state["var_map"][v.name] = v
    return t


def trace_op(op_type, ins: Dict[str, List[VarBase]], attrs,
             out_vars: Optional[Dict[str, List[VarBase]]] = None) -> Dict[
        str, List[VarBase]]:
    """Run one op eagerly (tracer.cc:45 TraceOp). It records under
    autograd when an input needs a gradient, gradients are on and the op
    does not update state in place; otherwise its outputs are marked
    stop_gradient. out_vars: pre-created placeholders to bind results
    into (layers.* pre-allocates its output vars)."""
    opdef = REGISTRY.get(op_type)
    _state["op_counter"] += 1
    op_id = _state["op_counter"]
    record = _state["grad"] and not opdef.inplace and any(
        not v.stop_gradient for vs in ins.values() for v in vs)
    arr_ins = {s: [_operand(v, record and s not in opdef.nondiff_inputs)
                   for v in vs] for s, vs in ins.items() if vs}
    device = next((t.device for ts in arr_ins.values() for t in ts),
                  None) or current_device()
    ctx = _EagerCtx(device, attrs, op_id, ins, out_vars)
    with torch.set_grad_enabled(record):
        arr_outs = opdef.lower(ctx, arr_ins, attrs)
    outs = {}
    for s, arrs in arr_outs.items():
        slots = (out_vars or {}).get(s, [])
        bound = []
        for i, a in enumerate(arrs):
            if a is not None and s in opdef.nondiff_outputs:
                a = a.detach()
            if i < len(slots):
                slots[i].value = a
                bound.append(slots[i])
            else:
                bound.append(VarBase(a))
        outs[s] = bound
    if not record:
        for vs in outs.values():
            for v in vs:
                v.stop_gradient = True
    capture = _state["capture"]
    if capture is not None:
        capture.append(_TracedOp(op_type, dict(attrs), ins, outs))
    return outs


def _run_backward(loss: VarBase):
    """BasicEngine::Execute (engine.h:69) on torch autograd: the live
    vars that take a gradient (trainable, not stop_gradient) retain
    theirs, backward runs from the loss with a seed of ones and keeps the
    graph, and each var's gradient is added to its `.grad`."""
    if not (_state["enabled"] and _state["grad"]):
        raise RuntimeError("backward() outside dygraph guard")
    held = {id(v): v for v in [*_state["var_map"].values(), loss]
            if v.trainable and not v.stop_gradient and v.value is not None
            and v.value.requires_grad}
    for v in held.values():
        if not v.value.is_leaf:
            v.value.retain_grad()
    if loss.value.requires_grad:
        torch.autograd.backward(loss.value, torch.ones_like(loss.value),
                                retain_graph=True)
    # a tensor's gradient is taken once, then given to each var over it
    grads = {}
    for v in held.values():
        t = v.value
        if id(t) not in grads:
            grads[id(t)] = t.grad
            t.grad = None
        g = grads[id(t)]
        if g is not None:
            v.grad = g if v.grad is None else v.grad + g


from .layers import Layer  # noqa: E402,F401
from .checkpoint import save_dygraph, load_dygraph  # noqa: E402,F401
from .nn import (Conv2D, Pool2D, FC, Linear, BatchNorm, Embedding,  # noqa: E402,F401
                 LayerNorm, Dropout, GroupNorm, PRelu, Conv3D,
                 Conv2DTranspose, Conv3DTranspose, GRUUnit, NCE,
                 BilinearTensorProduct, SpectralNorm, TreeConv)
from .parallel import DataParallel, prepare_context  # noqa: E402,F401
from .base import grad  # noqa: E402,F401
from . import jit  # noqa: E402,F401
from .jit import TracedLayer  # noqa: E402,F401
from .learning_rate_scheduler import (  # noqa: E402,F401
    LearningRateDecay, PiecewiseDecay, NaturalExpDecay, ExponentialDecay,
    InverseTimeDecay, PolynomialDecay, CosineDecay, NoamDecay)
