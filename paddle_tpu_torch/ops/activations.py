"""Activation and unary math ops: gelu, relu, tanh, sigmoid, and the
unaries the LR schedules, the gradient clips and the regularizers reach
(exp, abs, ceil, floor, cos, reciprocal, square, sqrt, pow, sign). As in
the JAX registry, none marks a slot non-differentiable: floor, ceil and
sign have zero gradients by autograd's own rules."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


@register_op("gelu")
def _gelu(ctx, ins, attrs):
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [F.gelu(ins["X"][0], approximate=approximate)]}


@register_op("relu")
def _relu(ctx, ins, attrs):
    return {"Out": [torch.relu(ins["X"][0])]}


@register_op("tanh")
def _tanh(ctx, ins, attrs):
    return {"Out": [torch.tanh(ins["X"][0])]}


@register_op("sigmoid")
def _sigmoid(ctx, ins, attrs):
    return {"Out": [torch.sigmoid(ins["X"][0])]}


def _unary(name, fn):
    @register_op(name)
    def _low(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0], attrs)]}
    return _low


_unary("exp", lambda x, a: torch.exp(x))
_unary("abs", lambda x, a: torch.abs(x))
_unary("ceil", lambda x, a: torch.ceil(x))
_unary("floor", lambda x, a: torch.floor(x))
_unary("cos", lambda x, a: torch.cos(x))
_unary("reciprocal", lambda x, a: 1.0 / x)
_unary("square", lambda x, a: torch.square(x))
_unary("sqrt", lambda x, a: torch.sqrt(x))
_unary("pow", lambda x, a: torch.pow(x, a.get("factor", 1.0)))
_unary("sign", lambda x, a: torch.sign(x))
