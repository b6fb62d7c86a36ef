"""Elementwise binary ops, minus, and the comparisons and logical ops
with fluid's axis-broadcast semantics: Y's dims align to X starting at
`axis` (default -1 = numpy-style trailing alignment)."""
from __future__ import annotations

import torch

from ..core.registry import register_op


def broadcast_y(x, y, axis):
    if x.dim() == y.dim() or y.dim() == 0:
        return y
    axis = x.dim() - y.dim() if axis in (-1, None) else int(axis)
    new_shape = (1,) * axis + tuple(y.shape) + \
        (1,) * (x.dim() - axis - y.dim())
    return y.reshape(new_shape)


def _binary(name, fn):
    @register_op(name)
    def _low(ctx, ins, attrs, _fn=fn):
        x, y = ins["X"][0], ins["Y"][0]
        out = _fn(x, broadcast_y(x, y, attrs.get("axis", -1)))
        scale = attrs.get("scale", None)  # fused scale of the transpiler
        if scale is not None:
            out = out * scale
        return {"Out": [out]}
    return _low


# elementwise_mod and elementwise_floordiv round toward -inf, as
# jnp.mod and jnp.floor_divide do; elementwise_div of integers is true
# division, as jnp.divide is
_binary("elementwise_add", torch.add)
_binary("elementwise_sub", torch.sub)
_binary("elementwise_mul", torch.mul)
_binary("elementwise_div", torch.div)
_binary("elementwise_max", torch.maximum)
_binary("elementwise_min", torch.minimum)
_binary("elementwise_pow", torch.pow)
_binary("elementwise_mod", torch.remainder)
_binary("elementwise_floordiv", torch.floor_divide)


def _compare(name, fn):
    @register_op(name, nondiff_outputs=("Out",))
    def _low(ctx, ins, attrs, _fn=fn):
        x, y = ins["X"][0], ins["Y"][0]
        return {"Out": [_fn(x, broadcast_y(x, y, attrs.get("axis", -1)))]}
    return _low


@register_op("minus")
def _minus(ctx, ins, attrs):
    return {"Out": [ins["X"][0] - ins["Y"][0]]}


_compare("less_than", torch.lt)
_compare("less_equal", torch.le)
_compare("greater_than", torch.gt)
_compare("greater_equal", torch.ge)
_compare("equal", torch.eq)
_compare("not_equal", torch.ne)
_compare("logical_and", torch.logical_and)
_compare("logical_or", torch.logical_or)
_compare("logical_xor", torch.logical_xor)
