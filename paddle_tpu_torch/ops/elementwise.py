"""Elementwise binary ops and comparisons with fluid's axis-broadcast
semantics: Y's dims align to X starting at `axis` (default -1 =
numpy-style trailing alignment)."""
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


_binary("elementwise_add", torch.add)
_binary("elementwise_mul", torch.mul)


@register_op("less_equal", nondiff_outputs=("Out",))
def _less_equal(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [torch.le(x, broadcast_y(x, y, attrs.get("axis", -1)))]}
