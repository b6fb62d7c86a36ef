"""Elementwise binary ops with fluid's axis-broadcast semantics: Y's
dims align to X starting at `axis` (default -1 = numpy-style trailing
alignment)."""
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


@register_op("elementwise_add")
def _elementwise_add(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    out = torch.add(x, broadcast_y(x, y, attrs.get("axis", -1)))
    scale = attrs.get("scale", None)  # fused scale used by the transpiler
    if scale is not None:
        out = out * scale
    return {"Out": [out]}
