"""Reduce ops: reduce_mean."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("reduce_mean")
def _reduce_mean(ctx, ins, attrs):
    x = ins["X"][0]
    dims = attrs.get("dim", [0])
    if attrs.get("reduce_all", False) or not dims:
        dims = range(x.dim())
    dims = tuple(sorted({d % x.dim() for d in dims}))
    return {"Out": [torch.mean(x, dim=dims,
                               keepdim=attrs.get("keep_dim", False))]}
