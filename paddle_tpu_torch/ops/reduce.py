"""Reduce ops: reduce_sum, reduce_mean, reduce_max, reduce_min,
reduce_prod, reduce_all and reduce_any.

reduce_max and reduce_min take torch.amax and torch.amin, whose
gradients split evenly among tied elements, as jax's do (torch.max with
a dim would give all of it to one). torch.prod takes one dim, so
reduce_prod reduces one axis at a time, the last first."""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _prod(x, dim, keepdim):
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce(name, fn, nondiff=False):
    kw = {"nondiff_outputs": ("Out",)} if nondiff else {}

    @register_op(name, **kw)
    def _low(ctx, ins, attrs, _fn=fn):
        x = ins["X"][0]
        dims = attrs.get("dim", [0])
        if attrs.get("reduce_all", False) or not dims:
            dims = range(x.dim())
        dims = tuple(sorted({d % x.dim() for d in dims}))
        return {"Out": [_fn(x, dim=dims,
                            keepdim=attrs.get("keep_dim", False))]}
    return _low


_reduce("reduce_sum", torch.sum)
_reduce("reduce_mean", torch.mean)
_reduce("reduce_max", torch.amax)
_reduce("reduce_min", torch.amin)
_reduce("reduce_prod", _prod)
_reduce("reduce_any", torch.any, nondiff=True)
_reduce("reduce_all", torch.all, nondiff=True)
