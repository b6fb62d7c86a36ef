"""Tensor creation / init / random ops and the embedding lookup.

Random ops draw from the op's own generator (core/lowering.py), seeded
from the program seed with the step and the op id folded in, so runs are
reproducible. The draws differ from the JAX package's: the two
frameworks' generators give different numbers from the same seed.
"""
from __future__ import annotations

import torch

from ..core.dtypes import as_torch_dtype
from ..core.registry import register_op


def _shape_attr(attrs, key="shape"):
    return tuple(int(s) for s in attrs[key])


@register_op("fill_constant", nondiff_outputs=("Out",))
def _fill_constant(ctx, ins, attrs):
    dtype = as_torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(_shape_attr(attrs), attrs.get("value", 0.0),
                               dtype=dtype, device=ctx.device)]}


@register_op("fill_any_like", nondiff_inputs=("X",), nondiff_outputs=("Out",))
def _fill_any_like(ctx, ins, attrs):
    x = ins["X"][0]
    dtype = attrs.get("dtype")
    dtype = x.dtype if dtype in (None, -1) else as_torch_dtype(dtype)
    return {"Out": [torch.full(x.shape, attrs.get("value", 0.0),
                               dtype=dtype, device=x.device)]}


@register_op("gaussian_random", stateful=True, nondiff_outputs=("Out",))
def _gaussian_random(ctx, ins, attrs):
    dtype = as_torch_dtype(attrs.get("dtype", "float32"))
    out = (ctx.randn(_shape_attr(attrs)) * attrs.get("std", 1.0)
           + attrs.get("mean", 0.0))
    return {"Out": [out.to(dtype)]}


@register_op("uniform_random", stateful=True, nondiff_outputs=("Out",))
def _uniform_random(ctx, ins, attrs):
    dtype = as_torch_dtype(attrs.get("dtype", "float32"))
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = ctx.rand(_shape_attr(attrs)) * (hi - lo) + lo
    return {"Out": [out.to(dtype)]}


@register_op("lookup_table_v2", nondiff_inputs=("Ids",))
def _lookup_table_v2(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    flat = ids.reshape(-1).long()
    out = torch.index_select(w, 0, flat)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx != -1:
        pad = padding_idx % w.shape[0]
        out = torch.where((flat == pad)[:, None], out.new_zeros(()), out)
    return {"Out": [out.reshape(tuple(ids.shape) + (w.shape[-1],))]}
