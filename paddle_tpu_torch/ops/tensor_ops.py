"""Tensor creation / init / random ops, assign, one_hot, label_smooth
and the embedding lookups.

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


@register_op("assign")
def _assign(ctx, ins, attrs):
    # Out = X. The optimizers update persistables in place, so Out gets a
    # copy of a persistable X (Lookahead's slow weights, assigned from
    # the parameters in the startup program), else a later update of X
    # would reach Out
    x = ins["X"][0]
    src = ctx.inputs.get("X", [""])[0]
    if src not in ctx.outputs.get("Out", ()) and ctx.persistable(src):
        x = x.clone()
    return {"Out": [x]}


@register_op("increment")
def _increment(ctx, ins, attrs):
    # Out = X + step in X's own dtype (an int64 step counter stays int64)
    x = ins["X"][0]
    step = attrs.get("step", 1.0)
    return {"Out": [x + (step if x.is_floating_point() else int(step))]}


@register_op("range", nondiff_outputs=("Out",))
def _range(ctx, ins, attrs):
    s = ins["Start"][0].reshape(())
    st = ins["Step"][0].reshape(())
    n = attrs.get("static_len")
    if n is None:
        raise NotImplementedError(
            "range requires the static_len attr (a static output shape)")
    return {"Out": [s + torch.arange(n, dtype=s.dtype, device=s.device)
                    * st]}


@register_op("one_hot", nondiff_inputs=("X",), nondiff_outputs=("Out",))
def _one_hot(ctx, ins, attrs):
    # a trailing dim of 1 is squeezed; an index outside [0, depth) gives
    # a row of zeros
    x = ins["X"][0]
    if x.dim() and x.shape[-1] == 1:
        x = x.reshape(x.shape[:-1])
    depth = torch.arange(int(attrs["depth"]), device=x.device)
    return {"Out": [(x[..., None] == depth).to(torch.float32)]}


@register_op("label_smooth")
def _label_smooth(ctx, ins, attrs):
    """(1 - eps) * X + eps * PriorDist, or + eps / C without a prior."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    if "PriorDist" in ins:
        return {"Out": [(1 - eps) * x + eps * ins["PriorDist"][0]]}
    return {"Out": [(1 - eps) * x + eps / x.shape[-1]]}


def _lookup(w, ids, attrs, out_lead):
    flat = ids.reshape(-1).long()
    out = torch.index_select(w, 0, flat)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx != -1:
        pad = padding_idx % w.shape[0]
        out = torch.where((flat == pad)[:, None], out.new_zeros(()), out)
    return {"Out": [out.reshape(tuple(out_lead) + (w.shape[-1],))]}


@register_op("lookup_table", nondiff_inputs=("Ids",))
def _lookup_table(ctx, ins, attrs):
    # ids [..., 1] -> out [..., d]: the trailing 1 is squeezed
    w, ids = ins["W"][0], ins["Ids"][0]
    lead = ids.shape[:-1] if ids.dim() and ids.shape[-1] == 1 else ids.shape
    return _lookup(w, ids, attrs, lead)


@register_op("lookup_table_v2", nondiff_inputs=("Ids",))
def _lookup_table_v2(ctx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    return _lookup(w, ids, attrs, ids.shape)
