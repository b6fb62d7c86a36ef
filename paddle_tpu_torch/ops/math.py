"""Core math / tensor-manipulation ops: mul, matmul, scale, sum, mean,
cast, concat, gather, slice, top_k, arg_max, arg_min, reshape2, transpose2,
bilinear_tensor_product, and the gradient clips' clip, clip_by_norm and
squared_l2_norm.

The large products in `mul` and `matmul` stay `torch.matmul` (cuBLAS on
the card), as the JAX package leaves them to XLA. Float32 products are
exact: the package turns TF32 off when it is imported (see __init__.py).
"""
from __future__ import annotations

import math

import torch

from ..core.dtypes import as_torch_dtype
from ..core.registry import register_op


@register_op("mul")
def _mul(ctx, ins, attrs):
    # mul = 2D matmul after flattening X to [prod(lead), rest] and Y to
    # [prod(y lead), rest]
    x, y = ins["X"][0], ins["Y"][0]
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    x2 = x.reshape(math.prod(x.shape[:xnc]), -1)
    y2 = y.reshape(math.prod(y.shape[:ync]), -1)
    out = torch.matmul(x2, y2).to(x.dtype)
    return {"Out": [out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:]))]}


@register_op("matmul")
def _matmul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y).to(x.dtype)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": [out]}


@register_op("scale")
def _scale(ctx, ins, attrs):
    x = ins["X"][0]
    s, b = attrs.get("scale", 1.0), attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": [x * s + b]}
    return {"Out": [(x + b) * s]}


@register_op("sum")
def _sum(ctx, ins, attrs):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


@register_op("mean")
def _mean(ctx, ins, attrs):
    return {"Out": [torch.mean(ins["X"][0])]}


@register_op("cast")
def _cast(ctx, ins, attrs):
    return {"Out": [ins["X"][0].to(as_torch_dtype(attrs["out_dtype"]))]}


@register_op("concat")
def _concat(ctx, ins, attrs):
    """Mixed input dtypes promote as jnp.concatenate promotes them."""
    return {"Out": [torch.cat(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("gather", nondiff_inputs=("Index",))
def _gather(ctx, ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0]
    return {"Out": [torch.index_select(x, 0, idx.reshape(-1).long())]}


@register_op("slice")
def _slice(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for ax, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[ax]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[ax] = slice(s, e)
    out = x[tuple(idx)]
    if attrs.get("decrease_axis"):
        out = out.squeeze(tuple(attrs["decrease_axis"]))
    return {"Out": [out]}


@register_op("top_k", nondiff_outputs=("Indices",))
def _top_k(ctx, ins, attrs):
    """The k largest along the last axis, largest first. A stable sort
    keeps the lower index first among equal values, as jax.lax.top_k
    does; torch.topk promises no order among ties."""
    k = attrs.get("k", 1)
    vals, idx = torch.sort(ins["X"][0], dim=-1, descending=True,
                           stable=True)
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}


@register_op("clip")
def _clip(ctx, ins, attrs):
    return {"Out": [torch.clamp(ins["X"][0], attrs["min"], attrs["max"])]}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    # X * (max_norm / ||X||) where the norm exceeds max_norm, else X
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return {"Out": [torch.where(norm > max_norm, x * (max_norm / norm), x)]}


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    return {"Out": [torch.sum(torch.square(ins["X"][0])).reshape(1)]}


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs):
    """Out[b, o] = X[b] · Weight[o] · Y[b] (+ Bias [1, O])."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]
    out = torch.einsum("bi,oij,bj->bo", x, w, y)
    if "Bias" in ins:
        out = out + ins["Bias"][0]
    return {"Out": [out]}


def _with_xshape(name, fn):
    """reshape2/transpose2 also output an XShape var (the reference's
    grad-path bookkeeping): an empty [0, *x.shape] tensor."""
    @register_op(name, nondiff_outputs=("XShape",))
    def _low(ctx, ins, attrs, _fn=fn):
        x = ins["X"][0]
        return {"Out": [_fn(x, attrs)],
                "XShape": [x.new_zeros((0,) + tuple(x.shape))]}
    return _low


_with_xshape("reshape2", lambda x, a: torch.reshape(
    x, [int(s) for s in a.get("shape", [])]))
_with_xshape("transpose2", lambda x, a: x.permute(*a.get("axis")))


@register_op("arg_max", nondiff_outputs=("Out",))
def _arg_max(ctx, ins, attrs):
    # the first of tied maxima, as jnp.argmax
    return {"Out": [torch.argmax(ins["X"][0], dim=attrs.get("axis", -1))]}


@register_op("arg_min", nondiff_outputs=("Out",))
def _arg_min(ctx, ins, attrs):
    return {"Out": [torch.argmin(ins["X"][0], dim=attrs.get("axis", -1))]}
