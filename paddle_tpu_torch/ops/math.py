"""Core math / tensor-manipulation ops: mul, matmul, matmul_v2, scale,
sum, mean, cast, concat, gather, slice, top_k, argsort, arg_max, arg_min,
the shape ops (reshape, transpose, squeeze, unsqueeze, flatten, their
XShape forms, split, stack, unstack, expand, expand_as, strided_slice,
pad, pad2d, shape, size), the scatters and gathers, cumsum, the norms
(l2_normalize, norm, cos_sim), bilinear_tensor_product, and the
gradient clips' clip, clip_by_norm and squared_l2_norm.

The large products in `mul` and `matmul` stay `torch.matmul` (cuBLAS on
the card), as the JAX package leaves them to XLA. Float32 products are
exact: the package turns TF32 off when it is imported (see __init__.py).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

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


def _reshape_to(x, a):
    return torch.reshape(x, [int(s) for s in a.get("shape", [])])


def _squeeze_axes(x, a):
    """jnp.squeeze: the listed axes (each of size 1, else ValueError), or
    every size-1 axis when none is listed."""
    axes = a.get("axes")
    if not axes:
        return torch.squeeze(x)
    dims = tuple(sorted({int(d) % x.dim() for d in axes}))
    for d in dims:
        if x.shape[d] != 1:
            raise ValueError(f"squeeze: axis {d} has size {x.shape[d]}, "
                             f"not 1")
    return torch.squeeze(x, dims)


def _unsqueeze_axes(x, a):
    for ax in sorted(a.get("axes", [])):
        x = torch.unsqueeze(x, ax)
    return x


def _flatten_at(x, a):
    ax = a.get("axis", 1)
    return x.reshape(math.prod(x.shape[:ax]), -1)


def _permute(x, a):
    return x.permute(*a.get("axis"))


_with_xshape("reshape2", _reshape_to)
_with_xshape("transpose2", _permute)
_with_xshape("squeeze2", _squeeze_axes)
_with_xshape("unsqueeze2", _unsqueeze_axes)
_with_xshape("flatten2", _flatten_at)


def _plain(name, fn):
    """The XShape-less form of a shape op."""
    @register_op(name)
    def _low(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0], attrs)]}
    return _low


_plain("reshape", _reshape_to)
_plain("transpose", _permute)
_plain("squeeze", _squeeze_axes)
_plain("unsqueeze", _unsqueeze_axes)
_plain("flatten", _flatten_at)


@register_op("arg_max", nondiff_outputs=("Out",))
def _arg_max(ctx, ins, attrs):
    # the first of tied maxima, as jnp.argmax
    return {"Out": [torch.argmax(ins["X"][0], dim=attrs.get("axis", -1))]}


@register_op("arg_min", nondiff_outputs=("Out",))
def _arg_min(ctx, ins, attrs):
    return {"Out": [torch.argmin(ins["X"][0], dim=attrs.get("axis", -1))]}


@register_op("shape", nondiff_outputs=("Out",))
def _shape(ctx, ins, attrs):
    x = ins["Input"][0]
    return {"Out": [torch.tensor(list(x.shape), dtype=torch.int32,
                                 device=x.device)]}


@register_op("size", nondiff_outputs=("Out",))
def _size(ctx, ins, attrs):
    x = ins["Input"][0]
    return {"Out": [torch.tensor(x.numel(), dtype=torch.int64,
                                 device=x.device)]}


@register_op("split")
def _split(ctx, ins, attrs):
    """Into `sections` along `axis`, or `num` equal parts (jnp.split:
    a size that does not divide raises)."""
    x = ins["X"][0]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections") or []
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    num = attrs.get("num", 0) or 1
    if x.shape[axis] % num:
        raise ValueError(f"split: axis {axis} of size {x.shape[axis]} "
                         f"does not divide into {num} equal parts")
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}


@register_op("stack")
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(ins["X"], dim=attrs.get("axis", 0))]}


@register_op("unstack")
def _unstack(ctx, ins, attrs):
    return {"Y": list(torch.unbind(ins["X"][0], dim=attrs.get("axis", 0)))}


@register_op("strided_slice")
def _strided_slice(ctx, ins, attrs):
    """x[start:end:stride] on each listed axis by Python's slice rules,
    as an index gather (torch slices step forward only)."""
    x = ins["Input"][0]
    for ax, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                            attrs["strides"]):
        rows = range(*slice(s, e, st).indices(x.shape[ax]))
        x = torch.index_select(x, ax, torch.tensor(
            list(rows), dtype=torch.long, device=x.device))
    return {"Out": [x]}


@register_op("expand")
def _expand(ctx, ins, attrs):
    return {"Out": [torch.tile(ins["X"][0], tuple(attrs["expand_times"]))]}


@register_op("expand_as")
def _expand_as(ctx, ins, attrs):
    x, tgt = ins["X"][0], ins["target_tensor"][0]
    times = [t // s for t, s in zip(tgt.shape, x.shape)]
    return {"Out": [torch.tile(x, tuple(times))]}


def _index_tuple(idx):
    # [..., k] int indices -> k index tensors over the leading dims
    return tuple(torch.unbind(idx.long(), dim=-1))


@register_op("gather_nd", nondiff_inputs=("Index",))
def _gather_nd(ctx, ins, attrs):
    x, idx = ins["X"][0], ins["Index"][0]
    return {"Out": [x[_index_tuple(idx)]]}


@register_op("scatter", nondiff_inputs=("Ids",))
def _scatter(ctx, ins, attrs):
    """Rows `Ids` of X set to Updates (`overwrite`), or Updates added to
    them."""
    x, ids, upd = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    return {"Out": [x.index_put((ids.reshape(-1).long(),), upd,
                                accumulate=not attrs.get("overwrite",
                                                         True))]}


@register_op("scatter_nd_add", nondiff_inputs=("Index",))
def _scatter_nd_add(ctx, ins, attrs):
    x, idx, upd = ins["X"][0], ins["Index"][0], ins["Updates"][0]
    return {"Out": [x.index_put(_index_tuple(idx), upd, accumulate=True)]}


@register_op("cumsum")
def _cumsum(ctx, ins, attrs):
    """The running sum along `axis` (of the flattened X with `flatten`),
    from the end with `reverse`; `exclusive` subtracts X, as the JAX
    lowering does."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x, axis = x.reshape(-1), 0
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis),
                         (axis,))
    else:
        out = torch.cumsum(x, dim=axis)
    if attrs.get("exclusive", False):
        out = out - x
    return {"Out": [out]}


@register_op("argsort", nondiff_outputs=("Indices",))
def _argsort(ctx, ins, attrs):
    """A stable ascending sort; `descending` reverses it, so equal values
    come out in reverse index order, as the JAX lowering flips its
    stable sort (torch's stable descending sort keeps index order)."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    idx = torch.argsort(x, dim=axis, stable=True)
    if attrs.get("descending", False):
        idx = torch.flip(idx, (axis,))
    return {"Out": [torch.take_along_dim(x, idx, dim=axis)],
            "Indices": [idx]}


def _normalize(ctx, ins, attrs, eps_default):
    x = ins["X"][0]
    eps = attrs.get("epsilon", eps_default)
    norm = torch.sqrt(torch.sum(torch.square(x), dim=attrs.get("axis", -1),
                                keepdim=True) + eps)
    return {"Out": [x / norm], "Norm": [norm]}


@register_op("l2_normalize")
def _l2_normalize(ctx, ins, attrs):
    return _normalize(ctx, ins, attrs, 1e-12)


@register_op("norm")
def _norm(ctx, ins, attrs):
    return _normalize(ctx, ins, attrs, 1e-10)


def _torch_pads(pairs):
    # [(before, after)] per dim, first dim first -> F.pad's last-dim-first
    return [p for pair in reversed(pairs) for p in pair]


@register_op("pad")
def _pad(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs["paddings"]
    pairs = [(p[2 * i], p[2 * i + 1]) for i in range(x.dim())]
    return {"Out": [F.pad(x, _torch_pads(pairs),
                          value=attrs.get("pad_value", 0.0))]}


@register_op("pad2d")
def _pad2d(ctx, ins, attrs):
    """`paddings` [top, bottom, left, right] of the spatial axes, NCHW or
    NHWC; `mode` constant, reflect (the edge not repeated) or edge."""
    x = ins["X"][0]
    top, bottom, left, right = attrs["paddings"]
    mode = attrs.get("mode", "constant")
    nhwc = attrs.get("data_format", "NCHW") != "NCHW"
    if nhwc:
        x = x.movedim(-1, 1)
    pads = (left, right, top, bottom)
    if mode == "constant":
        out = F.pad(x, pads, value=attrs.get("pad_value", 0.0))
    else:
        out = F.pad(x, pads, mode={"reflect": "reflect",
                                   "edge": "replicate"}[mode])
    return {"Out": [out.movedim(1, -1) if nhwc else out]}


@register_op("cos_sim")
def _cos_sim(ctx, ins, attrs):
    """Cosine similarity of the rows of X and Y (Y may be one row), with
    the rows' norms."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(x * x, -1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, -1, keepdim=True))
    out = torch.sum(x * y, -1, keepdim=True) / (xn * yn)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}


@register_op("matmul_v2")
def _matmul_v2(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if attrs.get("trans_x", False):
        x = x.transpose(-1, -2)
    if attrs.get("trans_y", False):
        y = y.transpose(-1, -2)
    return {"Out": [torch.matmul(x, y).to(x.dtype)]}
