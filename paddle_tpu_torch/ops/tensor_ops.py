"""Tensor creation / init / random ops (randint, sampling_id and the
batch-size-like uniform too), assign, one_hot and one_hot_v2,
label_smooth, the embedding lookups, multiplex, shard_index, and the
small index and check ops (reverse, diag, eye, linspace, isfinite,
has_inf, has_nan, is_empty, where_index).

Random ops draw from the op's own generator (core/lowering.py), seeded
from the program seed with the step and the op id folded in, so runs are
reproducible. The draws differ from the JAX package's: the two
frameworks' generators give different numbers from the same seed.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dtypes import as_np_dtype, as_torch_dtype
from ..core.registry import register_op


def _shape_attr(attrs, key="shape"):
    return tuple(int(s) for s in attrs[key])


@register_op("fill_constant", nondiff_outputs=("Out",))
def _fill_constant(ctx, ins, attrs):
    dtype = as_torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(_shape_attr(attrs), attrs.get("value", 0.0),
                               dtype=dtype, device=ctx.device)]}


@register_op("fill_constant_batch_size_like", nondiff_inputs=("Input",),
             nondiff_outputs=("Out",))
def _fill_constant_bsl(ctx, ins, attrs):
    # the attr shape with one dim taken from Input's batch dim
    ref = ins["Input"][0]
    shape = list(_shape_attr(attrs))
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    dtype = as_torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": [torch.full(shape, attrs.get("value", 0.0),
                               dtype=dtype, device=ref.device)]}


@register_op("fill_zeros_like", nondiff_inputs=("X",),
             nondiff_outputs=("Out",))
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


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


# Φ(-2): the truncated normal's draws are the standard normal quantiles
# of uniform draws on (Φ(-2), Φ(2)), so every value lies in [-2, 2]
_PHI_M2 = 0.5 * math.erfc(2.0 / math.sqrt(2.0))


def truncated_normal(u):
    """A standard normal truncated to [-2, 2] from uniform [0, 1) draws
    `u` (float32), by the inverse CDF."""
    z = torch.special.ndtri(_PHI_M2 + (1.0 - 2.0 * _PHI_M2) * u.double())
    return torch.clamp(z, -2.0, 2.0).float()


@register_op("truncated_gaussian_random", stateful=True,
             nondiff_outputs=("Out",))
def _truncated_gaussian(ctx, ins, attrs):
    """mean + std * a standard normal truncated to [-2, 2], one uniform
    draw a value."""
    dtype = as_torch_dtype(attrs.get("dtype", "float32"))
    z = truncated_normal(ctx.rand(_shape_attr(attrs)))
    out = z * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": [out.to(dtype)]}


@register_op("assign_value", nondiff_outputs=("Out",))
def _assign_value(ctx, ins, attrs):
    # `values` is the array (or a list), cast to `dtype` on the host
    dtype = attrs.get("dtype", "float32")
    arr = np.asarray(attrs.get("values"), dtype=as_np_dtype(dtype))
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return {"Out": [t.to(ctx.device).to(as_torch_dtype(dtype))
                    .reshape(_shape_attr(attrs))]}


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


@register_op("linspace", nondiff_outputs=("Out",))
def _linspace(ctx, ins, attrs):
    """`num` points from Start to Stop, both ends included, in float32
    for integer ends; computed as jnp.linspace does: Start * (1 - i/(n-1))
    + Stop * i/(n-1) for i < n-1, then Stop."""
    s = ins["Start"][0].reshape(())
    e = ins["Stop"][0].reshape(())
    n = int(attrs["num"]) if "num" in attrs else int(ins["Num"][0])
    dtype = s.dtype if s.is_floating_point() else torch.float32
    s, e = s.to(dtype), e.to(dtype)
    if n <= 1:
        return {"Out": [s.reshape(1)[:n]]}
    step = torch.arange(n - 1, dtype=dtype, device=s.device) / (n - 1)
    out = s * (1 - step) + e * step
    return {"Out": [torch.cat([out, e.reshape(1)])]}


@register_op("eye", nondiff_outputs=("Out",))
def _eye(ctx, ins, attrs):
    n = int(attrs["num_rows"])
    m = int(attrs.get("num_columns", -1))
    return {"Out": [torch.eye(n, n if m < 0 else m, device=ctx.device,
                              dtype=as_torch_dtype(
                                  attrs.get("dtype", "float32")))]}


@register_op("diag")
def _diag(ctx, ins, attrs):
    # a vector becomes the diagonal of a square matrix
    return {"Out": [torch.diag(ins["Diagonal"][0])]}


@register_op("reverse")
def _reverse(ctx, ins, attrs):
    return {"Out": [torch.flip(ins["X"][0], dims=tuple(attrs["axis"]))]}


@register_op("isfinite", nondiff_outputs=("Out",))
def _isfinite(ctx, ins, attrs):
    # one bool: every element finite
    return {"Out": [torch.all(torch.isfinite(ins["X"][0]))]}


@register_op("has_inf", nondiff_outputs=("Out",))
def _has_inf(ctx, ins, attrs):
    return {"Out": [torch.any(torch.isinf(ins["X"][0]))]}


@register_op("has_nan", nondiff_outputs=("Out",))
def _has_nan(ctx, ins, attrs):
    return {"Out": [torch.any(torch.isnan(ins["X"][0]))]}


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


@register_op("uniform_random_batch_size_like", stateful=True,
             nondiff_inputs=("Input",), nondiff_outputs=("Out",))
def _uniform_random_bsl(ctx, ins, attrs):
    ref = ins["Input"][0]
    shape = list(_shape_attr(attrs))
    shape[attrs.get("output_dim_idx", 0)] = \
        ref.shape[attrs.get("input_dim_idx", 0)]
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = ctx.rand(shape, device=ref.device) * (hi - lo) + lo
    return {"Out": [out.to(as_torch_dtype(attrs.get("dtype", "float32")))]}


@register_op("randint", stateful=True, nondiff_outputs=("Out",))
def _randint(ctx, ins, attrs):
    """Integers uniform on [low, high)."""
    shape = _shape_attr(attrs)
    dtype = as_torch_dtype(attrs.get("dtype", "int64"))
    if ctx.device.type == "meta":
        return {"Out": [torch.empty(shape, dtype=dtype, device="meta")]}
    return {"Out": [torch.randint(
        attrs.get("low", 0), attrs.get("high", 100), shape,
        generator=ctx.generator, device=ctx.device, dtype=dtype)]}


@register_op("sampling_id", stateful=True, nondiff_outputs=("Out",))
def _sampling_id(ctx, ins, attrs):
    """One index a row of X [batch, n], drawn with probability
    proportional to X + 1e-20 (the JAX lowering's categorical over
    log(X + 1e-20))."""
    x = ins["X"][0]
    if x.device.type == "meta":
        return {"Out": [torch.empty(x.shape[0], dtype=torch.int64,
                                    device="meta")]}
    return {"Out": [torch.multinomial(x.float() + 1e-20, 1,
                                      generator=ctx.generator)
                    .reshape(-1)]}


@register_op("one_hot_v2", nondiff_inputs=("X",), nondiff_outputs=("Out",))
def _one_hot_v2(ctx, ins, attrs):
    # every dim of X kept; an index outside [0, depth) gives zeros
    x = ins["X"][0]
    depth = torch.arange(int(attrs["depth"]), device=x.device)
    return {"Out": [(x[..., None] == depth).to(torch.float32)]}


@register_op("is_empty", nondiff_outputs=("Out",))
def _is_empty(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.tensor(x.numel() == 0, device=x.device)]}


@register_op("where_index", nondiff_outputs=("Out",))
def _where_index(ctx, ins, attrs):
    """The `where` op of misc_ops on Condition (or X)."""
    from .misc_ops import where_rows
    cond = ins.get("Condition", ins.get("X"))[0]
    return {"Out": [where_rows(cond)]}


@register_op("multiplex", nondiff_inputs=("Ids",))
def _multiplex(ctx, ins, attrs):
    """Row i of Out is row i of X[Ids[i]]."""
    ids = ins["Ids"][0].reshape(-1).long()
    stacked = torch.stack(ins["X"], dim=0)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return {"Out": [stacked[ids, rows]]}


@register_op("shard_index", nondiff_inputs=("X",), nondiff_outputs=("Out",))
def _shard_index(ctx, ins, attrs):
    """X % shard_size where X lies in shard `shard_id`, else
    ignore_value; shards of ceil(index_num / nshards) ids."""
    x = ins["X"][0]
    size = (attrs["index_num"] + attrs["nshards"] - 1) // attrs["nshards"]
    in_shard = torch.div(x, size, rounding_mode="floor") == attrs["shard_id"]
    return {"Out": [torch.where(in_shard, torch.remainder(x, size),
                                attrs.get("ignore_value", -1))]}
