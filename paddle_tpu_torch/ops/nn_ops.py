"""Softmax, normalisation, dropout and position-encoding ops."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))]}


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    bna = attrs.get("begin_norm_axis", 1)
    red = tuple(range(bna, x.dim()))
    v, m = torch.var_mean(x, dim=red, keepdim=True, correction=0)
    y = (x - m) * torch.rsqrt(v + eps)
    norm_shape = tuple(x.shape[bna:])
    if "Scale" in ins:
        y = y * ins["Scale"][0].reshape(norm_shape)
    if "Bias" in ins:
        y = y + ins["Bias"][0].reshape(norm_shape)
    lead = tuple(x.shape[:bna])
    return {"Y": [y], "Mean": [m.reshape(lead)],
            "Variance": [v.reshape(lead)]}


@register_op("dropout", stateful=True, nondiff_outputs=("Mask",))
def _dropout(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if ctx.is_test or attrs.get("is_test", False):
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": [out],
                "Mask": [torch.ones(x.shape, dtype=torch.uint8,
                                    device=x.device)]}
    keep = ctx.rand(x.shape, device=x.device) < (1.0 - p)
    zero = x.new_zeros(())
    if impl == "upscale_in_train":
        out = torch.where(keep, x / (1.0 - p), zero)
    else:
        out = torch.where(keep, x, zero)
    return {"Out": [out.to(x.dtype)], "Mask": [keep.to(torch.uint8)]}


@register_op("add_position_encoding")
def _add_position_encoding(ctx, ins, attrs):
    x = ins["X"][0]  # [B, T, D]
    alpha = attrs.get("alpha", 1.0)
    beta = attrs.get("beta", 1.0)
    _, t, d = x.shape
    pos = torch.arange(t, dtype=x.dtype, device=x.device)[:, None]
    i = torch.arange(d // 2, dtype=x.dtype, device=x.device)[None, :]
    angle = pos / torch.pow(10000.0, 2 * i / d)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    return {"Out": [alpha * x + beta * pe[None]]}
