"""Softmax and log_softmax, convolution, pooling, resizing,
normalisation (batch, layer, group, instance, data, lrn), dropout, the
activations with parameters (prelu, selu), the channel rearrangements
(pixel_shuffle, space_to_depth, temporal_shift, shuffle_channel,
affine_channel), unfold and position encoding.

The JAX package leaves conv2d, conv3d, conv2d_transpose, pool2d and
batch_norm to XLA, so here they are torch's library calls: cuDNN's
convolutions, and torch's pooling and batch normalisation, on the card.
Each keeps the reference's semantics where those differ from torch's
defaults (4-entry paddings, pool2d's floored output size, batch_norm's
running statistics). The resizes are written as the reference's
gathers, in plain torch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": [torch.softmax(ins["X"][0], dim=attrs.get("axis", -1))]}


@register_op("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return {"Out": [torch.log_softmax(ins["X"][0],
                                      dim=attrs.get("axis", -1))]}


def _conv2d(x, w, attrs, groups):
    """NCHW input (AnyLayout reads as NCHW) and OIHW filter. `paddings` is
    [h, w] or [top, bottom, left, right]; uneven pads are applied by
    F.pad, as F.conv2d pads symmetrically only. The output keeps the
    input's dtype."""
    fmt = attrs.get("data_format", "NCHW")
    if fmt not in ("NCHW", "AnyLayout", "ANYLAYOUT"):
        # the layers write no data_format; NHWC programs are not ported
        raise NotImplementedError(f"conv2d data_format {fmt!r}")
    pads = list(attrs.get("paddings", [0, 0]))
    if len(pads) == 4:
        top, bottom, left, right = pads
        if (top, left) != (bottom, right):
            x = F.pad(x, (left, right, top, bottom))
            top = left = 0
        pads = [top, left]
    return F.conv2d(x, w, stride=tuple(attrs.get("strides", [1, 1])),
                    padding=tuple(pads),
                    dilation=tuple(attrs.get("dilations", [1, 1])),
                    groups=groups).to(x.dtype)


@register_op("conv2d")
def _conv2d_op(ctx, ins, attrs):
    return {"Output": [_conv2d(ins["Input"][0], ins["Filter"][0], attrs,
                               attrs.get("groups", 1))]}


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ctx, ins, attrs):
    """conv2d with one group a channel, whatever `groups` says."""
    x = ins["Input"][0]
    return {"Output": [_conv2d(x, ins["Filter"][0], attrs, x.shape[1])]}


@register_op("pool2d")
def _pool2d(ctx, ins, attrs):
    """Max or average pooling over NCHW. As in the JAX package: strides
    default to the window only when the attr is absent, `ceil_mode` is
    not read (output sizes are floored), and an exclusive average
    divides by the unpadded count only when there is padding. Padding
    beyond half the window raises (torch's limit). An adaptive pool
    (`ksize` is the output size) takes equal windows: the input is
    reshaped to [N, C, oh, H/oh, ow, W/ow] and reduced over dims 3 and
    5; sizes that do not divide raise, as in the JAX package."""
    x = ins["X"][0]
    ptype = attrs.get("pooling_type", "max")
    ksize = list(attrs.get("ksize", [2, 2]))
    adaptive = attrs.get("adaptive", False)
    # the reference's precedence: global, or (adaptive and a 1x1 output)
    if attrs.get("global_pooling", False) or adaptive \
            and list(attrs.get("ksize")) == [1, 1]:
        if ptype == "max":
            return {"Out": [torch.amax(x, dim=(2, 3), keepdim=True)]}
        return {"Out": [torch.mean(x, dim=(2, 3), keepdim=True)]}
    if adaptive:
        oh, ow = ksize
        n, c, h, w = x.shape
        if h % oh or w % ow:
            raise NotImplementedError(
                f"adaptive pool2d needs input sizes {h}x{w} divisible by "
                f"the output size {oh}x{ow}")
        xr = x.reshape(n, c, oh, h // oh, ow, w // ow)
        if ptype == "max":
            return {"Out": [torch.amax(xr, dim=(3, 5))]}
        return {"Out": [torch.mean(xr, dim=(3, 5))]}
    strides = list(attrs.get("strides", ksize))
    pads = list(attrs.get("paddings", [0, 0]))
    if ptype == "max":
        out = F.max_pool2d(x, ksize, strides, pads)
    else:
        exclusive = attrs.get("exclusive", True) and any(pads)
        out = F.avg_pool2d(x, ksize, strides, pads,
                           count_include_pad=not exclusive)
    return {"Out": [out]}


def _interp_src(od, d, align, mode, device):
    """Source coordinates, float32, as the JAX package computes them:
    align_corners -> dst*(d-1)/(od-1); else align_mode 0 (half-pixel)
    -> (dst+0.5)*d/od - 0.5 clamped at 0; align_mode 1 (the default) ->
    dst*d/od. F.interpolate follows the half-pixel convention only and
    accumulates in float32, so the gathers are explicit."""
    i = torch.arange(od, dtype=torch.float32, device=device)
    if align:
        return i * ((d - 1) / max(od - 1, 1))
    if mode == 0:
        return torch.clamp_min((i + 0.5) * (d / od) - 0.5, 0.0)
    return i * (d / od)


def _linear_interp_axis(x, od, axis, align, mode):
    d = x.shape[axis]
    f = _interp_src(od, d, align, mode, x.device)
    i0 = torch.clamp(torch.floor(f).long(), 0, d - 1)
    i1 = torch.clamp_max(i0 + 1, d - 1)
    # the weight in the input's dtype, as the reference rounds it
    w = (f - i0).to(x.dtype)
    shape = [1] * x.dim()
    shape[axis] = od
    w = w.reshape(shape)
    return (torch.index_select(x, axis, i0) * (1 - w)
            + torch.index_select(x, axis, i1) * w)


def _nearest_interp_axis(x, od, axis, align):
    d = x.shape[axis]
    i = torch.arange(od, dtype=torch.float32, device=x.device)
    if align:
        idx = torch.round(i * ((d - 1) / max(od - 1, 1)))
    else:
        idx = torch.floor(i * (d / od))
    return torch.index_select(x, axis, torch.clamp(idx.long(), 0, d - 1))


def _interp(x, attrs, method):
    """Resize the two spatial axes of NCHW `x` to (out_h, out_w), or by
    `scale` when out_h is absent or not positive: one pair of gathers
    per axis, H then W."""
    oh = attrs.get("out_h", -1)
    ow = attrs.get("out_w", -1)
    scale = attrs.get("scale", 0.0)
    if (oh is None or oh <= 0) and scale:
        oh = int(x.shape[2] * scale)
        ow = int(x.shape[3] * scale)
    align = attrs.get("align_corners", True)
    if method == "nearest":
        x = _nearest_interp_axis(x, oh, 2, align)
        return _nearest_interp_axis(x, ow, 3, align)
    mode = attrs.get("align_mode", 1)
    x = _linear_interp_axis(x, oh, 2, align, mode)
    return _linear_interp_axis(x, ow, 3, align, mode)


@register_op("bilinear_interp")
def _bilinear_interp(ctx, ins, attrs):
    return {"Out": [_interp(ins["X"][0], attrs, "bilinear")]}


@register_op("nearest_interp")
def _nearest_interp(ctx, ins, attrs):
    return {"Out": [_interp(ins["X"][0], attrs, "nearest")]}


@register_op("batch_norm", nondiff_inputs=("Mean", "Variance"),
             nondiff_outputs=("MeanOut", "VarianceOut", "SavedMean",
                              "SavedVariance"))
def _batch_norm(ctx, ins, attrs):
    """Batch normalisation over every axis but the channel's.

    Training normalises by the batch's mean and biased variance, and
    writes the running statistics as the JAX package does:
    ``running * momentum + batch * (1 - momentum)``, with the biased
    variance; SavedVariance is ``rsqrt(var + eps)``. torch's own running
    update differs (the unbiased variance, the other momentum
    convention), so it is used only to read the batch statistics out:
    with momentum 1 it leaves the batch mean and the unbiased variance in
    zeroed buffers, and the biased variance is that times (n - 1) / n.
    With one value a channel (a batch of 1 after a global pool), where
    torch raises, Y follows the JAX package's formula and equals Bias.
    `is_test`, `use_global_stats` or a test run normalise by the running
    statistics and pass them through. In a data-parallel run
    (ctx.sync_group) the moments are the global batch's: all-reduced
    over the ranks, as GSPMD computes them in the JAX package."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    nhwc = attrs.get("data_layout", "NCHW") == "NHWC" and x.dim() > 2
    if nhwc:
        x = x.movedim(-1, 1)
    if ctx.is_test or attrs.get("use_global_stats", False):
        y = F.batch_norm(x, mean, var, scale, bias, training=False,
                         eps=eps)
        return {"Y": [y.movedim(1, -1) if nhwc else y],
                "MeanOut": [mean], "VarianceOut": [var],
                "SavedMean": [mean], "SavedVariance": [var]}
    if getattr(ctx, "sync_group", None) is not None:
        m, v, y = _synced_batch_norm(x, scale, bias, eps, ctx.sync_group)
    elif x.numel() == x.shape[1]:
        # one value a channel, where torch's batch norm raises: the JAX
        # package's formula (variance 0, so Y is Bias)
        red = [i for i in range(x.dim()) if i != 1]
        v, m = torch.var_mean(x, dim=red, correction=0)
        bshape = [1, -1] + [1] * (x.dim() - 2)
        y = (x - m.reshape(bshape)) * torch.rsqrt(v.reshape(bshape) + eps) \
            * scale.reshape(bshape) + bias.reshape(bshape)
    else:
        n = x.numel() // x.shape[1]
        m, v = torch.zeros_like(mean), torch.zeros_like(var)
        y = F.batch_norm(x, m, v, scale, bias, training=True, momentum=1.0,
                         eps=eps)
        v = v * ((n - 1) / n)
    return {"Y": [y.movedim(1, -1) if nhwc else y],
            "MeanOut": [mean * momentum + m * (1 - momentum)],
            "VarianceOut": [var * momentum + v * (1 - momentum)],
            "SavedMean": [m], "SavedVariance": [torch.rsqrt(v + eps)]}


def _synced_batch_norm(x, scale, bias, eps, group):
    """(mean, biased variance, Y) over every rank's rows: the sums are
    all-reduced through the differentiable collective, two passes (the
    mean, then the centred squares)."""
    from .collective import _AllReduce
    red = [i for i in range(x.dim()) if i != 1]
    bshape = [1, -1] + [1] * (x.dim() - 2)
    cnt = torch.full((1,), x.numel() // x.shape[1], dtype=x.dtype,
                     device=x.device)
    s1 = _AllReduce.apply(torch.cat([x.sum(red), cnt]), group, "sum")
    n = s1[-1]
    m = s1[:-1] / n
    d = x - m.reshape(bshape)
    v = _AllReduce.apply((d * d).sum(red), group, "sum") / n
    y = d * torch.rsqrt(v.reshape(bshape) + eps) * scale.reshape(bshape) \
        + bias.reshape(bshape)
    return m, v, y


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


@register_op("conv3d")
def _conv3d(ctx, ins, attrs):
    """NCDHW input and OIDHW filter, symmetric `paddings` [d, h, w]. The
    output keeps the input's dtype."""
    x, w = ins["Input"][0], ins["Filter"][0]
    out = F.conv3d(x, w, stride=tuple(attrs.get("strides", [1, 1, 1])),
                   padding=tuple(attrs.get("paddings", [0, 0, 0])),
                   dilation=tuple(attrs.get("dilations", [1, 1, 1])),
                   groups=attrs.get("groups", 1)).to(x.dtype)
    return {"Output": [out]}


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    from .vision_extra import conv_transpose
    x, w = ins["Input"][0], ins["Filter"][0]  # w: [C_in, C_out/g, kh, kw]
    return {"Output": [conv_transpose(x, w, attrs, 2)]}


@register_op("group_norm")
def _group_norm(ctx, ins, attrs):
    """Normalise each of `groups` channel groups of NC... `X` over its
    channels and spatial axes (biased variance); Mean and Variance are
    [N, groups]."""
    x = ins["X"][0]
    g = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    v, m = torch.var_mean(xg, dim=tuple(range(2, xg.dim())), keepdim=True,
                          correction=0)
    y = ((xg - m) * torch.rsqrt(v + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    if "Scale" in ins:
        y = y * ins["Scale"][0].reshape(bshape)
    if "Bias" in ins:
        y = y + ins["Bias"][0].reshape(bshape)
    return {"Y": [y], "Mean": [m.reshape(n, g)],
            "Variance": [v.reshape(n, g)]}


@register_op("prelu")
def _prelu(ctx, ins, attrs):
    """x where x > 0, else alpha * x; `mode` all (one alpha), channel (one
    per axis-1 channel) or element (one per element of a sample)."""
    x, alpha = ins["X"][0], ins["Alpha"][0]
    mode = attrs.get("mode", "all")
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "element":
        alpha = alpha.reshape((1,) + tuple(x.shape[1:]))
    return {"Out": [torch.where(x > 0, x, alpha * x)]}


@register_op("max_pool2d_with_index", nondiff_outputs=("Mask",))
def _max_pool2d_with_index(ctx, ins, attrs):
    """Max pooling and each window's winner as its h * W + w index in
    the unpadded input map (int32), the first of tied maxima. Strides
    default to 1, not the window; `global_pooling` and `adaptive`
    (divisible sizes only, as in the JAX package) set the window."""
    x = ins["X"][0]
    h, w = x.shape[2], x.shape[3]
    if attrs.get("global_pooling", False):
        k, st, pad = (h, w), (h, w), (0, 0)
    elif attrs.get("adaptive", False):
        oh, ow = attrs.get("ksize", [1, 1])
        if h % oh or w % ow:
            raise NotImplementedError(
                f"adaptive max_pool2d_with_index needs input sizes {h}x{w} "
                f"divisible by the output size {oh}x{ow}")
        k = st = (h // oh, w // ow)
        pad = (0, 0)
    else:
        k = tuple(attrs.get("ksize", [2, 2]))
        st = tuple(attrs.get("strides", [1, 1]))
        pad = tuple(attrs.get("paddings", [0, 0]))
    out, idx = F.max_pool2d(x, k, st, pad, return_indices=True)
    return {"Out": [out], "Mask": [idx.to(torch.int32)]}


@register_op("instance_norm")
def _instance_norm(ctx, ins, attrs):
    """Normalise each sample's channels over their spatial axes (biased
    variance); SavedMean and SavedVariance are [N, C]."""
    x = ins["X"][0]
    v, m = torch.var_mean(x, dim=tuple(range(2, x.dim())), keepdim=True,
                          correction=0)
    y = (x - m) * torch.rsqrt(v + attrs.get("epsilon", 1e-5))
    bshape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    if "Scale" in ins:
        y = y * ins["Scale"][0].reshape(bshape)
    if "Bias" in ins:
        y = y + ins["Bias"][0].reshape(bshape)
    lead = tuple(x.shape[:2])
    return {"Y": [y], "SavedMean": [m.reshape(lead)],
            "SavedVariance": [v.reshape(lead)]}


@register_op("data_norm")
def _data_norm(ctx, ins, attrs):
    """(X - BatchSum / BatchSize) * sqrt(BatchSize / BatchSquareSum): the
    accumulators are raw sums, not a variance estimate."""
    x = ins["X"][0]
    size = ins["BatchSize"][0]
    mean = ins["BatchSum"][0] / size
    scale = torch.sqrt(size / ins["BatchSquareSum"][0])
    return {"Y": [(x - mean) * scale], "Means": [mean], "Scales": [scale]}


@register_op("selu")
def _selu(ctx, ins, attrs):
    x = ins["X"][0]
    scale = attrs.get("scale", 1.0507009873554805)
    alpha = attrs.get("alpha", 1.6732632423543772)
    return {"Out": [scale * torch.where(x > 0, x,
                                        alpha * (torch.exp(x) - 1))]}


@register_op("lrn")
def _lrn(ctx, ins, attrs):
    """X / (k + alpha * the sum of X^2 over the n channels centred on
    each, zero-padded)^beta. Not F.local_response_norm, which divides
    alpha by n and pads otherwise."""
    x = ins["X"][0]  # NCHW
    n = attrs.get("n", 5)
    half = n // 2
    sq_pad = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    c = x.shape[1]
    acc = sq_pad[:, 0:c]
    for i in range(1, n):
        acc = acc + sq_pad[:, i:i + c]
    mid = attrs.get("k", 2.0) + attrs.get("alpha", 1e-4) * acc
    return {"Out": [x / torch.pow(mid, attrs.get("beta", 0.75))],
            "MidOut": [mid]}


@register_op("pixel_shuffle")
def _pixel_shuffle(ctx, ins, attrs):
    x = ins["X"][0]
    r = attrs.get("upscale_factor", 1)
    n, c, h, w = x.shape
    out = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": [out.reshape(n, c // (r * r), h * r, w * r)]}


@register_op("space_to_depth")
def _space_to_depth(ctx, ins, attrs):
    x = ins["X"][0]
    b = attrs.get("blocksize", 1)
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return {"Out": [out.reshape(n, c * b * b, h // b, w // b)]}


@register_op("temporal_shift")
def _temporal_shift(ctx, ins, attrs):
    """Of [N*T, C, H, W]: the first C*ratio channels shifted one step
    back in time, the next as many one step forward, zeros at the ends."""
    x = ins["X"][0]
    t = attrs["seg_num"]
    nt, c, h, w = x.shape
    xr = x.reshape(nt // t, t, c, h, w)
    c1 = int(c * attrs.get("shift_ratio", 0.25))
    fwd = F.pad(xr[:, 1:, :c1], (0, 0, 0, 0, 0, 0, 0, 1))
    bwd = F.pad(xr[:, :-1, c1:2 * c1], (0, 0, 0, 0, 0, 0, 1, 0))
    out = torch.cat([fwd, bwd, xr[:, :, 2 * c1:]], dim=2)
    return {"Out": [out.reshape(nt, c, h, w)]}


@register_op("shuffle_channel")
def _shuffle_channel(ctx, ins, attrs):
    x = ins["X"][0]
    g = attrs.get("group", 1)
    n, c, h, w = x.shape
    return {"Out": [x.reshape(n, g, c // g, h, w).transpose(1, 2)
                    .reshape(n, c, h, w)]}


@register_op("affine_channel")
def _affine_channel(ctx, ins, attrs):
    x = ins["X"][0]
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    return {"Out": [x * ins["Scale"][0].reshape(bshape)
                    + ins["Bias"][0].reshape(bshape)]}


@register_op("unfold")
def _unfold(ctx, ins, attrs):
    """im2col of NCHW X: [N, C * kh * kw, L], channels slowest. `paddings`
    is [h, w] or [top, left, bottom, right]."""
    x = ins["X"][0]
    p = attrs.get("paddings", [0, 0, 0, 0])
    top, left = p[0], p[1]
    bottom = p[2] if len(p) > 2 else top
    right = p[3] if len(p) > 3 else left
    if (top, left) != (bottom, right):
        x = F.pad(x, (left, right, top, bottom))
        top = left = 0
    return {"Y": [F.unfold(x, tuple(attrs["kernel_sizes"]),
                           dilation=tuple(attrs.get("dilations", [1, 1])),
                           padding=(top, left),
                           stride=tuple(attrs.get("strides", [1, 1])))]}
