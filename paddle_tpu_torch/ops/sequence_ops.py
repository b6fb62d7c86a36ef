"""Sequence ops on the padded layout: a ragged batch is a padded
[B, T, ...] tensor and a lengths vector [B] (its companion var, fed by
the executor from a LoDTensor), and masking by lengths gives the ragged
results. Also ``im2sequence`` (image patches as rows)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.dtypes import as_torch_dtype
from ..core.registry import register_op


def _len_mask(lengths, maxlen, dtype=torch.float32):
    pos = torch.arange(maxlen, device=lengths.device)
    return (pos[None, :] < lengths.reshape(-1, 1)).to(dtype)


def _bcast(t, ndim):
    """t [B, T] (or [B]) with trailing unit dims up to `ndim`."""
    return t.reshape(tuple(t.shape) + (1,) * (ndim - t.dim()))


@register_op("sequence_mask", nondiff_inputs=("X",), nondiff_outputs=("Y",))
def _sequence_mask(ctx, ins, attrs):
    x = ins["X"][0].reshape(-1)
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise NotImplementedError(
            "sequence_mask needs an explicit maxlen (static shapes)")
    return {"Y": [_len_mask(x, maxlen, as_torch_dtype(
        attrs.get("out_dtype", "int64")))]}


@register_op("sequence_pool", nondiff_inputs=("Lengths",),
             nondiff_outputs=("MaxIndex",))
def _sequence_pool(ctx, ins, attrs):
    x = ins["X"][0]  # [B, T, ...]
    ptype = attrs.get("pooltype", "SUM").upper()
    b, t = x.shape[0], x.shape[1]
    if "Lengths" in ins:
        lens = ins["Lengths"][0].reshape(-1)
        mask = _bcast(_len_mask(lens, t, x.dtype), x.dim())
        denom = _bcast(lens.to(x.dtype).clamp_min(1.0), x.dim() - 1)
    else:
        mask = torch.ones(x.shape[:2] + (1,) * (x.dim() - 2),
                          dtype=x.dtype, device=x.device)
        denom = torch.full((b,) + (1,) * (x.dim() - 2), t, dtype=x.dtype,
                           device=x.device)
    if ptype == "SUM":
        out = (x * mask).sum(1)
    elif ptype in ("AVERAGE", "MEAN"):
        out = (x * mask).sum(1) / denom
    elif ptype == "SQRT":
        out = (x * mask).sum(1) / denom.sqrt()
    elif ptype == "MAX":
        out = torch.where(mask > 0, x, float("-inf")).amax(1)
    elif ptype == "LAST":
        # a zero-length row reads the last step, as a -1 index wraps
        idx = (mask.reshape(b, t).sum(1).long() - 1) % t
        out = x.gather(1, _bcast(idx.reshape(b, 1), x.dim()).expand(
            (b, 1) + tuple(x.shape[2:])))[:, 0]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError(f"sequence_pool {ptype}")
    return {"Out": [out],
            "MaxIndex": [torch.zeros(b, dtype=torch.int32,
                                     device=x.device)]}


@register_op("sequence_softmax", nondiff_inputs=("Lengths",))
def _sequence_softmax(ctx, ins, attrs):
    x = ins["X"][0]  # [B, T]
    if "Lengths" in ins:
        mask = _len_mask(ins["Lengths"][0].reshape(-1), x.shape[1], x.dtype)
        x = torch.where(mask > 0, x, float("-inf"))
    return {"Out": [torch.softmax(x, dim=1)]}


@register_op("sequence_reverse", nondiff_inputs=("Lengths",))
def _sequence_reverse(ctx, ins, attrs):
    x = ins["X"][0]  # [B, T, ...]
    b, t = x.shape[0], x.shape[1]
    idx = torch.arange(t, device=x.device)[None, :]
    if "Lengths" in ins:
        lens = ins["Lengths"][0].reshape(-1, 1).long()
        rev = torch.where(idx < lens, lens - 1 - idx, idx)
    else:
        rev = (t - 1 - idx).expand(b, t)
    rev = _bcast(rev, x.dim()).expand(x.shape)
    return {"Y": [x.gather(1, rev)]}


@register_op("sequence_pad", nondiff_inputs=("PadValue",))
def _sequence_pad(ctx, ins, attrs):
    """The padded input as it is, widened with PadValue to
    `padded_length` when that exceeds T (-1 keeps T), and the lengths
    (all T when the input has no Lengths)."""
    x = ins["X"][0]
    t = x.shape[1]
    pl = attrs.get("padded_length", -1)
    if pl is not None and pl > t:
        pv = ins["PadValue"][0].reshape(-1)[0].to(x.dtype)
        fill = pv.expand((x.shape[0], pl - t) + tuple(x.shape[2:]))
        x = torch.cat([x, fill], dim=1)
    lens = ins["Lengths"][0] if "Lengths" in ins else \
        torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
    return {"Out": [x], "Length": [lens]}


@register_op("sequence_unpad", nondiff_inputs=("Length",))
def _sequence_unpad(ctx, ins, attrs):
    """Positions past each row's Length zeroed (the layout stays
    padded)."""
    x = ins["X"][0]
    lens = ins["Length"][0].reshape(-1)
    mask = torch.arange(x.shape[1], device=x.device)[None, :] < \
        lens[:, None]
    return {"Out": [torch.where(_bcast(mask, x.dim()), x,
                                torch.zeros((), dtype=x.dtype,
                                            device=x.device))]}


@register_op("sequence_expand_as")
def _sequence_expand_as(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    reps = y.shape[1] if y.dim() > 1 else 1
    return {"Out": [x.repeat_interleave(reps, dim=0)]}


@register_op("im2sequence")
def _im2sequence(ctx, ins, attrs):
    """NCHW image -> one row per output position of the kernel window,
    its C*kh*kw values channel-major: [N*OH*OW, C*kh*kw]."""
    x = ins["X"][0]
    kernels = attrs["kernels"]
    strides = attrs.get("strides", [1, 1])
    up, left, down, right = attrs.get("paddings", [0, 0, 0, 0])
    x = F.pad(x, (left, right, up, down))
    cols = F.unfold(x, kernel_size=tuple(kernels), stride=tuple(strides))
    n, ckk, _ = cols.shape
    return {"Out": [cols.transpose(1, 2).reshape(-1, ckk)]}
