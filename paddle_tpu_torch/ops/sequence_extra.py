"""The other sequence ops and the LoD plumbing ops, on the padded layout
([B, T, ...] plus lengths, as an input, an attr or all T). Every shape is
static: an op that would compact rows (sequence_erase,
filter_by_instag, split_lod_tensor) masks or pads them instead, and the
LoD bookkeeping ops (lod_reset, shrink_rnn_memory, rnn_memory_helper)
are identities on the device, the lengths living in their companion
var."""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _bcast(t, ndim):
    return t.reshape(tuple(t.shape) + (1,) * (ndim - t.dim()))


@register_op("sequence_concat")
def _sequence_concat(ctx, ins, attrs):
    """Concat along time; padded rows stay at their source offsets."""
    return {"Out": [torch.cat(ins["X"], dim=1)]}


def _shifted(x, off, fill):
    """x [B, T, ...] shifted left by `off` steps along time; the steps
    shifted in past either end take `fill`."""
    t = x.shape[1]
    rolled = torch.roll(x, -off, dims=1)
    idx = torch.arange(t, device=x.device) + off
    valid = _bcast(((idx >= 0) & (idx < t))[None, :], x.dim())
    return torch.where(valid, rolled, fill)


@register_op("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    """Context-window conv over time: the contextLength shifted copies of
    X side by side, then one product with Filter [ctx * d, out]."""
    x = ins["X"][0]
    w = ins["Filter"][0]
    ctx_len = attrs.get("contextLength", 3)
    start = attrs.get("contextStart", -(ctx_len // 2))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    col = torch.cat([_shifted(x, start + j, zero) for j in range(ctx_len)],
                    dim=-1)
    return {"Out": [col @ w]}


@register_op("sequence_enumerate", nondiff_inputs=("X",),
             nondiff_outputs=("Out",))
def _sequence_enumerate(ctx, ins, attrs):
    x = ins["X"][0]  # [B, T] ids
    win = attrs.get("win_size", 2)
    pad = torch.tensor(attrs.get("pad_value", 0), dtype=x.dtype,
                       device=x.device)
    return {"Out": [torch.stack([_shifted(x, j, pad) for j in range(win)],
                                dim=-1)]}


@register_op("sequence_erase", nondiff_inputs=("X",),
             nondiff_outputs=("Out",))
def _sequence_erase(ctx, ins, attrs):
    """Remove `tokens`: the kept ones compact left in order, -1 after."""
    x = ins["X"][0]
    tokens = torch.tensor(attrs.get("tokens", []), dtype=x.dtype,
                          device=x.device)
    keep = ~torch.isin(x, tokens)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    g = x.gather(1, order)
    k = keep.gather(1, order)
    return {"Out": [torch.where(k, g, torch.full_like(g, -1))]}


@register_op("sequence_expand")
def _sequence_expand(ctx, ins, attrs):
    """Each row of X repeated Y.shape[0] / X.shape[0] times (when that
    divides; else X as it is)."""
    x, y = ins["X"][0], ins["Y"][0]
    if y.dim() >= 1 and y.shape[0] % max(x.shape[0], 1) == 0:
        return {"Out": [x.repeat_interleave(y.shape[0] // x.shape[0],
                                            dim=0)]}
    return {"Out": [x]}


@register_op("sequence_reshape")
def _sequence_reshape(ctx, ins, attrs):
    x = ins["X"][0]  # [B, T, d] -> [B, T*d/new, new]
    return {"Out": [x.reshape(x.shape[0], -1, attrs.get("new_dim"))]}


@register_op("sequence_scatter", nondiff_inputs=("Ids",))
def _sequence_scatter(ctx, ins, attrs):
    """Per row: X[b, Ids[b, j]] += Updates[b, j]."""
    x = ins["X"][0]  # [B, T]
    b = x.shape[0]
    ids = ins["Ids"][0].reshape(b, -1).long()
    upd = ins["Updates"][0].reshape(b, -1).to(x.dtype)
    return {"Out": [x.scatter_add(1, ids, upd)]}


@register_op("sequence_slice", nondiff_inputs=("Offset", "Length"))
def _sequence_slice(ctx, ins, attrs):
    """Per row the steps [offset, offset + length), from step 0; the
    tail zeroed."""
    x = ins["X"][0]  # [B, T, ...]
    b, t = x.shape[0], x.shape[1]
    off = ins["Offset"][0].reshape(-1, 1).long()
    ln = ins["Length"][0].reshape(-1, 1).long()
    pos = torch.arange(t, device=x.device)[None, :]
    src = _bcast((pos + off) % t, x.dim()).expand(x.shape)
    keep = _bcast(pos < ln, x.dim())
    return {"Out": [torch.where(keep, x.gather(1, src),
                                torch.zeros((), dtype=x.dtype,
                                            device=x.device))]}


@register_op("sequence_topk_avg_pooling", nondiff_inputs=("ROW", "COLUMN"))
def _seq_topk_avg(ctx, ins, attrs):
    """Mean of the top-k values of each row of the last axis, one column
    per k of `topks`."""
    x = ins["X"][0]
    outs = [torch.topk(x, min(k, x.shape[-1]), dim=-1)[0].mean(-1)
            for k in attrs.get("topks", [1])]
    return {"Out": [torch.cat(outs, dim=-1)],
            "pos": [torch.zeros(1, dtype=torch.int32, device=x.device)]}


@register_op("match_matrix_tensor")
def _match_matrix_tensor(ctx, ins, attrs):
    """out[b, c, i, j] = x[b, i] W_c y[b, j]."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["W"][0]
    return {"Out": [torch.einsum("bid,dce,bje->bcij", x, w, y)],
            "Tmp": [torch.zeros(1, dtype=x.dtype, device=x.device)]}


@register_op("filter_by_instag", nondiff_inputs=("Ins_tag", "Filter_tag"),
             nondiff_outputs=("LossWeight", "IndexMap"))
def _filter_by_instag(ctx, ins, attrs):
    """Rows whose tags meet the filter tags keep their values, the others
    are zeroed; LossWeight is the 0/1 row mask."""
    x = ins["Ins"][0]
    tags = ins["Ins_tag"][0].reshape(x.shape[0], -1)
    ftags = ins["Filter_tag"][0].reshape(-1)
    w = torch.isin(tags, ftags).any(-1).to(x.dtype)
    rows = torch.arange(x.shape[0], dtype=torch.int64, device=x.device)
    return {"Out": [x * _bcast(w, x.dim())],
            "LossWeight": [w.reshape(-1, 1)],
            "IndexMap": [torch.stack([rows, rows], dim=1)]}


# -- LoD plumbing ------------------------------------------------------------

@register_op("lod_reset", nondiff_inputs=("Y",))
def _lod_reset(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


@register_op("lod_rank_table", nondiff_inputs=("X",))
def _lod_rank_table(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [torch.arange(x.shape[0], dtype=torch.int64,
                                 device=x.device)]}


@register_op("max_sequence_len", nondiff_inputs=("RankTable",),
             nondiff_outputs=("Out",))
def _max_sequence_len(ctx, ins, attrs):
    r = ins["RankTable"][0]
    return {"Out": [torch.tensor([r.shape[0]], dtype=torch.int64,
                                 device=r.device)]}


@register_op("lod_tensor_to_array")
def _lod_tensor_to_array(ctx, ins, attrs):
    """[B, T, ...] -> the time-major array [T, B, ...]."""
    return {"Out": [ins["X"][0].transpose(0, 1)]}


@register_op("array_to_lod_tensor")
def _array_to_lod_tensor(ctx, ins, attrs):
    return {"Out": [ins["X"][0].transpose(0, 1)]}


@register_op("reorder_lod_tensor_by_rank", nondiff_inputs=("RankTable",))
def _reorder_by_rank(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.index_select(0, ins["RankTable"][0].reshape(-1)
                                   .long())]}


@register_op("split_lod_tensor", nondiff_inputs=("Mask",))
def _split_lod_tensor(ctx, ins, attrs):
    """Rows routed by Mask into the true and false outputs, the other
    rows zeroed (merge_lod_tensor puts them back)."""
    x = ins["X"][0]
    m = _bcast(ins["Mask"][0].reshape(-1).bool(), x.dim())
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return {"OutTrue": [torch.where(m, x, zero)],
            "OutFalse": [torch.where(m, zero, x)]}


@register_op("merge_lod_tensor", nondiff_inputs=("Mask",))
def _merge_lod_tensor(ctx, ins, attrs):
    t, f = ins["InTrue"][0], ins["InFalse"][0]
    m = _bcast(ins["Mask"][0].reshape(-1).bool(), t.dim())
    return {"Out": [torch.where(m, t, f)]}


@register_op("shrink_rnn_memory", nondiff_inputs=("RankTable", "I"))
def _shrink_rnn_memory(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


@register_op("rnn_memory_helper")
def _rnn_memory_helper(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}
