"""Loss ops: the 17 of the JAX package's loss_ops.py, each its formula
in torch."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("softmax_with_cross_entropy", nondiff_inputs=("Label",))
def _softmax_with_ce(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = attrs.get("axis", -1) % logits.dim()
    logp = torch.log_softmax(logits, dim=axis)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        ignore = attrs.get("ignore_index", -100)
        # hard label: logits' shape with a size-1 (or absent) class dim
        lbl = label
        if lbl.dim() == logits.dim() - 1:
            lbl = lbl.unsqueeze(axis)
        picked = torch.take_along_dim(logp, lbl.long(), dim=axis)
        loss = torch.where(lbl == ignore, picked.new_zeros(()), -picked)
    out = {"Loss": [loss]}
    # the training losses never read Softmax ([rows, vocab]); it is made
    # only when something does
    if ctx.wants("Softmax"):
        out["Softmax"] = [torch.exp(logp)]
    return out


@register_op("cross_entropy", nondiff_inputs=("Label",))
def _cross_entropy(ctx, ins, attrs):
    """-log(p + 1e-8) of probabilities X [N, C]: of the label's column
    (a label equal to ignore_index gives 0), or summed against soft
    labels."""
    x, label = ins["X"][0], ins["Label"][0]
    eps = 1e-8
    if attrs.get("soft_label", False):
        return {"Y": [-torch.sum(label * torch.log(x + eps), dim=-1,
                                 keepdim=True)]}
    lbl = label.reshape(label.shape[0], -1)[:, :1].long()
    ignored = lbl == attrs.get("ignore_index", -100)
    # an ignored label may lie outside [0, C): read column 0 instead
    picked = torch.take_along_dim(x, torch.where(ignored, 0, lbl), dim=-1)
    loss = torch.where(ignored, x.new_zeros(()), -torch.log(picked + eps))
    return {"Y": [loss]}


def _take_label(x, label):
    # label [N, 1] or [N] -> x[row, label] as [N, 1]
    lbl = label.reshape(label.shape[0], -1)[:, :1].long()
    return torch.take_along_dim(x, lbl, dim=-1)


@register_op("cross_entropy2", nondiff_inputs=("Label",))
def _cross_entropy2(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    picked = _take_label(x, label)
    return {"Y": [-torch.log(picked + 1e-8)],
            "XShape": [x.new_zeros((0,) + tuple(x.shape))],
            "MatchX": [picked]}


@register_op("sigmoid_cross_entropy_with_logits", nondiff_inputs=("Label",))
def _sigmoid_ce(ctx, ins, attrs):
    """max(x, 0) - x * label + log1p(exp(-|x|)), 0 where the label is
    ignore_index; `normalize` divides by the count of other labels."""
    x, label = ins["X"][0], ins["Label"][0]
    ignore = attrs.get("ignore_index", -100)
    loss = torch.clamp_min(x, 0) - x * label + \
        torch.log1p(torch.exp(-torch.abs(x)))
    loss = torch.where(label == ignore, loss.new_zeros(()), loss)
    if attrs.get("normalize", False):
        n = torch.clamp_min(torch.sum(label != ignore).to(x.dtype), 1.0)
        loss = loss / n
    return {"Out": [loss]}


@register_op("square_error_cost")
def _square_error_cost(ctx, ins, attrs):
    return {"Out": [torch.square(ins["X"][0] - ins["Y"][0])]}


@register_op("huber_loss")
def _huber_loss(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]  # prediction, label
    d = attrs.get("delta", 1.0)
    r = y - x
    absr = torch.abs(r)
    loss = torch.where(absr <= d, 0.5 * r * r, d * (absr - 0.5 * d))
    return {"Out": [loss], "Residual": [r]}


@register_op("smooth_l1_loss")
def _smooth_l1(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    s2 = attrs.get("sigma", 1.0) ** 2
    d = x - y
    if "InsideWeight" in ins:
        d = d * ins["InsideWeight"][0]
    absd = torch.abs(d)
    loss = torch.where(absd < 1.0 / s2, 0.5 * d * d * s2, absd - 0.5 / s2)
    if "OutsideWeight" in ins:
        loss = loss * ins["OutsideWeight"][0]
    loss = torch.sum(loss.reshape(loss.shape[0], -1), dim=1, keepdim=True)
    return {"Out": [loss], "Diff": [d]}


@register_op("log_loss", nondiff_inputs=("Labels",))
def _log_loss(ctx, ins, attrs):
    p, label = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": [-label * torch.log(p + eps)
                     - (1 - label) * torch.log(1 - p + eps)]}


@register_op("kldiv_loss", nondiff_inputs=("Target",))
def _kldiv_loss(ctx, ins, attrs):
    x, tgt = ins["X"][0], ins["Target"][0]
    red = attrs.get("reduction", "mean")
    loss = tgt * (torch.log(torch.clamp_min(tgt, 1e-10)) - x)
    loss = torch.where(tgt > 0, loss, loss.new_zeros(()))
    if red == "mean":
        loss = torch.mean(loss)
    elif red == "sum":
        loss = torch.sum(loss)
    elif red == "batchmean":
        loss = torch.sum(loss) / x.shape[0]
    return {"Loss": [loss]}


@register_op("hinge_loss", nondiff_inputs=("Labels",))
def _hinge_loss(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Labels"][0]
    return {"Loss": [torch.clamp_min(1.0 - (2 * label - 1) * logits, 0.0)]}


@register_op("rank_loss", nondiff_inputs=("Label",))
def _rank_loss(ctx, ins, attrs):
    label = ins["Label"][0]
    d = ins["Left"][0] - ins["Right"][0]
    return {"Out": [torch.log1p(torch.exp(d)) - label * d]}


@register_op("margin_rank_loss", nondiff_inputs=("Label",))
def _margin_rank_loss(ctx, ins, attrs):
    label = ins["Label"][0]
    x1, x2 = ins["X1"][0], ins["X2"][0]
    out = torch.clamp_min(-label * (x1 - x2) + attrs.get("margin", 0.0),
                          0.0)
    return {"Out": [out], "Activated": [(out > 0).to(x1.dtype)]}


@register_op("bpr_loss", nondiff_inputs=("Label",))
def _bpr_loss(ctx, ins, attrs):
    """The mean over j != label of log(1 + exp(x_j - x_label))."""
    x, label = ins["X"][0], ins["Label"][0]
    lbl = label.reshape(label.shape[0], -1)[:, 0].long()
    pos = torch.take_along_dim(x, lbl[:, None], dim=-1)
    n = x.shape[-1]
    ele = torch.log1p(torch.exp(x - pos))
    is_lbl = torch.arange(n, device=x.device)[None, :] == lbl[:, None]
    loss = torch.sum(torch.where(is_lbl, ele.new_zeros(()), ele), dim=-1,
                     keepdim=True) / (n - 1)
    return {"Y": [loss]}


@register_op("npair_loss", nondiff_inputs=("Labels",))
def _npair_loss(ctx, ins, attrs):
    """Softmax cross-entropy of anchor-positive similarities against the
    label-equality targets, plus l2_reg / 4 times the mean squared norms
    of both."""
    anchor, pos = ins["Anchor"][0], ins["Positive"][0]
    labels = ins["Labels"][0].reshape(-1)
    reg = attrs.get("l2_reg", 0.002)
    sim = torch.matmul(anchor, pos.t())
    tgt = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    tgt = tgt / torch.sum(tgt, dim=1, keepdim=True)
    ce = -torch.mean(torch.sum(tgt * torch.log_softmax(sim, dim=1), dim=1))
    l2 = reg * 0.25 * (torch.mean(torch.sum(anchor * anchor, 1)) +
                       torch.mean(torch.sum(pos * pos, 1)))
    return {"Out": [(ce + l2).reshape(())]}


@register_op("dice_loss", nondiff_inputs=("Label",))
def _dice_loss(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    inter = 2 * torch.sum(x * label)
    union = torch.sum(x) + torch.sum(label)
    return {"Out": [(1 - inter / (union + 1e-5)).reshape(())]}


@register_op("mse_loss")
def _mse_loss(ctx, ins, attrs):
    return {"Out": [torch.mean(torch.square(ins["X"][0] - ins["Y"][0]))]}


@register_op("center_loss", nondiff_inputs=("Label", "Centers",
                                            "CenterUpdateRate"))
def _center_loss(ctx, ins, attrs):
    """Half the squared distance of each row to its label's center; with
    `need_update`, CentersOut moves each center by the rate times the
    summed differences over (count + 1)."""
    x, label = ins["X"][0], ins["Label"][0].reshape(-1).long()
    centers = ins["Centers"][0]
    diff = x - torch.index_select(centers, 0, label)
    out = {"Loss": [0.5 * torch.sum(torch.square(diff), dim=-1,
                                    keepdim=True)],
           "SampleCenterDiff": [diff]}
    if attrs.get("need_update", True) and "CenterUpdateRate" in ins:
        alpha = ins["CenterUpdateRate"][0].reshape(())
        cnt = torch.zeros(centers.shape[0], dtype=x.dtype,
                          device=x.device).index_add(
            0, label, torch.ones_like(label, dtype=x.dtype))
        upd = torch.zeros_like(centers).index_add(0, label, diff)
        out["CentersOut"] = [centers + alpha * upd / (cnt[:, None] + 1.0)]
    return out
