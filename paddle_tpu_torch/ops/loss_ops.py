"""Loss ops: softmax_with_cross_entropy and cross_entropy."""
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
