"""Loss ops: softmax_with_cross_entropy."""
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
