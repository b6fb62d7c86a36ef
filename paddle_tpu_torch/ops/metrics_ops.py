"""Metric ops: accuracy and the streaming auc."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("accuracy", nondiff_inputs=("Out", "Indices", "Label"),
             nondiff_outputs=("Accuracy", "Correct", "Total"))
def _accuracy(ctx, ins, attrs):
    """The share of rows whose top-k Indices [N, k] hold the label:
    Accuracy float32 [1], Correct and Total int32 [1]."""
    idx = ins["Indices"][0]
    label = ins["Label"][0].reshape(-1, 1)
    n = idx.shape[0]
    correct = torch.any(idx == label, dim=1).sum(dtype=torch.float32)
    return {"Accuracy": [(correct / n).reshape(1)],
            "Correct": [correct.to(torch.int32).reshape(1)],
            "Total": [torch.full((1,), n, dtype=torch.int32,
                                 device=idx.device)]}


@register_op("auc", nondiff_inputs=("Predict", "Label", "StatPos", "StatNeg"),
             nondiff_outputs=("AUC", "StatPosOut", "StatNegOut"),
             inplace=True)
def _auc(ctx, ins, attrs):
    """Streaming ROC AUC over histogram buckets: the positive-class
    probability (Predict's last column) of each row lands in bucket
    trunc(p * num_thresholds), clamped to [0, num_thresholds]; the
    label's count there is added to StatPos or StatNeg (kept in their
    own dtype, int64 from the layer), and AUC is the trapezoid area of
    the ROC over the descending thresholds, in float64 (0 without both
    classes)."""
    pred = ins["Predict"][0][:, -1]
    label = ins["Label"][0].reshape(-1)
    stat_pos, stat_neg = ins["StatPos"][0], ins["StatNeg"][0]
    nt = attrs.get("num_thresholds", 4095)
    bucket = torch.clamp((pred * nt).to(torch.int32), 0, nt).long()
    pos = stat_pos.index_add(0, bucket, (label == 1).to(stat_pos.dtype))
    neg = stat_neg.index_add(0, bucket, (label == 0).to(stat_neg.dtype))
    tp = torch.cumsum(torch.flip(pos, (0,)), 0).double()
    fp = torch.cumsum(torch.flip(neg, (0,)), 0).double()
    tp_prev = torch.cat([tp.new_zeros(1), tp[:-1]])
    fp_prev = torch.cat([fp.new_zeros(1), fp[:-1]])
    area = torch.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
    denom = tp[-1] * fp[-1]
    auc = torch.where(denom > 0, area / denom, area.new_zeros(()))
    return {"AUC": [auc.reshape(())], "StatPosOut": [pos],
            "StatNegOut": [neg]}
