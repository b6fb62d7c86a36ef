"""Metric ops: accuracy."""
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
