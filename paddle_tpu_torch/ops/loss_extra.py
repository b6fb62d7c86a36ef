"""Sampled losses: nce."""
from __future__ import annotations

import math

import torch

from ..core.registry import register_op


@register_op("nce", nondiff_inputs=("Label", "SampleWeight",
                                    "CustomDistProbs", "CustomDistAlias",
                                    "CustomDistAliasProbs"))
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation with uniform negatives: the true
    class and `num_neg_samples` classes drawn from the op's generator
    (the reference draws with jax.random, so the draws differ), scored
    by Input · Weight[id] + Bias[id] less log q, under the logistic loss
    with the true class positive. Cost [B, 1], SampleLogits [B, 1 + n],
    SampleLabels (the ids) [B, 1 + n]."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    label = ins["Label"][0].reshape(-1).long()
    n_neg = attrs.get("num_neg_samples", 10)
    total = attrs.get("num_total_classes", w.shape[0])
    batch = x.shape[0]
    neg = torch.randint(0, total, (batch, n_neg), generator=ctx.generator,
                        device=x.device)
    ids = torch.cat([label[:, None], neg], dim=1)
    logits = torch.einsum("bd,bkd->bk", x, w[ids])
    if "Bias" in ins:
        logits = logits + ins["Bias"][0].reshape(-1)[ids]
    adj = logits - torch.tensor(math.log(n_neg / total), dtype=logits.dtype,
                                device=x.device)
    labels01 = torch.zeros_like(adj)
    labels01[:, 0] = 1.0
    loss = torch.sum(torch.logaddexp(adj.new_zeros(()), adj)
                     - adj * labels01, dim=1)
    return {"Cost": [loss.reshape(-1, 1)], "SampleLogits": [logits],
            "SampleLabels": [ids]}
