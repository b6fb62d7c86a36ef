"""Activation ops: gelu, relu, tanh."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


@register_op("gelu")
def _gelu(ctx, ins, attrs):
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [F.gelu(ins["X"][0], approximate=approximate)]}


@register_op("relu")
def _relu(ctx, ins, attrs):
    return {"Out": [torch.relu(ins["X"][0])]}


@register_op("tanh")
def _tanh(ctx, ins, attrs):
    return {"Out": [torch.tanh(ins["X"][0])]}
