"""Activation ops."""
from __future__ import annotations

import torch.nn.functional as F

from ..core.registry import register_op


@register_op("gelu")
def _gelu(ctx, ins, attrs):
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": [F.gelu(ins["X"][0], approximate=approximate)]}
