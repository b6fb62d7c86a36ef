"""Recurrent cells: gru_unit."""
from __future__ import annotations

import torch

from ..core.registry import register_op

_ACT = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "identity": lambda x: x, "": lambda x: x}


def _act(name):
    return _ACT[name if isinstance(name, str) else "sigmoid"]


@register_op("gru_unit")
def _gru_unit(ctx, ins, attrs):
    """One GRU step. Input [B, 3D] (pre-projected) plus Bias [1, 3D],
    HiddenPrev [B, D], Weight [D, 3D] ([:, :2D] the update and reset
    gates, [:, 2D:] the candidate). h = u * c + (1 - u) * h_prev, or
    with `origin_mode` u * h_prev + (1 - u) * c. Gate is [u, r, c]."""
    x = ins["Input"][0]
    h_prev = ins["HiddenPrev"][0]
    w = ins["Weight"][0]
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    cand_act = _act(attrs.get("activation", "tanh"))
    d = h_prev.shape[-1]
    if "Bias" in ins:
        x = x + ins["Bias"][0].reshape(1, 3 * d)
    g2 = x[:, :2 * d] + h_prev @ w[:, :2 * d]
    u = gate_act(g2[:, :d])
    r = gate_act(g2[:, d:])
    rhp = r * h_prev
    c = cand_act(x[:, 2 * d:] + rhp @ w[:, 2 * d:])
    if attrs.get("origin_mode", False):
        h = c + u * (h_prev - c)
    else:
        h = u * (c - h_prev) + h_prev
    return {"Gate": [torch.cat([u, r, c], dim=1)],
            "ResetHiddenPrev": [rhp], "Hidden": [h]}
