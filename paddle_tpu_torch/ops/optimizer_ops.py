"""Optimizer update ops: adamw.

Each op consumes Param and its accumulators and writes *Out slots that
name the same vars. Where the JAX package donates the state buffers to
XLA, the port updates the Scope's tensors in place (the executor runs
training programs under ``torch.no_grad()``), so a step allocates no
second copy of the parameters or moments.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


@register_op("adamw", inplace=True)
def _adamw(ctx, ins, attrs):
    # decoupled weight decay: p -= lr_t * m / (sqrt(v) + eps) + lr * wd * p
    p, g = ins["Param"][0], ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p_t, b2p_t = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1p, b2p = b1p_t.reshape(()), b2p_t.reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    wd = attrs.get("coeff", 0.01)
    base_lr = _lr(ins)
    lr = base_lr * torch.sqrt(1 - b2p) / (1 - b1p)
    m1.mul_(b1).add_((1 - b1) * g)
    m2.mul_(b2).add_((1 - b2) * g * g)
    p.copy_(p - lr * m1 / (torch.sqrt(m2) + eps) - base_lr * wd * p)
    b1p_t.mul_(b1)
    b2p_t.mul_(b2)
    return {"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
            "Beta1PowOut": [b1p_t], "Beta2PowOut": [b2p_t]}
