"""Optimizer update ops: sgd, momentum, adam and adamw.

Each op consumes Param and its accumulators and writes *Out slots that
name the same vars. Where the JAX package donates the state buffers to
XLA, the port updates the Scope's tensors in place (the executor runs
training programs under ``torch.no_grad()``), so a step allocates no
second copy of the parameters or moments. Each update evaluates the
JAX package's expression in the same order.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


@register_op("sgd", inplace=True)
def _sgd(ctx, ins, attrs):
    # p -= lr * g
    p = ins["Param"][0]
    p.sub_(_lr(ins) * ins["Grad"][0])
    return {"ParamOut": [p]}


@register_op("momentum", inplace=True)
def _momentum(ctx, ins, attrs):
    # v = mu * v + g; p -= lr * v, or with Nesterov p -= (g + mu * v) * lr
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    mu = attrs.get("mu", 0.9)
    lr = _lr(ins)
    v.mul_(mu).add_(g)
    if attrs.get("use_nesterov", False):
        p.sub_((g + mu * v) * lr)
    else:
        p.sub_(lr * v)
    return {"ParamOut": [p], "VelocityOut": [v]}


def _adam_step(ins, attrs):
    """Adam's moment and beta-power updates, in place. Returns (the
    update step lr_t * m / (sqrt(v) + eps), the base learning rate, the
    outputs)."""
    g = ins["Grad"][0]
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p_t, b2p_t = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    b1p, b2p = b1p_t.reshape(()), b2p_t.reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    base_lr = _lr(ins)
    lr = base_lr * torch.sqrt(1 - b2p) / (1 - b1p)
    m1.mul_(b1).add_((1 - b1) * g)
    m2.mul_(b2).add_((1 - b2) * g * g)
    step = lr * m1 / (torch.sqrt(m2) + eps)
    b1p_t.mul_(b1)
    b2p_t.mul_(b2)
    return step, base_lr, {
        "ParamOut": [ins["Param"][0]], "Moment1Out": [m1],
        "Moment2Out": [m2], "Beta1PowOut": [b1p_t], "Beta2PowOut": [b2p_t]}


@register_op("adam", inplace=True)
def _adam(ctx, ins, attrs):
    step, _, outs = _adam_step(ins, attrs)
    ins["Param"][0].sub_(step)
    return outs


@register_op("adamw", inplace=True)
def _adamw(ctx, ins, attrs):
    # decoupled weight decay: p -= lr_t * m / (sqrt(v) + eps) + lr * wd * p
    p = ins["Param"][0]
    step, base_lr, outs = _adam_step(ins, attrs)
    p.copy_(p - step - base_lr * attrs.get("coeff", 0.01) * p)
    return outs
