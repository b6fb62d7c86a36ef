"""Activation and unary math ops: the 40 of the JAX package's
activations.py, each one torch expression. As in the JAX registry, none
marks a slot non-differentiable: floor, ceil, round and sign have zero
gradients by autograd's own rules. Where torch's own function differs
at a point from the JAX package's formula (leaky_relu's gradient at 0,
softplus's linear cut-off above 20), that formula is written out."""
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


@register_op("sigmoid")
def _sigmoid(ctx, ins, attrs):
    return {"Out": [torch.sigmoid(ins["X"][0])]}


def _unary(name, fn):
    @register_op(name)
    def _low(ctx, ins, attrs, _fn=fn):
        return {"Out": [_fn(ins["X"][0], attrs)]}
    return _low


_unary("exp", lambda x, a: torch.exp(x))
_unary("abs", lambda x, a: torch.abs(x))
_unary("ceil", lambda x, a: torch.ceil(x))
_unary("floor", lambda x, a: torch.floor(x))
_unary("cos", lambda x, a: torch.cos(x))
_unary("reciprocal", lambda x, a: 1.0 / x)
_unary("square", lambda x, a: torch.square(x))
_unary("sqrt", lambda x, a: torch.sqrt(x))
_unary("pow", lambda x, a: torch.pow(x, a.get("factor", 1.0)))
_unary("sign", lambda x, a: torch.sign(x))
_unary("logsigmoid", lambda x, a: F.logsigmoid(x))
_unary("atan", lambda x, a: torch.atan(x))
_unary("rsqrt", lambda x, a: torch.rsqrt(x))
_unary("acos", lambda x, a: torch.acos(x))
_unary("sin", lambda x, a: torch.sin(x))
_unary("asin", lambda x, a: torch.asin(x))
_unary("round", lambda x, a: torch.round(x))  # half to even, as jnp
_unary("log", lambda x, a: torch.log(x))
_unary("relu6", lambda x, a: torch.clamp(x, 0, a.get("threshold", 6.0)))
_unary("softplus", lambda x, a: torch.logaddexp(x, x.new_zeros(())))
_unary("softsign", lambda x, a: F.softsign(x))
_unary("tanh_shrink", lambda x, a: x - torch.tanh(x))
_unary("elu", lambda x, a: F.elu(x, alpha=a.get("alpha", 1.0)))
_unary("leaky_relu", lambda x, a: torch.where(
    x >= 0, x, a.get("alpha", 0.02) * x))
_unary("brelu", lambda x, a: torch.clamp(
    x, a.get("t_min", 0.0), a.get("t_max", 24.0)))
_unary("soft_relu", lambda x, a: torch.log(1 + torch.exp(torch.clamp(
    x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))))
_unary("stanh", lambda x, a: a.get("scale_b", 1.7159) *
       torch.tanh(a.get("scale_a", 0.67) * x))


def _softshrink(x, a):
    lam = a.get("lambda", 0.5)
    zero = x.new_zeros(())
    return torch.where(x > lam, x - lam, torch.where(x < -lam, x + lam,
                                                     zero))


_unary("softshrink", _softshrink)
_unary("hard_shrink", lambda x, a: torch.where(
    torch.abs(x) > a.get("threshold", 0.5), x, x.new_zeros(())))
_unary("hard_sigmoid", lambda x, a: torch.clamp(
    a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0))
_unary("swish", lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x))
_unary("hard_swish", lambda x, a: x * torch.clamp(
    x + a.get("offset", 3.0), 0, a.get("threshold", 6.0))
    / a.get("scale", 6.0))
_unary("thresholded_relu", lambda x, a: torch.where(
    x > a.get("threshold", 1.0), x, x.new_zeros(())))
_unary("erf", lambda x, a: torch.erf(x))
_unary("logical_not", lambda x, a: torch.logical_not(x))


def _maxout(x, a):
    """The max over each of `groups`-wide runs of channels on `axis`."""
    groups, axis = a.get("groups", 1), a.get("axis", 1)
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // groups, groups]
    return torch.amax(x.reshape(shape), dim=axis + 1)


_unary("maxout", _maxout)
