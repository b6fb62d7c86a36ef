"""Dygraph functional helpers (reference dygraph/base.py)."""
from __future__ import annotations

from . import _run_backward

__all__ = ["grad"]


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad-style entry, as the JAX package runs it: one more
    backward() from outputs[0], whose gradients of `inputs` are returned
    while their `.grad` is restored. Like the JAX package's, the
    backward also adds to the `.grad` of every other var it reaches."""
    outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    saved = {id(p): p.grad for p in inputs}
    for p in inputs:
        p.grad = None
    _run_backward(outputs[0])
    out = [p.grad for p in inputs]
    for p in inputs:
        p.grad = saved[id(p)]
    return out
