"""Weight-decay regularizers, applied by ``Optimizer.apply_gradients``
as grad := grad + d(reg)/d(param) with graph ops: L2 as ``grad + coeff *
param``, L1 as ``grad + coeff * sign(param)`` (a ``scale`` and an
``elementwise_add``, as the JAX package builds them)."""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer"]


class L2DecayRegularizer:
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad):
        from .layers.math_ops import elementwise_add
        from .layers.nn import scale
        decay = scale(param, scale=self.coeff)
        return elementwise_add(grad, decay)


class L1DecayRegularizer:
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def append_regularization_op(self, param, grad):
        from .layers.math_ops import elementwise_add
        from .layers.nn import scale, sign
        decay = scale(sign(param), scale=self.coeff)
        return elementwise_add(grad, decay)


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
