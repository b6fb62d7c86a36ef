"""Gradient clipping: ``ErrorClipByValue``, ``GradientClipByValue``,
``GradientClipByNorm`` and ``GradientClipByGlobalNorm``, applied by
``Optimizer.apply_gradients`` after the regularizers and before the
update ops.

``set_gradient_clip`` is process-global, as in the JAX package: every
optimizer built after it clips, until it is set back to None.
``GradientClipByGlobalNorm`` is one ``squared_l2_norm`` a gradient, then
``sum``, ``sqrt``, ``elementwise_max`` with ``clip_norm``,
``elementwise_div`` and an ``elementwise_mul`` (axis 0) a gradient.
"""
from __future__ import annotations

__all__ = ["set_gradient_clip", "get_gradient_clip", "ErrorClipByValue",
           "GradientClipByValue", "GradientClipByNorm",
           "GradientClipByGlobalNorm"]

_clip_attr = {}


def set_gradient_clip(clip, param_list=None, program=None):
    _clip_attr["default"] = clip


def get_gradient_clip():
    return _clip_attr.get("default")


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max, self.min = max, min if min is not None else -max


class GradientClipByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    def apply(self, params_grads):
        from .layers.nn import clip
        return [(p, clip(g, self.min, self.max)) for p, g in params_grads]


class GradientClipByNorm:
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply(self, params_grads):
        from .layers.nn import clip_by_norm
        return [(p, clip_by_norm(g, self.clip_norm)) for p, g in
                params_grads]


class GradientClipByGlobalNorm:
    """g *= clip_norm / max(global_norm, clip_norm) across ALL grads."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def apply(self, params_grads):
        from .layer_helper import LayerHelper
        from .layers.nn import (elementwise_div, elementwise_max,
                                elementwise_mul, scale, sqrt)
        from .layers.tensor import fill_constant, sums
        helper = LayerHelper("global_norm_clip")
        sq_sums = []
        for _, g in params_grads:
            sq = helper.create_variable_for_type_inference(g.dtype)
            helper.append_op(type="squared_l2_norm",
                             inputs={"X": [g.name]},
                             outputs={"Out": [sq.name]})
            sq_sums.append(sq)
        global_sq = sums(sq_sums)
        global_norm = sqrt(global_sq)
        max_norm = fill_constant([1], "float32", self.clip_norm)
        denom = elementwise_max(global_norm, max_norm)
        factor = elementwise_div(scale(max_norm, 1.0), denom)
        return [(p, elementwise_mul(g, factor, axis=0))
                for p, g in params_grads]
