"""Elementwise layer builders."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["elementwise_add", "elementwise_mul"]


def _binary_layer(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        """Out = X op Y with Y's dims aligned to X from `axis` (-1 =
        trailing alignment)."""
        helper = LayerHelper(op_type, act=act, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type,
                         inputs={"X": [x.name], "Y": [y.name]},
                         outputs={"Out": [out.name]}, attrs={"axis": axis})
        return helper.append_activation(out)
    layer.__name__ = op_type
    return layer


elementwise_add = _binary_layer("elementwise_add")
elementwise_mul = _binary_layer("elementwise_mul")
