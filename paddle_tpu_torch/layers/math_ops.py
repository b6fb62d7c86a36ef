"""Elementwise layer builders."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["elementwise_add"]


def elementwise_add(x, y, axis=-1, act=None, name=None):
    """Out = X + Y with Y's dims aligned to X from `axis` (-1 = trailing
    alignment)."""
    helper = LayerHelper("elementwise_add", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="elementwise_add",
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return helper.append_activation(out)
