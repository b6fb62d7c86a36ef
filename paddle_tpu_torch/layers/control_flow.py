"""layers.control_flow — the comparison builders."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["less_equal"]


def less_equal(x, y, cond=None):
    """Out = X <= Y, a bool var (Y broadcast to X by trailing
    alignment)."""
    helper = LayerHelper("less_equal")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", True)
    helper.append_op(type="less_equal",
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [cond.name]})
    return cond
