"""layers.control_flow — the comparison builders and ``increment``."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["increment", "less_equal", "equal"]


def increment(x, value=1.0, in_place=True):
    """Out = X + value in X's dtype; in place, Out is X's own var (a step
    counter)."""
    helper = LayerHelper("increment")
    out_name = x.name if in_place else \
        helper.create_variable_for_type_inference(x.dtype).name
    helper.append_op(type="increment", inputs={"X": [x.name]},
                     outputs={"Out": [out_name]},
                     attrs={"step": float(value)})
    return x.block.var(out_name)


def _cmp(op_type):
    def layer(x, y, cond=None):
        """Out = X op Y, a bool var (Y broadcast to X by trailing
        alignment)."""
        helper = LayerHelper(op_type)
        if cond is None:
            cond = helper.create_variable_for_type_inference("bool", True)
        helper.append_op(type=op_type,
                         inputs={"X": [x.name], "Y": [y.name]},
                         outputs={"Out": [cond.name]})
        return cond
    layer.__name__ = op_type
    return layer


less_equal = _cmp("less_equal")
equal = _cmp("equal")
