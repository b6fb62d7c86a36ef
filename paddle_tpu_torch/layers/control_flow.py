"""layers.control_flow — the dense part: the comparison builders,
``is_empty`` and ``increment`` (While, cond and the tensor arrays wait
for ROADMAP §A4)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["increment", "less_than", "less_equal", "greater_than",
           "greater_equal", "equal", "not_equal", "is_empty"]


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


less_than = _cmp("less_than")
less_equal = _cmp("less_equal")
greater_than = _cmp("greater_than")
greater_equal = _cmp("greater_equal")
equal = _cmp("equal")
not_equal = _cmp("not_equal")


def is_empty(x, cond=None):
    """A bool var: whether `x` has no elements."""
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool", True)
    helper.append_op(type="is_empty", inputs={"X": [x.name]},
                     outputs={"Out": [cond.name]})
    return cond
