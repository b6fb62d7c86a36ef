"""Elementwise layer builders, and the Variable operator sugar's builder
(``elementwise_binary``): a scalar operand becomes one ``scale`` op with
the JAX package's attrs, so programs stay byte-identical."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
           "elementwise_binary"]


def _scalar_op(op_type, x, scalar, reverse=False):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(x.dtype)
    if op_type == "elementwise_add":
        attrs = {"scale": 1.0, "bias": float(scalar)}
    elif op_type == "elementwise_sub":
        attrs = ({"scale": -1.0, "bias": float(scalar)} if reverse
                 else {"scale": 1.0, "bias": -float(scalar)})
    elif op_type == "elementwise_mul":
        attrs = {"scale": float(scalar), "bias": 0.0}
    elif op_type == "elementwise_div" and not reverse:
        attrs = {"scale": 1.0 / float(scalar), "bias": 0.0}
    else:
        raise NotImplementedError(f"scalar {op_type} reverse={reverse}")
    helper.append_op(type="scale", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def elementwise_binary(op_type, x, y, axis=-1, act=None, name=None):
    """Out = X op Y with Y's dims aligned to X from `axis` (-1 =
    trailing alignment); a Python number on either side is a scalar."""
    from ..framework import Variable
    if not isinstance(y, Variable):
        return _scalar_op(op_type, x, y)
    if not isinstance(x, Variable):
        return _scalar_op(op_type, y, x, reverse=True)
    helper = LayerHelper(op_type, act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type,
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return helper.append_activation(out)


def _make(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        return elementwise_binary(op_type, x, y, axis=axis, act=act,
                                  name=name)
    layer.__name__ = op_type
    return layer


elementwise_add = _make("elementwise_add")
elementwise_sub = _make("elementwise_sub")
elementwise_mul = _make("elementwise_mul")
elementwise_div = _make("elementwise_div")
elementwise_max = _make("elementwise_max")
elementwise_min = _make("elementwise_min")
elementwise_pow = _make("elementwise_pow")
elementwise_mod = _make("elementwise_mod")
elementwise_floordiv = _make("elementwise_floordiv")
