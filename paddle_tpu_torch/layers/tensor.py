"""layers.tensor — the creation, conversion and check builders: global
vars, tensors and parameters, cast, concat, constants and fills, ranges,
assign (of a var or a numpy array), argmin/argmax, reverse, diag, eye,
and the finiteness checks."""
from __future__ import annotations

import math

import numpy as np

from ..framework import (Variable, default_main_program,
                         default_startup_program, unique_name)
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["create_tensor", "create_parameter", "create_global_var", "cast",
           "concat", "sums", "assign", "fill_constant",
           "fill_constant_batch_size_like", "argmin", "argmax", "ones",
           "zeros", "reverse", "has_inf", "has_nan", "isfinite", "range",
           "linspace", "zeros_like", "ones_like", "diag", "eye"]

from .nn import sums  # noqa: F401,E402


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.block.create_var(name=helper.name, dtype=dtype,
                                   persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    helper = LayerHelper("create_parameter", param_attr=attr, name=name)
    return helper.create_parameter(helper.param_attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False, name=None):
    """A var filled with `value` by the startup program, visible in the
    main program under the same name."""
    name = name or unique_name.generate("global_var")
    sp = default_startup_program().global_block()
    sv = sp.create_var(name=name, shape=shape, dtype=dtype,
                       persistable=persistable, stop_gradient=True)
    Constant(value)(sv, sp)
    return default_main_program().global_block().create_var(
        name=name, shape=shape, dtype=dtype, persistable=persistable,
        stop_gradient=True)


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="cast", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="concat",
                     inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def assign(input, output=None):
    """Out = X; with `output`, X is written into that (existing) var, as
    a decode step writes its persistable caches. A numpy array (or
    anything np.asarray takes) becomes an assign_value op holding it."""
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(type="assign", inputs={"X": [input.name]},
                         outputs={"Out": [output.name]})
        return output
    arr = np.asarray(input)
    if output is None:
        output = helper.create_variable_for_type_inference(str(arr.dtype))
    helper.append_op(type="assign_value", outputs={"Out": [output.name]},
                     attrs={"shape": list(arr.shape),
                            "dtype": str(arr.dtype), "values": arr})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(type="fill_constant", outputs={"Out": [out.name]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": dtype, "value": float(value)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    """`shape` filled with `value`, its output_dim_idx dim taken from
    input's input_dim_idx dim at run time."""
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": dtype, "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def _arg(op_type, x, axis):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(type=op_type, inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def argmin(x, axis=0):
    return _arg("arg_min", x, axis)


def argmax(x, axis=0):
    return _arg("arg_max", x, axis)


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reverse", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"axis": [axis] if isinstance(axis, int)
                            else list(axis)})
    return out


def _check(op_type):
    """A layer giving one bool about the whole of x."""
    def layer(x):
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference("bool", True)
        helper.append_op(type=op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]})
        return out
    return layer


has_inf = _check("has_inf")
has_nan = _check("has_nan")
isfinite = _check("isfinite")


def range(start, end, step, dtype):
    """[start, end) by step; a static length when all three are
    numbers."""
    helper = LayerHelper("range")
    vals = {}
    for key, v in (("Start", start), ("End", end), ("Step", step)):
        vals[key] = v if isinstance(v, Variable) else \
            fill_constant([1], dtype, v)
    static_len = None
    if not any(isinstance(v, Variable) for v in (start, end, step)):
        static_len = int(max(0, math.ceil((end - start) / step)))
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(type="range",
                     inputs={"Start": [vals["Start"].name],
                             "End": [vals["End"].name],
                             "Step": [vals["Step"].name]},
                     outputs={"Out": [out.name]},
                     attrs={"static_len": static_len})
    return out


def linspace(start, stop, num, dtype):
    """`num` evenly spaced values from start to stop, both included."""
    helper = LayerHelper("linspace")
    s = start if isinstance(start, Variable) else \
        fill_constant([1], dtype, start)
    e = stop if isinstance(stop, Variable) else \
        fill_constant([1], dtype, stop)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(type="linspace",
                     inputs={"Start": [s.name], "Stop": [e.name]},
                     outputs={"Out": [out.name]}, attrs={"num": int(num)})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def ones_like(x, out=None):
    helper = LayerHelper("fill_any_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="fill_any_like", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"value": 1.0})
    return out


def diag(diagonal):
    """A square matrix with `diagonal` on its diagonal."""
    helper = LayerHelper("diag")
    out = helper.create_variable_for_type_inference(diagonal.dtype, True)
    helper.append_op(type="diag", inputs={"Diagonal": [diagonal.name]},
                     outputs={"Out": [out.name]})
    return out


def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32"):
    """The identity matrix, num_rows x num_columns (square by default);
    `batch_shape` is not read, as in the JAX package."""
    helper = LayerHelper("eye")
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(type="eye", outputs={"Out": [out.name]},
                     attrs={"num_rows": num_rows,
                            "num_columns": num_columns or -1,
                            "dtype": dtype})
    return out
