"""layers.tensor — the creation and conversion builders the training
and decode paths use (global vars for optimizer and decode state, cast
for mixed precision, concat, constants, ranges and assign)."""
from __future__ import annotations

import math

from ..framework import (Variable, default_main_program,
                         default_startup_program, unique_name)
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["create_global_var", "cast", "concat", "assign", "fill_constant",
           "range", "sums"]

from .nn import sums  # noqa: F401,E402


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
    a decode step writes its persistable caches."""
    if not isinstance(input, Variable):
        raise NotImplementedError(
            "assign of a numpy array (assign_value) is not ported yet")
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="assign", inputs={"X": [input.name]},
                     outputs={"Out": [output.name]})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(type="fill_constant", outputs={"Out": [out.name]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": dtype, "value": float(value)})
    return out


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
