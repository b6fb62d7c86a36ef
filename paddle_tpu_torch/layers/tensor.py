"""layers.tensor — the creation and conversion builders the training
path uses (global vars for optimizer state, cast for mixed precision)."""
from __future__ import annotations

from ..framework import (default_main_program, default_startup_program,
                         unique_name)
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["create_global_var", "cast"]


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
