"""LayerHelper: shared plumbing for layers.* graph builders.

Creates parameters in the startup program (with their init ops) and the
main program, appends compute ops to the main program, and applies
default initializers, bias and activation. Inside ``dygraph.guard()`` a
layer's output vars are unbound ``VarBase``s and its ops run at once
through ``dygraph.trace_op``, their name-keyed slots resolved through
the guard's var map; a layer with parameters (``fc``, ``embedding``,
...) then raises the JAX package's KeyError, since its parameters live
in the static programs.
"""
from __future__ import annotations

from .framework import (ParamAttr, default_main_program,
                        default_startup_program, unique_name)
from .initializer import Constant, Xavier

__all__ = ["LayerHelper"]

# Ops through which a sequence-lengths link (program.lod_link) passes
# from an input to the outputs: those that keep the [batch, time] dims of
# their primary input. The sequence layers find a ragged input's lengths
# var through the link, so a program never names the lengths.
_LOD_PRESERVING = {
    "lookup_table", "lookup_table_v2", "cast", "scale", "dropout",
    "relu", "tanh", "sigmoid", "gelu", "leaky_relu", "elu", "selu",
    "softsign", "softplus", "swish", "hard_swish", "brelu", "abs",
    "square", "sqrt", "rsqrt", "exp", "log", "pow", "relu6", "clip",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "layer_norm", "softmax", "log_softmax",
    "sequence_softmax", "sequence_reverse", "emb_eltwise_layernorm",
    # the recurrent ops keep [batch, time] (dynamic_lstmp is "lstm" too)
    "lstm", "gru",
}
# output slots that never carry sequence data
_LOD_AUX_SLOTS = {"Mask", "MaxIndex", "Mean", "Variance", "SavedMean",
                  "SavedVariance", "XShape", "MeanOut", "VarianceOut"}


def _propagate_lod_link(block, op_type, inputs, outputs, attrs):
    prog = block.program
    if not prog.lod_link:
        return
    if op_type == "mul":
        # keeps [b, t] only when x is flattened after dim >= 2
        if (attrs or {}).get("x_num_col_dims", 1) < 2:
            return
    elif op_type == "concat":
        # a feature-axis concat keeps [b, t]; a batch or time one does not
        if (attrs or {}).get("axis", 0) in (0, 1):
            return
    elif op_type not in _LOD_PRESERVING:
        return
    src = None
    for names in (inputs or {}).values():
        for n in names or []:
            if n in prog.lod_link:
                src = prog.lod_link[n]
                break
        if src:
            break
    if not src:
        return
    for slot, names in (outputs or {}).items():
        if slot in _LOD_AUX_SLOTS:
            continue
        for n in names or []:
            prog.lod_link.setdefault(n, src)


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        self.name = kwargs.get("name") or unique_name.generate(layer_type)

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or \
            default_startup_program()

    @property
    def block(self):
        return self.main_program.current_block()

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = ParamAttr._to_attr(attr)
        name = attr.name or unique_name.generate(
            f"{self.name}.{'b' if is_bias else 'w'}")
        init = attr.initializer or default_initializer or \
            (Constant(0.0) if is_bias else Xavier())
        shape = [int(s) for s in shape]
        # the parameter lives in BOTH programs: startup (with its init
        # op) and main (as an input to compute ops)
        sp = self.startup_program.global_block()
        sv = sp.create_parameter(name, shape, dtype, trainable=attr.trainable)
        init(sv, sp)
        return self.block.program.global_block().create_parameter(
            name, shape, dtype, trainable=attr.trainable,
            regularizer=attr.regularizer,
            optimize_attr={"learning_rate": attr.learning_rate},
            do_model_average=attr.do_model_average)

    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient=False):
        from . import dygraph
        if dygraph.enabled():
            return dygraph.VarBase(None, stop_gradient=stop_gradient)
        return self.block.create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            dtype=dtype, stop_gradient=stop_gradient)

    def append_op(self, **kwargs):
        from . import dygraph
        if dygraph.enabled():
            vm = dygraph._state["var_map"]

            def resolve(slot_map):
                out = {}
                for slot, items in (slot_map or {}).items():
                    vs = []
                    for it in items or []:
                        if isinstance(it, dygraph.VarBase):
                            vs.append(it)
                        elif it in vm:
                            vs.append(vm[it])
                        else:
                            raise KeyError(
                                f"dygraph var {it!r} not found for "
                                f"{kwargs['type']}.{slot}")
                    out[slot] = vs
                return out

            return dygraph.trace_op(kwargs["type"],
                                    resolve(kwargs.get("inputs")),
                                    kwargs.get("attrs") or {},
                                    out_vars=resolve(kwargs.get("outputs")))
        _propagate_lod_link(self.block, kwargs["type"],
                            kwargs.get("inputs"), kwargs.get("outputs"),
                            kwargs.get("attrs"))
        return self.block.append_op(
            kwargs["type"], inputs=kwargs.get("inputs"),
            outputs=kwargs.get("outputs"), attrs=kwargs.get("attrs"))

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if bias_attr is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var.name], "Y": [b.name]},
                       outputs={"Out": [out.name]},
                       attrs={"axis": dim_start})
        return out

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, dict):
            act = dict(act)
            act_type = act.pop("type")
            act_attrs = act
        else:
            act_type, act_attrs = act, {}
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var.name]},
                       outputs={"Out": [out.name]}, attrs=act_attrs)
        return out
