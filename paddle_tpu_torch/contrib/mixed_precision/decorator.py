"""AMP decorator: the bf16 program rewrite.

``rewrite_program`` inserts casts so that white-list ops consume bf16
and black-list ops consume fp32, exactly as the JAX package's does (same
cast ops, var names and dtypes, so the two packages' programs stay
byte-identical). Master weights stay fp32 in the Scope: the cast ops'
gradients return fp32 gradients to the parameters.

Loss scaling as the JAX package does it: with ``init_loss_scaling`` other
than 1, ``backward`` scales the loss and unscales each gradient with
``scale`` ops, before ``apply_gradients`` (so the regularizers and the
gradient clip see unscaled float32 gradients). bf16 has float32's range,
so dynamic loss scaling degenerates to the static scale; its arguments
are taken for source compatibility.
"""
from __future__ import annotations

from ...backward import append_backward
from ...framework import Operator, unique_name
from .fp16_lists import AutoMixedPrecisionLists

__all__ = ["decorate", "OptimizerWithMixedPrecision", "rewrite_program"]


def _cast_var(block, name, dst_dtype, cache):
    key = (name, dst_dtype)
    if key in cache:
        return cache[key]
    src = block.var(name)
    out_name = unique_name.generate(f"{name}.cast_{dst_dtype}")
    block.create_var(name=out_name, shape=src.shape, dtype=dst_dtype,
                     stop_gradient=src.stop_gradient)
    cast_op = Operator(block, "cast", {"X": [name]}, {"Out": [out_name]},
                       {"out_dtype": dst_dtype})
    cache[key] = (out_name, cast_op)
    return cache[key]


def rewrite_program(main_prog, amp_lists=None):
    """Insert casts so white-list ops consume bf16 and black-list ops
    consume fp32. Operates on the forward program in place, before
    backward is appended (grads then flow through the casts)."""
    amp_lists = amp_lists or AutoMixedPrecisionLists()
    block = main_prog.global_block()
    cache = {}
    new_ops = []
    # dtype environment: var name -> current dtype as ops execute
    dtype_env = {n: v.dtype for n, v in block.vars.items()}

    added_casts = set()

    def mark_outputs(op, dtype):
        for n in op.output_names():
            if n and dtype_env.get(n) == "float32" and dtype == "bfloat16":
                dtype_env[n] = "bfloat16"
                v = block._find_var_recursive(n)
                if v is not None:
                    v.dtype = "bfloat16"

    for op in block.ops:
        if op.type in amp_lists.white_list:
            want = "bfloat16"
        elif op.type in amp_lists.black_list:
            want = "float32"
        else:
            # gray op: type promotion — output is bf16 only when every
            # float input is bf16 (bf16 + fp32 promotes to fp32)
            fdts = [dtype_env.get(n, block.var(n).dtype)
                    for n in op.input_names() if n
                    and dtype_env.get(n, block.var(n).dtype)
                    in ("float32", "bfloat16")]
            if fdts and all(d == "bfloat16" for d in fdts):
                mark_outputs(op, "bfloat16")
            new_ops.append(op)
            continue
        for slot, names in op.inputs.items():
            for i, n in enumerate(names):
                if not n:
                    continue
                cur = dtype_env.get(n, block.var(n).dtype)
                if cur == want or cur not in ("float32", "bfloat16"):
                    continue
                out_name, cast_op = _cast_var(block, n, want, cache)
                if id(cast_op) not in added_casts:
                    added_casts.add(id(cast_op))
                    new_ops.append(cast_op)
                names[i] = out_name
                dtype_env[out_name] = want
        new_ops.append(op)
        # white-list outputs become bf16 (lowerings keep input dtype)
        mark_outputs(op, want)
    block.ops = new_ops
    main_prog._fp_cache = None
    return main_prog


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=1.0,
                 use_dynamic_loss_scaling=False, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.8):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._loss_scaling = float(init_loss_scaling)

    def get_loss_scaling(self):
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        from ... import layers
        rewrite_program(loss.block.program, self._amp_lists)
        scaled = loss
        if self._loss_scaling != 1.0:
            scaled = layers.scale(loss, scale=self._loss_scaling)
        params_grads = append_backward(scaled, parameter_list, no_grad_set,
                                       callbacks)
        if self._loss_scaling != 1.0:
            inv = 1.0 / self._loss_scaling
            params_grads = [(p, layers.scale(g, scale=inv))
                            for p, g in params_grads]
        return params_grads

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list,
                                     no_grad_set)
        opt_ops = self._optimizer.apply_gradients(params_grads)
        return opt_ops, params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=False):
    """fluid.contrib.mixed_precision.decorate, bf16: static loss scaling
    (dynamic scaling degenerates to it)."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio)
