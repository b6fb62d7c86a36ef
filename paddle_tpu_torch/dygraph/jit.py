"""Dygraph→static capture: the deploy bridge from eager mode.

Reference: python/paddle/fluid/dygraph/jit.py:46 ``TracedLayer.trace``
over imperative/jit/ProgramDescTracer (program_desc_tracer.h:32): re-runs
of the traced layer go through an Executor on the captured Program, and
``save_inference_model`` exports it for serving.

``trace`` records every op run during the traced call into a list that
lives only for that call, whether or not the op needs a gradient, and
replays the list into a Program: parameters become persistable vars
(their values copied into the TracedLayer's scope), the call's inputs
become feeds. (The JAX package captures its gradient tape instead, which
leaves out an op whose inputs need no gradient, and freezes that op's
first output as a constant.)
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["TracedLayer", "trace"]


class TracedLayer:
    def __init__(self, program, feed_names, fetch_names, param_values,
                 place):
        from ..core.scope import Scope
        from ..executor import Executor

        self.program = program
        self._feed_names = feed_names
        self._fetch_names = fetch_names
        self._scope = Scope()
        for n, v in param_values.items():
            self._scope.set(n, v)
        self._exe = Executor(place)

    @staticmethod
    def trace(layer, inputs):
        """Returns (outputs, traced_layer) — reference jit.py TracedLayer
        API. Must run inside dygraph.guard() with gradients on; the
        traced layer runs on the guard's place."""
        from . import _state

        if not (_state["enabled"] and _state["grad"]):
            raise RuntimeError("TracedLayer.trace must run inside "
                               "dygraph.guard() with gradients enabled")
        inputs = list(inputs)
        _state["capture"] = ops = []
        try:
            outputs = layer(*inputs)
        finally:
            _state["capture"] = None
        out_list = outputs if isinstance(outputs, (list, tuple)) \
            else [outputs]
        program, feed_names, fetch_names, params = _capture(
            ops, inputs, out_list)
        return outputs, TracedLayer(program, feed_names, fetch_names,
                                    params, _state["place"])

    def __call__(self, inputs):
        feed = {n: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
                for n, v in zip(self._feed_names, inputs)}
        return self._exe.run(self.program, feed=feed,
                             fetch_list=self._fetch_names,
                             scope=self._scope)

    def save_inference_model(self, dirname, feed=None, fetch=None):
        from .. import io as fio
        from ..core.scope import scope_guard

        with scope_guard(self._scope):
            fio.save_inference_model(
                dirname, self._feed_names,
                [self.program.global_block().var(n)
                 for n in self._fetch_names],
                self._exe, main_program=self.program)


def _capture(ops, inputs, outputs):
    """The traced ops -> Program. Vars keep their eager names; anything
    read before being produced is either a traced input (feed) or a
    parameter (persistable, its value copied)."""
    from ..framework import Program

    program = Program()
    block = program.global_block()
    produced = set()
    params: Dict[str, torch.Tensor] = {}
    input_names = {v.name for v in inputs}

    def ensure_var(v, persistable=False):
        if not block.has_var(v.name):
            block.create_var(name=v.name, shape=tuple(v.shape),
                             dtype=v.dtype, persistable=persistable,
                             stop_gradient=True)

    for v in inputs:
        ensure_var(v)

    for op in ops:
        for vs in op.ins.values():
            for v in vs:
                if v.name in produced or v.name in input_names:
                    ensure_var(v)
                    continue
                # read before written: a captured constant or parameter
                ensure_var(v, persistable=True)
                if v.name not in params:
                    params[v.name] = v.value.detach().clone()
        for vs in op.outs.values():
            for v in vs:
                ensure_var(v)
                produced.add(v.name)
        block.append_op(
            op.op_type,
            inputs={s: [v.name for v in vs] for s, vs in op.ins.items()},
            outputs={s: [v.name for v in vs] for s, vs in op.outs.items()},
            attrs=dict(op.attrs), infer_shape=False)

    feed_names = [v.name for v in inputs]
    fetch_names = [v.name for v in outputs]
    return program, feed_names, fetch_names, params


def trace(layer, inputs):
    """Module-level alias (reference dygraph.jit.trace)."""
    return TracedLayer.trace(layer, inputs)
