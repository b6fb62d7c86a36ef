"""Op registry: op type -> PyTorch lowering + metadata.

Every op registers ONE lowering, a plain function on tensors:
``lower(ctx, ins, attrs) -> outs`` with ``ins``/``outs`` mapping slot
names to lists of tensors. A lowering that reaches a hand-written kernel
calls the kernel's wrapper, which launches it for CUDA tensors.

Gradients: ``backward.append_backward`` gives every differentiated
forward op one ``grad::generic`` op, whose lowering (core/lowering.py)
runs torch autograd over the tensors the forward op recorded when it ran.
Ops marked ``inplace`` (optimizer updates) are never differentiated.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence


@dataclasses.dataclass
class OpDef:
    type: str
    # lower(ctx, ins, attrs) -> outs; {slot: [tensors]} both ways
    lower: Callable
    # Input slots that are not differentiable (indices, labels, masks...).
    nondiff_inputs: Sequence[str] = ()
    # Output slots that are not differentiable.
    nondiff_outputs: Sequence[str] = ()
    # Draws random numbers through ctx.generator (dropout, initializers).
    stateful: bool = False
    # Mutates persistable state (optimizer updates): its outputs may alias
    # inputs by var name (ParamOut == Param); backward skips it.
    inplace: bool = False
    # Semantic version, saved with programs and checked on load.
    version: int = 1
    # Static shape rule for the analysis (analysis/shape_infer.py):
    # abstract_eval(op, in_specs, block) -> {out name: spec}, for an op
    # whose lowering cannot run on meta tensors (control flow reads its
    # predicate).
    abstract_eval: Optional[Callable] = None


class OpRegistry:
    def __init__(self):
        self._ops: Dict[str, OpDef] = {}

    def register(self, opdef: OpDef):
        if opdef.type in self._ops:
            raise ValueError(f"op {opdef.type!r} already registered")
        self._ops[opdef.type] = opdef
        return opdef

    def get(self, op_type: str, where: Optional[str] = None) -> OpDef:
        """Look up an OpDef; `where` ("{block}/{op_idx}") names the
        program op when the lookup happens during lowering."""
        try:
            return self._ops[op_type]
        except KeyError:
            import difflib
            close = difflib.get_close_matches(
                op_type, list(self._ops), n=3, cutoff=0.6)
            hint = ("; did you mean " +
                    ", ".join(repr(c) for c in close) + "?") if close \
                else ""
            at = f" (at block/op {where})" if where else ""
            raise NotImplementedError(
                f"op {op_type!r} has no registered PyTorch lowering "
                f"({len(self._ops)} ops registered{hint}){at}"
            ) from None

    def has(self, op_type: str) -> bool:
        return op_type in self._ops

    def types(self):
        return sorted(self._ops)


REGISTRY = OpRegistry()


def register_op(op_type, *, nondiff_inputs=(), nondiff_outputs=(),
                stateful=False, inplace=False, version=1):
    """Decorator: @register_op("mul") def _mul(ctx, ins, attrs): ..."""

    def deco(fn):
        REGISTRY.register(OpDef(
            type=op_type, lower=fn,
            nondiff_inputs=tuple(nondiff_inputs),
            nondiff_outputs=tuple(nondiff_outputs),
            stateful=stateful, inplace=inplace, version=version))
        return fn

    return deco


def register_abstract_eval(op_type):
    """Attach a static shape rule to a registered op:
    ``@register_abstract_eval("while") def _specs(op, in_specs, block)``."""

    def deco(fn):
        REGISTRY.get(op_type).abstract_eval = fn
        return fn

    return deco
