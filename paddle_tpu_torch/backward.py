"""Declarative autodiff over the Program IR.

The JAX package's ``append_backward``, op for op: walk the forward ops
in reverse, give each differentiated op one ``grad::generic`` op, sum
duplicate gradients with ``sum``, prune no-grad paths. The program it
builds is the JAX package's to the byte (same ops, names and attrs).

How a ``grad::generic`` op runs differs: the JAX package re-lowers the
forward op under ``jax.vjp`` and relies on XLA to merge the recomputed
forward with the original. Eager PyTorch merges nothing, so here the
executor records each differentiated forward op's autograd graph when
the op runs, and the grad op runs ``torch.autograd.grad`` over that
record (core/lowering.py). No forward runs twice, and a dropout mask is
the one the forward drew.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from .core.dtypes import is_floating
from .core.registry import REGISTRY
from .framework import Variable, grad_var_name

__all__ = ["append_backward", "gradients"]


def _diff_input_vars(op, opdef):
    for slot, names in op.inputs.items():
        if slot in opdef.nondiff_inputs:
            continue
        for n in names:
            if n:
                yield slot, n


def _requires_grad_set(block, ops, no_grad: Set[str]) -> Set[str]:
    """Forward propagation: which vars can carry gradient back to a param."""
    # Seed: every float var that has not opted out of gradients. Data vars
    # default to stop_gradient=True (layers/io.py), so this reaches exactly
    # the params and anything the caller wants grads for (gradients()).
    req = set()
    for v in block.vars.values():
        if not v.stop_gradient and is_floating(v.dtype) \
                and v.name not in no_grad:
            req.add(v.name)
    for op in ops:
        if not REGISTRY.has(op.type):
            continue
        opdef = REGISTRY.get(op.type)
        if opdef.inplace:
            continue  # optimizer ops are never differentiated
        if any(n in req for _, n in _diff_input_vars(op, opdef)):
            for slot, names in op.outputs.items():
                if slot in opdef.nondiff_outputs:
                    continue
                for n in names:
                    if not n or n in no_grad:
                        continue
                    v = block._find_var_recursive(n)
                    if v is not None and is_floating(v.dtype) \
                            and not v.stop_gradient:
                        req.add(n)
    return req


def _create_grad_var(block, fwd_name) -> str:
    gname = grad_var_name(fwd_name)
    if not block.has_var(gname):
        fv = block.var(fwd_name)
        block.create_var(name=gname, shape=fv.shape, dtype=fv.dtype,
                         stop_gradient=True)
    return gname


def append_backward(loss: Variable, parameter_list=None,
                    no_grad_set: Optional[Set[str]] = None,
                    callbacks=None):
    """Append grad ops for d(loss)/d(params); returns [(param, grad_var)]."""
    block = loss.block
    no_grad = set(no_grad_set or ())
    for v in block.vars.values():
        if v.stop_gradient:
            no_grad.add(v.name)
    no_grad.discard(loss.name)

    fwd_ops = list(block.ops)
    req = _requires_grad_set(block, fwd_ops, no_grad)
    req.add(loss.name)

    # d(loss)/d(loss) = 1
    loss_grad = _create_grad_var(block, loss.name)
    block.append_op(
        "fill_any_like", inputs={"X": [loss.name]},
        outputs={"Out": [loss_grad]}, attrs={"value": 1.0},
        infer_shape=False)

    # var -> list of partial-grad var names contributed by consumer grad ops
    partials: Dict[str, List[str]] = {loss.name: [loss_grad]}
    grad_of: Dict[str, str] = {}

    def finalize(name) -> Optional[str]:
        """All consumers processed: materialise the summed gradient."""
        if name in grad_of:
            return grad_of[name]
        parts = partials.get(name, [])
        if not parts:
            return None
        gname = grad_var_name(name)
        if len(parts) == 1:
            grad_of[name] = parts[0]
            return parts[0]
        if not block.has_var(gname):
            _create_grad_var(block, name)
        block.append_op("sum", inputs={"X": parts},
                        outputs={"Out": [gname]}, infer_shape=False)
        grad_of[name] = gname
        return gname

    for op in reversed(fwd_ops):
        opdef = REGISTRY.get(op.type)
        if opdef.inplace:
            continue
        # Collect available output grads.
        out_grads = {}
        for slot, names in op.outputs.items():
            if slot in opdef.nondiff_outputs:
                continue
            gnames = [finalize(n) if n else None for n in names]
            if any(g is not None for g in gnames):
                out_grads[slot] = gnames
        if not out_grads:
            continue
        # Which inputs need grads from this op?
        in_grad_slots = {}
        for slot, names in op.inputs.items():
            if slot in opdef.nondiff_inputs:
                continue
            targets = []
            for n in names:
                if n and n in req and n not in no_grad:
                    v = block._find_var_recursive(n)
                    if v is not None and is_floating(v.dtype):
                        targets.append(n)
                        continue
                targets.append(None)
            if any(t is not None for t in targets):
                in_grad_slots[slot] = targets
        if not in_grad_slots:
            continue

        g_inputs = {}
        for slot, names in op.inputs.items():
            g_inputs[slot] = list(names)
        for slot, gnames in out_grads.items():
            g_inputs[slot + "@GRAD"] = [g or "" for g in gnames]

        g_outputs = {}
        for slot, targets in in_grad_slots.items():
            outs = []
            for n in targets:
                if n is None:
                    outs.append("")
                    continue
                pname = grad_var_name(n)
                if n in partials:  # not the first contribution: rename + sum
                    pname = f"{pname}@RENAME@{op.id}"
                if not block.has_var(pname):
                    fv = block.var(n)
                    block.create_var(name=pname, shape=fv.shape,
                                     dtype=fv.dtype, stop_gradient=True)
                partials.setdefault(n, []).append(pname)
                outs.append(pname)
            g_outputs[slot + "@GRAD"] = outs

        block.append_op(
            "grad::generic", inputs=g_inputs, outputs=g_outputs,
            attrs={
                "fwd_type": op.type,
                "fwd_attrs": dict(op.attrs),
                "fwd_in_slots": {s: len(v) for s, v in op.inputs.items()},
                "fwd_out_slots": list(op.outputs.keys()),
                "fwd_out_grad_mask": {
                    s: [g is not None for g in gn]
                    for s, gn in out_grads.items()},
                "fwd_id": op.id,
            }, infer_shape=False)

    # Finalize gradients for parameters.
    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]
    params_grads = []
    for p in params:
        if p.name in no_grad:
            continue
        g = finalize(p.name)
        if g is None:
            continue
        gv = block.var(g)
        params_grads.append((p, gv))
    return params_grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """fluid.gradients: d(target)/d(inputs) as grad vars (None where an
    input does not reach the target)."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if len(targets) != 1:
        raise NotImplementedError("gradients() supports a single target")
    for iv in inputs:
        iv.stop_gradient = False
    append_backward(targets[0], parameter_list=None, no_grad_set=no_grad_set)
    block = targets[0].block
    outs = []
    for iv in inputs:
        gname = grad_var_name(iv.name)
        outs.append(block.var(gname) if block.has_var(gname) else None)
    return outs
