"""Constant folding: evaluate compile-time-constant ops on the CPU.

An op folds when its type is on the closed whitelist below, every
input is already a known constant (vacuously true for seeders like
fill_constant), no output is persistable, and the registered lowering
evaluates eagerly without error. Folded chains collapse to a single
`assign_value` per still-needed var (the Operator attr protocol
serializes ndarrays, framework._jsonable_attrs), so a
fill_constant→scale→cast chain becomes one literal.

The whitelist is deliberately conservative — pure, shape-static,
per-element IEEE ops only. No reductions or matmuls (eager vs fused
accumulation order could differ), no stateful/inplace/side-effect ops,
nothing opaque to abstract eval. Bit-exact parity with the unoptimized
program is the contract (tests/test_torch_graph_passes.py).

The port runs its own lowerings on CPU tensors, so a folded value is
what the unfolded op computes on the CPU. The materialized literal takes
the IR's dtype name (``lowering.ir_dtype``: an int64 value reads int32,
as in the JAX package, which folds with 64-bit types off), so the
optimized program is the JAX package's to the byte for IEEE-exact ops
(add, sub, mul, div, sqrt, cast, the shape ops). The transcendental ops
of the whitelist (exp, log, tanh, sigmoid, rsqrt, pow) may differ from
XLA's CPU results in the last place: tests/test_torch_graph_passes.py
holds them within 2 ulp. An op whose value is bfloat16 is not folded:
numpy, which carries the literal, has no bfloat16.
"""
from __future__ import annotations

import numpy as np

from ...core.registry import REGISTRY
from ...monitor import STAT_ADD
from ..graph_utils import (SIDE_EFFECT_OPS, attr_read_names, op_names)
from ..shape_infer import OPAQUE_OPS
from .base import Pass

__all__ = ["ConstantFolding", "FOLDABLE_OPS"]

FOLDABLE_OPS = frozenset({
    # seeders (no inputs)
    "fill_constant", "assign_value", "eye",
    # pure per-element math
    "scale", "cast", "clip", "sign", "abs", "square", "sqrt", "rsqrt",
    "exp", "log", "floor", "ceil", "round", "reciprocal", "relu",
    "tanh", "sigmoid",
    # shape rearrangement (pure data movement)
    "reshape", "unsqueeze", "squeeze", "transpose", "concat", "stack",
    "split", "slice", "expand",
    # binary elementwise (per-element IEEE, no accumulation)
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "minus", "assign",
})

# Folding a huge literal would bloat the program JSON (and its
# fingerprint hash) for no runtime win.
_MAX_FOLD_ELEMS = 1 << 16


def _op_foldable(op, block):
    if op.type not in FOLDABLE_OPS:
        return False
    if op.type in SIDE_EFFECT_OPS or op.type in OPAQUE_OPS:
        return False
    opdef = REGISTRY._ops.get(op.type)
    if opdef is None or opdef.stateful or opdef.inplace:
        return False
    if "sub_block" in op.attrs:
        return False
    outs = op_names(op, "out")
    if not outs:
        return False
    for n in outs:
        v = block._find_var_recursive(n)
        if v is not None and (v.persistable or v.is_data):
            return False
    return True


class ConstantFolding(Pass):
    name = "constant_fold"
    min_level = 1

    def run(self, program, ctx):
        import torch

        from ...core.lowering import LowerCtx, ir_dtype, run_op

        block = program.global_block()
        const_env = {}   # var -> CPU tensor (value at the CURRENT def)
        folded = set()   # op indices to drop
        folded_vals = {}  # op idx -> {out var: np value at THAT def}

        lctx = LowerCtx("cpu")
        for idx, op in enumerate(block.ops):
            ins = op_names(op, "in")
            outs = op_names(op, "out")
            ok = (_op_foldable(op, block)
                  and all(n in const_env for n in ins))
            if ok:
                try:
                    env = {n: const_env[n] for n in ins}
                    with torch.no_grad():
                        run_op(op, env, lctx)
                    tens, vals = {}, {}
                    for n in outs:
                        v = env.get(n)
                        if v is None:
                            raise ValueError(f"{n} not produced")
                        if v.numel() > _MAX_FOLD_ELEMS:
                            raise ValueError("too large to embed")
                        if v.dtype == torch.bfloat16:
                            raise ValueError("no numpy bfloat16")
                        tens[n] = v
                        vals[n] = v.numpy().astype(ir_dtype(v.dtype),
                                                   copy=False)
                except Exception:
                    ok = False
            if ok:
                const_env.update(tens)
                folded.add(idx)
                folded_vals[idx] = vals
            else:
                # this op's writes are runtime values now — any prior
                # constant binding of the same name is stale
                for n in outs:
                    const_env.pop(n, None)
        if not folded:
            return {"folded": 0, "materialized": 0}

        # constants still read by surviving ops (any block), fetched,
        # or wired as lod companions must materialize as assign_value
        needed = set(ctx.fetch_names) | set(program.lod_link.values())
        for blk in program.blocks:
            for i, op in enumerate(blk.ops):
                if blk.idx == block.idx and i in folded:
                    continue
                needed |= set(op_names(op, "in"))
                needed |= attr_read_names(op)

        from ...framework import Operator
        new_ops = []
        materialized = 0
        for idx, op in enumerate(block.ops):
            if idx not in folded:
                new_ops.append(op)
                continue
            for n in op_names(op, "out"):
                if n in needed and n in folded_vals[idx]:
                    arr = folded_vals[idx][n]
                    new_ops.append(Operator(
                        block, "assign_value", outputs={"Out": [n]},
                        attrs={"values": np.ascontiguousarray(arr),
                               "dtype": str(arr.dtype),
                               "shape": [int(s) for s in arr.shape]}))
                    materialized += 1
        block.ops = new_ops
        program._fp_cache = None
        STAT_ADD("analysis.pass_ops_folded", len(folded))
        return {"folded": len(folded), "materialized": materialized}
