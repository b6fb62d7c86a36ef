"""Elementwise-chain fusion (level 2): merge, or at least scope.

This pass finds maximal runs of
consecutive global-block ops that are (a) elementwise/activation-shaped
and (b) dataflow-chained (each op after the first reads a value the run
produced), then splices each run into ONE `fused_elementwise` op
(ops/fused.py) whose `sub_ops` attr replays the originals in order.
Numerics are bit-identical — the fused lowering calls the exact same
registered lowerings with the exact same attrs — and every sub-op
output stays an output of the fused op, so backward's grad::generic
readers (which take chain intermediates as plain inputs) still find
them. Each sub-op keeps its own id: its random stream, and the autograd
record a grad op reads under that id, are the unfused op's.

A run that fails the merge gates (non-JSON attrs, a stateful/inplace
registration, a sub-op that redefines one of the run's external
inputs) degrades to annotation: each op gets a shared `_fusion_group`
label, which core/lowering.run_op puts in front of the op's profiler
scope ("ewfuse0/scale:0/3"). Merged ops carry the same label, so
profiles name the chain either way. The label is a plain Python
attribute, not an op attr: it must perturb neither lowering kwargs nor
the program fingerprint.
"""
from __future__ import annotations

from ...core.registry import REGISTRY
from ...monitor import STAT_ADD
from ..graph_utils import SIDE_EFFECT_OPS, op_names
from .base import Pass

__all__ = ["ElementwiseFusionScopes", "FUSABLE_OPS"]

# Per-element compute ops (ops/elementwise.py binaries +
# ops/activations.py unaries + the pointwise strays from ops/math.py /
# tensor_ops.py), the JAX package's list.
FUSABLE_OPS = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
    "minus",
    "sigmoid", "logsigmoid", "exp", "gelu", "tanh", "atan", "rsqrt",
    "abs", "ceil", "floor", "cos", "acos", "sin", "asin", "round",
    "reciprocal", "log", "square", "sqrt", "relu", "relu6", "pow",
    "softplus", "softsign", "tanh_shrink", "elu", "leaky_relu",
    "brelu", "soft_relu", "stanh", "softshrink", "hard_sigmoid",
    "hard_swish", "swish", "thresholded_relu", "erf", "sign",
    "scale", "cast", "clip",
})


def _plain_json(v):
    """True when v round-trips through json.dumps unchanged — the
    sub_ops attr must keep to_json/fingerprinting working."""
    if v is None or type(v) in (str, int, float, bool):
        return True
    if type(v) in (list, tuple):
        return all(_plain_json(x) for x in v)
    if type(v) is dict:
        return all(type(k) is str and _plain_json(x) for k, x in v.items())
    return False


def _merge_spec(g_ops):
    """inputs/outputs/attrs for one fused_elementwise op, or None when
    a gate fails and the run must fall back to scope annotation."""
    ext, produced, out_names = [], set(), []
    for op in g_ops:
        opdef = REGISTRY._ops.get(op.type)
        if opdef is None or opdef.stateful or opdef.inplace:
            return None
        if op.type in SIDE_EFFECT_OPS or "sub_block" in op.attrs:
            return None
        if not _plain_json(dict(op.attrs)):
            return None
        for n in op_names(op, "in"):
            if n not in produced and n not in ext:
                ext.append(n)
        produced |= set(op_names(op, "out"))
        out_names.extend(op_names(op, "out"))
    # a sub-op redefining one of the run's external inputs would make
    # the fused op read and write the same name — an aliasing shape the
    # hazard/donation analyses must never see from a pure op
    if set(ext) & set(out_names):
        return None
    return {
        "x_names": ext,
        "out_names": out_names,
        "sub_ops": [{"type": op.type, "attrs": dict(op.attrs),
                     "inputs": {k: list(v) for k, v in op.inputs.items()},
                     "outputs": {k: list(v) for k, v in op.outputs.items()},
                     "id": op.id} for op in g_ops],
    }


class ElementwiseFusionScopes(Pass):
    name = "fusion_scopes"
    min_level = 2

    def run(self, program, ctx):
        block = program.global_block()
        ops = block.ops
        groups = {}   # start index -> [op, ...]
        start, run, run_outs = None, [], set()

        def close():
            nonlocal start, run, run_outs
            if len(run) >= 2:
                groups[start] = list(run)
            start, run, run_outs = None, [], set()

        for i, op in enumerate(ops):
            if op.type in FUSABLE_OPS:
                outs = set(op_names(op, "out"))
                chained = not run or any(n in run_outs
                                         for n in op_names(op, "in"))
                # a redefinition inside a run would leave the fused op
                # with a duplicated output name; split instead
                if not chained or (outs & run_outs):
                    close()
                if not run:
                    start = i
                run.append(op)
                run_outs |= outs
            else:
                close()
        close()

        from ...framework import Operator
        new_ops, gid, fused_ops, merged = [], 0, 0, 0
        i, n = 0, len(ops)
        while i < n:
            g_ops = groups.get(i)
            if g_ops is None:
                new_ops.append(ops[i])
                i += 1
                continue
            label = f"ewfuse{gid}"
            gid += 1
            fused_ops += len(g_ops)
            spec = _merge_spec(g_ops)
            if spec is None:
                for op in g_ops:
                    op._fusion_group = label
                new_ops.extend(g_ops)
            else:
                fop = Operator(
                    block, "fused_elementwise",
                    inputs={"X": spec["x_names"]},
                    outputs={"Out": spec["out_names"]},
                    attrs={"sub_ops": spec["sub_ops"],
                           "x_names": spec["x_names"],
                           "out_names": spec["out_names"]})
                fop._fusion_group = label
                new_ops.append(fop)
                merged += 1
            i += len(g_ops)

        if merged:
            block.ops = new_ops
            program._fp_cache = None
        if groups:
            STAT_ADD("analysis.pass_ops_fused", fused_ops)
            STAT_ADD("analysis.pass_fusion_groups", len(groups))
        return {"groups": len(groups), "fused_ops": fused_ops,
                "merged": merged}
