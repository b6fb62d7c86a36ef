"""fused_elementwise: one op that replays a merged elementwise chain.

Emitted exclusively by the level-2 fusion pass
(analysis/passes/fusion.py) — never by layer builders. The pass
splices a maximal run of consecutive pure elementwise ops into a
single op whose `sub_ops` attr carries the original op descriptors
(type, attrs, slot wiring, stable id). Lowering replays each sub-op's
*registered lowering* in the original order against a local env, so
the torch calls — and therefore the numerics — are bit-identical to
the unfused chain.

Each sub-op runs as itself: under an op view that carries its own id,
so its random stream, ``wants()`` and, when a grad op names it, its
autograd record (kept under that id, core/lowering.py) are the unfused
op's. Every sub-op output remains an output of the fused op, so the
grad ops that read chain intermediates still find them.
"""
from ..core.registry import OpDef, REGISTRY

__all__ = []


class _SubOp:
    """One replayed sub-op: the Operator fields a lowering reads."""

    def __init__(self, sub, block):
        self.type = sub["type"]
        self.attrs = sub["attrs"]
        self.inputs = sub["inputs"]
        self.outputs = sub["outputs"]
        self.id = sub["id"]
        self.block = block


def fused_elementwise_lower(ctx, ins, attrs):
    from ..core.lowering import _OpCtx, _lower

    env = dict(zip(attrs["x_names"], ins.get("X", [])))
    for sub in attrs["sub_ops"]:
        opdef = REGISTRY.get(sub["type"])
        sub_ins = {slot: [env[n] for n in names if n]
                   for slot, names in sub["inputs"].items()}
        sub_ins = {slot: vals for slot, vals in sub_ins.items() if vals}
        op = _SubOp(sub, ctx.block)
        outs = _lower(op, opdef, _OpCtx(ctx._ctx, op), sub_ins, ctx._ctx)
        for slot, names in sub["outputs"].items():
            if slot not in outs:
                continue
            for name, val in zip(names, outs[slot]):
                if name:
                    env[name] = val
    return {"Out": [env[n] for n in attrs["out_names"]]}


REGISTRY.register(OpDef(type="fused_elementwise",
                        lower=fused_elementwise_lower))
