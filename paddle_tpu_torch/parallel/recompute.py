"""Activation recomputation (gradient checkpointing) over the Program IR.

The forward is split at the user's checkpoint vars into segments; each
segment of more than one op moves into a sub-block fronted by one
`recompute_segment` op, as the JAX package rewrites it. Its lowering
runs the sub-block under ``torch.utils.checkpoint`` (non-reentrant): the
segment's inner activations are dropped after the forward and computed
again when its grad op differentiates it, so only the segments'
boundaries stay live across the backward. A dropout inside a segment
draws from its op's own generator (seeded by program seed, step and op
id), so the recomputed mask equals the forward's, and
``preserve_rng_state`` leaves the global generator where it would be
without recompute.
"""
from __future__ import annotations

from typing import List

import torch
import torch.utils.checkpoint as _ckpt

from ..core.registry import REGISTRY, register_op

__all__ = ["rewrite_program_for_recompute", "expose_fetch_vars"]


@register_op("recompute_segment")
def _recompute_segment(ctx, ins, attrs):
    names_in: List[str] = attrs["input_vars"]
    names_out: List[str] = attrs["output_vars"]
    block = ctx.sub_block(attrs["sub_block"])
    xs = list(ins.get("X", []))

    def seg(*vals):
        env = dict(zip(names_in, vals))
        ctx.lower_sub_block(block, env)
        return tuple(env[n] for n in names_out)

    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        outs = _ckpt.checkpoint(seg, *xs, use_reentrant=False,
                                preserve_rng_state=True)
    else:
        outs = seg(*xs)
    return {"Out": list(outs)}


def _op_is_wrappable(op) -> bool:
    """Segments hold plain ops only: update (inplace) ops and the
    segment op itself keep their own path."""
    if not REGISTRY.has(op.type):
        return False
    opdef = REGISTRY.get(op.type)
    return not opdef.inplace and op.type not in (
        "feed", "fetch", "recompute_segment")


def rewrite_program_for_recompute(program, checkpoints, keep_names=()):
    """Partition block 0's forward ops into segments ending at each
    checkpoint var; wrap every multi-op segment in a recompute_segment
    op. Runs BEFORE append_backward; `keep_names` (the loss) are always
    segment outputs."""
    block = program.global_block()
    checkpoints = {c.name if hasattr(c, "name") else str(c)
                   for c in checkpoints}
    keep = {k.name if hasattr(k, "name") else str(k) for k in keep_names}

    ops = list(block.ops)
    if not all(_op_is_wrappable(op) for op in ops):
        return  # control flow or update ops present: leave as it is

    segments, cur = [], []
    for op in ops:
        cur.append(op)
        if any(n in checkpoints for n in op.output_names()):
            segments.append(cur)
            cur = []
    if cur:
        segments.append(cur)
    if len(segments) < 2:
        return

    persistable = {v.name for v in block.vars.values() if v.persistable}
    read_by_later: dict = {}
    for si, seg in enumerate(segments):
        for op in seg:
            for n in op.input_names():
                read_by_later.setdefault(n, set()).add(si)

    block.ops = []
    for si, seg in enumerate(segments):
        produced_here = set()
        consumed = []
        for op in seg:
            for n in op.input_names():
                if n and n not in produced_here and n not in consumed:
                    consumed.append(n)
            for n in op.output_names():
                if n:
                    produced_here.add(n)
        ext_in = [n for n in consumed if n not in produced_here]
        ext_out = sorted(
            n for n in produced_here
            if n in persistable or n in keep or n in checkpoints
            or any(sj > si for sj in read_by_later.get(n, ())))
        if len(seg) == 1:
            block.ops.append(seg[0])
            continue

        sub = program._create_block(parent_idx=block.idx)
        for op in seg:
            op.block = sub
            sub.ops.append(op)
        program._current_block_idx = block.idx

        block.append_op(
            "recompute_segment",
            inputs={"X": ext_in},
            outputs={"Out": ext_out},
            attrs={"sub_block": sub.idx,
                   "input_vars": ext_in,
                   "output_vars": ext_out},
            infer_shape=False)


def expose_fetch_vars(program, fetch_names):
    """Make fetch targets made inside recompute sub-blocks fetchable: the
    owning recompute_segment op gains them as outputs (the executor
    calls this before its cache key, which holds the fetch names)."""
    block = program.global_block()
    metas = [op for op in block.ops if op.type == "recompute_segment"]
    if not metas:
        return
    available = set()
    for op in block.ops:
        available.update(n for n in op.output_names() if n)
    for name in fetch_names:
        if name in available:
            continue
        for op in metas:
            sub = program.blocks[op.attrs["sub_block"]]
            if any(name in sop.output_names() for sop in sub.ops):
                new_out = list(op.attrs["output_vars"]) + [name]
                op.attrs = dict(op.attrs, output_vars=new_out)
                op.outputs = dict(op.outputs, Out=new_out)
                program._fp_cache = None
                break
