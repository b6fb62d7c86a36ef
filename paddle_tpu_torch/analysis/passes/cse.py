"""Common-subexpression elimination over the global block.

Classic value numbering: each op is keyed on (op_type, canonical attr
JSON, per-slot input (name, version) tuples) where a var's version
bumps at every write — two ops with the same key compute the same
values, so the second is dropped and later reads of its outputs are
renamed to the first op's outputs. An available expression dies when
any of its outputs is overwritten (version check at lookup), and a
rename dies when its source name is redefined by a kept op.

Never merged: stateful ops (their PRNG folds in op.id — two identical
dropout ops are intentionally different), inplace/side-effect/opaque
and control-flow ops, ops writing persistable/data/fetched/lod-linked
vars, and ops whose outputs sub-blocks read by name (renaming across a
block boundary is not worth the bookkeeping).

Differentiated forward ops merge too, as in the JAX package. There a
grad op re-runs its forward from the attrs it copied; here it reads the
autograd record its forward op left under the op's id, and the dropped
op leaves none. So the pass records each merge in
``program._record_alias`` (dropped id -> survivor id): a Python
attribute, not IR, so the program's JSON stays the JAX package's. The
executor reads the survivor's record once per grad op that names
either id (core/lowering.py).
"""
from __future__ import annotations

import json

from ...core.registry import REGISTRY
from ...framework import _jsonable_attrs
from ...monitor import STAT_ADD
from ..graph_utils import (CTRL_FLOW_SUB_BLOCK, SIDE_EFFECT_OPS,
                           attr_read_names, op_names)
from ..shape_infer import OPAQUE_OPS
from .base import Pass

__all__ = ["CommonSubexprElimination"]


class CommonSubexprElimination(Pass):
    name = "cse"
    min_level = 1

    def run(self, program, ctx):
        block = program.global_block()

        # names whose defs must stay put / must not be renamed
        protected = set(ctx.fetch_names)
        protected |= set(program.lod_link)
        protected |= set(program.lod_link.values())
        for blk in program.blocks:
            for op in blk.ops:
                protected |= attr_read_names(
                    op, ("input_vars", "carried_vars", "condition",
                         "output_vars"))
                if blk.idx != block.idx:
                    protected |= set(op_names(op, "in"))

        # A surviving expression is only a valid rename source if its
        # outputs are never redefined: a later write to the source var
        # would silently redirect renamed reads to the new value.
        write_count = {}
        for blk in program.blocks:
            for op in blk.ops:
                for n in op_names(op, "out"):
                    write_count[n] = write_count.get(n, 0) + 1

        version = {}  # name -> write count
        table = {}    # expr key -> (outputs {slot: [names]}, out versions,
        #               op id)
        rename = {}   # dropped-def name -> surviving name
        alias = {}    # dropped op id -> surviving op id
        removed = 0
        new_ops = []

        for op in block.ops:
            for slot, names in op.inputs.items():
                nn = [rename.get(n, n) for n in names]
                if nn != names:
                    op.inputs[slot] = nn

            outs = op_names(op, "out")
            opdef = REGISTRY._ops.get(op.type)
            eligible = (
                opdef is not None and not opdef.stateful
                and not opdef.inplace
                and op.type not in SIDE_EFFECT_OPS
                and op.type not in OPAQUE_OPS
                and op.type not in CTRL_FLOW_SUB_BLOCK
                and "sub_block" not in op.attrs
                and bool(outs))
            if eligible:
                for n in outs:
                    v = block._find_var_recursive(n)
                    if n in protected or (
                            v is not None and (v.persistable
                                               or v.is_data)):
                        eligible = False
                        break

            key = None
            if eligible:
                key = (op.type,
                       json.dumps(_jsonable_attrs(op.attrs),
                                  sort_keys=True),
                       tuple((slot,
                              tuple((n, version.get(n, 0))
                                    for n in names))
                             for slot, names in sorted(
                                 op.inputs.items())))
                prior = table.get(key)
                if prior is not None:
                    p_outs, p_vers, p_id = prior
                    # the available expression must be un-clobbered and
                    # slot-compatible with this op's outputs
                    valid = all(version.get(n, 0) == v
                                for n, v in p_vers.items())
                    valid = valid and all(
                        len(p_outs.get(slot, ())) == len(names)
                        for slot, names in op.outputs.items())
                    if valid:
                        for slot, names in op.outputs.items():
                            for mine, theirs in zip(names,
                                                    p_outs[slot]):
                                if mine and mine != theirs:
                                    rename[mine] = theirs
                        alias[op.id] = p_id
                        removed += 1
                        continue  # drop the duplicate op

            new_ops.append(op)
            for n in outs:
                version[n] = version.get(n, 0) + 1
                rename.pop(n, None)  # redefinition ends the alias
            if key is not None and all(write_count.get(n, 0) == 1
                                       for n in outs):
                table[key] = (
                    {slot: list(names)
                     for slot, names in op.outputs.items()},
                    {n: version.get(n, 0) for n in outs}, op.id)

        if removed:
            block.ops = new_ops
            program._fp_cache = None
            merged = dict(getattr(program, "_record_alias", None) or {})
            merged.update(alias)
            program._record_alias = {
                k: _survivor(merged, v) for k, v in merged.items()}
            STAT_ADD("analysis.pass_ops_deduped", removed)
        return {"deduped": removed}


def _survivor(alias, op_id):
    """The op an id resolves to through chained merges."""
    seen = set()
    while op_id in alias and op_id not in seen:
        seen.add(op_id)
        op_id = alias[op_id]
    return op_id
