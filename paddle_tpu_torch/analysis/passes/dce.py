"""Dead-op elimination: drop global-block ops with no path to a fetch.

The liveness decision IS the PTV012 lint (graph_utils.live_op_mask):
anchored ops — host effects, inplace state updates, persistable writes,
opless sinks — always survive, as do lod_link companions, so the pass
can never remove a parameter update or a side effect. With no fetch
targets every op is formally dead; the pass declines to act rather
than empty the program.
"""
from __future__ import annotations

from ...monitor import STAT_ADD
from ..graph_utils import live_op_mask
from .base import Pass

__all__ = ["DeadOpElimination"]


class DeadOpElimination(Pass):
    name = "dead_op_elim"
    min_level = 1

    def run(self, program, ctx):
        if not ctx.fetch_names:
            return {"removed": 0}
        block = program.global_block()
        mask = live_op_mask(program, ctx.fetch_names)
        removed = mask.count(False)
        if removed:
            block.ops = [op for op, live in zip(block.ops, mask)
                         if live]
            program._fp_cache = None
            STAT_ADD("analysis.pass_ops_removed", removed)
        return {"removed": removed}
