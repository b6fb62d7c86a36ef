"""Inplace/donation planner (level 2).

The JAX package's executor donates the persistable state to its jitted
step, and this pass narrows that to a per-var plan: a persistable is
donate-safe iff some op updates it in place (optimizer state: Param/
Moment in == out), no later op reads the aliased buffer (no PTV015
hazard) and no sub-block reads it by name.

The plan is attached to the optimized program as `_donation_plan`
(plain attribute — metadata, not IR), with the analysis.pass_donate_*
stats, computed as in the JAX package. The port's executor reads no
plan: its optimizer updates already write the state tensors in place,
so there is no buffer to hand over between steps (ROADMAP.md §C).
"""
from __future__ import annotations

import numpy as np

from ...core.dtypes import as_np_dtype
from ...monitor import STAT_ADD
from ..graph_utils import (attr_read_names, op_names,
                           scan_block_hazards)
from .base import Pass

__all__ = ["DonationPlanner"]


class DonationPlanner(Pass):
    name = "donation_plan"
    min_level = 2

    def run(self, program, ctx):
        block = program.global_block()
        _, alias_reads, inplace_writes = scan_block_hazards(block)
        hazard = {v for (_, _, v, _, _) in alias_reads}
        sub_reads = set()
        for blk in program.blocks:
            if blk.idx == block.idx:
                continue
            for op in blk.ops:
                # attr-carried names (conditions, carried vars) are
                # reads too — same rule as sub_block_read_names
                sub_reads |= set(op_names(op, "in"))
                sub_reads |= attr_read_names(op)

        plan = set()
        donated_bytes = 0
        for _, _, name in inplace_writes:
            if name in plan or name in hazard or name in sub_reads:
                continue
            v = block._find_var_recursive(name)
            if v is None or not v.persistable:
                continue
            plan.add(name)
            shape = v.shape or ()
            if shape and all(isinstance(d, int) and d > 0
                             for d in shape):
                donated_bytes += (int(np.prod(shape)) *
                                  np.dtype(as_np_dtype(v.dtype)).itemsize)

        program._donation_plan = frozenset(plan)
        if plan:
            STAT_ADD("analysis.pass_donate_vars", len(plan))
            STAT_ADD("analysis.pass_donate_bytes", donated_bytes)
        return {"donated_vars": len(plan),
                "donated_bytes": donated_bytes}
