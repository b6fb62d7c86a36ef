"""Buffer-reuse rewrite (level 2): alias disjoint same-spec intervals.

The JAX package's pass (the reference framework's memory_optimize_pass
and inplace_op_pass) on the port's IR. The liveness intervals come from the
static memory planner (analysis/memory.py) and the rewrite is a pure
rename over the global block, in two flavors (memory.reuse_assignments):
a transient var whose interval starts strictly after another
same-(shape, dtype) transient's interval ends is renamed onto it
(memory_optimize-style), and a transient defined by the op that LAST
READS such a buffer becomes an in-place update `root = f(root, ...)`
(inplace_op-style) — the form that actually lowers the estimated peak,
since the def op then holds one resident buffer where two stood.

Renames alone cannot deflate a TRAINING program's peak: builders append
the whole optimizer tail after backward, so every w@GRAD stays resident
from its producer to the tail and the peak op's resident set is a stack
of genuinely-overlapping gradients. The pass therefore first SINKS each
in-place state update to just past its dependency frontier
(memory.state_update_sinks — an observationally-exact interchange), so
each gradient dies at its weight's last reader, then renames over the
shortened intervals.

This generalizes passes/donation.py, which only splits the persistable
state into donated vs pinned: donation reuses buffers ACROSS steps
(optimizer state in == out), reuse collapses them WITHIN a step
(activation temporaries). The candidate gates live in
memory.reuse_assignments and are deliberately conservative — strictly
disjoint intervals, single plain writer, no name-carrying attr or
sub-block references — so the rewrite is bit-exact by construction,
and like every pass it still rides the PassManager's re-verify
fail-open. fused_elementwise ops embed their sub-op slot maps in the
`sub_ops` attr, so the rename rewrites those too.

Gated by FLAGS_buffer_reuse (on by default at level >= 2).

In the port a sunk update runs in place on the parameter while the
backward still walks: it is legal because every grad op that reads the
parameter lies before the update's frontier, and a grad op drops its
forward op's autograd record (which holds the parameter) when it runs.
"""
from __future__ import annotations

from ...monitor import STAT_ADD
from ..memory import (analyze_program_memory, apply_state_update_sinks,
                      peak_from_intervals, reuse_assignments)
from .base import Pass

__all__ = ["BufferReuse"]


class BufferReuse(Pass):
    name = "buffer_reuse"
    min_level = 2

    def run(self, program, ctx):
        from ...core.flags import FLAGS
        if not FLAGS.buffer_reuse:
            return {"reused_vars": 0, "bytes_saved": 0, "disabled": True}

        plan = analyze_program_memory(program,
                                      feed_names=ctx.feed_names,
                                      fetch_names=ctx.fetch_names)
        est_before = plan.peak_bytes

        # interval shortening first: sinking the optimizer tail ends
        # each w@GRAD's lifetime at its weight's last reader, which
        # both deflates the backward plateau directly AND frees those
        # buffers as rename roots for later gradients
        sunk = apply_state_update_sinks(program)
        if sunk:
            plan = analyze_program_memory(program,
                                          feed_names=ctx.feed_names,
                                          fetch_names=ctx.fetch_names)

        assignments = reuse_assignments(
            program, plan.intervals,
            set(ctx.feed_names) or {
                n for n, v in program.global_block().vars.items()
                if v.is_data},
            set(ctx.fetch_names))
        if not (assignments or sunk):
            return {"reused_vars": 0, "bytes_saved": 0, "sunk_updates": 0,
                    "est_peak_bytes": plan.peak_bytes}

        # victims always map onto roots (never onto other victims), so
        # one flat dict is the whole substitution
        rename = {victim: root for victim, root, _ in assignments}
        block = program.global_block()
        for op in block.ops:
            _rename_op(op, rename)
        program._fp_cache = None

        bytes_saved = sum(nb for _, _, nb in assignments)
        est_after = _peak_after(plan, rename)
        STAT_ADD("analysis.mem_reuse_vars", len(assignments))
        STAT_ADD("analysis.mem_reuse_bytes", bytes_saved)
        if sunk:
            STAT_ADD("analysis.mem_sunk_updates", sunk)
        return {"reused_vars": len(assignments),
                "bytes_saved": bytes_saved,
                "sunk_updates": sunk,
                "est_peak_bytes": est_after,
                "est_peak_before": est_before}


def _rename_op(op, rename):
    for slots in (op.inputs, op.outputs):
        for slot, names in slots.items():
            slots[slot] = [rename.get(n, n) for n in names]
    # fused_elementwise replays its originals from the sub_ops attr and
    # builds its local env from x_names/out_names — every embedded name
    # must follow the rename or the fused lowering reads/writes the
    # retired names (KeyError on meta tensors at re-verify)
    for attr in ("x_names", "out_names"):
        names = op.attrs.get(attr)
        if isinstance(names, (list, tuple)):
            op.attrs[attr] = [rename.get(n, n) for n in names]
    sub_ops = op.attrs.get("sub_ops")
    if isinstance(sub_ops, (list, tuple)):
        for sub in sub_ops:
            for key in ("inputs", "outputs"):
                d = sub.get(key)
                if isinstance(d, dict):
                    for slot, names in d.items():
                        d[slot] = [rename.get(n, n) for n in names]


def _peak_after(plan, rename):
    """Rebuild the timeline with each victim's interval renamed onto
    its root — no re-inference, just interval arithmetic
    (memory.peak_from_intervals).

    Accounting is per SEGMENT, not the union hull: in a gap between two
    occupants nothing is resident (torch's caching allocator frees and
    reuses that storage), while segments
    that touch at one op are an in-place handoff and merge into one
    run, so the handoff op counts the shared buffer ONCE where the
    pre-rewrite plan counted reader and writer separately. That makes
    est_peak_bytes <= est_peak_before by construction."""
    import dataclasses
    by_root = {}
    for name, iv in plan.intervals.items():
        by_root.setdefault(rename.get(name, name), []).append(iv)
    merged = []
    for ivs in by_root.values():
        if len(ivs) == 1:
            merged.append(ivs[0])
            continue
        segs = sorted((iv.def_idx, iv.last_use) for iv in ivs)
        runs, cur = [], list(segs[0])
        for a, b in segs[1:]:
            if a <= cur[1]:
                cur[1] = max(cur[1], b)
            else:
                runs.append(cur)
                cur = [a, b]
        runs.append(cur)
        for a, b in runs:
            merged.append(dataclasses.replace(ivs[0], def_idx=a,
                                              last_use=b))
    return peak_from_intervals(merged, plan.op_count, plan.pinned_bytes)
