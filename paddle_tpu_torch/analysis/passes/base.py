"""Pass base class, PassManager, and the memoized optimize gate.

The pipeline rewrites a CLONE of the program (Program.fingerprint is
cached and direct op mutation does not invalidate it — cloning first is
the documented protocol, framework.Program.fingerprint), runs each pass
in order, then re-verifies the result with error semantics: only a
clean optimized program replaces the original; a rejected rewrite falls
back to the unoptimized program and counts
`analysis.pass_reverify_rejects` so a pass bug degrades to a missed
optimization, never a miscompile.

`optimize_gate` mirrors verifier.verify_gate's memoization: one
pipeline run per (program fingerprint, opt level, feeds, fetches),
shared by Executor.run and ServingEngine.warmup so a warmup ladder
optimizes once, not once per cell.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

from ...monitor import STAT_ADD, STAT_OBSERVE
from ..graph_utils import referenced_var_names

__all__ = ["Pass", "PassContext", "PassManager", "default_passes",
           "optimize_program", "optimize_gate", "reset_memo"]


class PassContext:
    """Per-pipeline-run state shared by the passes."""

    def __init__(self, feed_names=(), fetch_names=(), level=1):
        self.feed_names = tuple(str(n) for n in feed_names)
        self.fetch_names = tuple(str(n) for n in fetch_names)
        self.level = int(level)


class Pass:
    """One program rewrite. Subclasses mutate `program` (already a
    private clone) in place and return a detail dict of counters for
    the report table; they must never change observable numerics —
    the bit-exact parity tests in tests/test_torch_graph_passes.py are
    the contract."""

    name = "pass"
    min_level = 1

    def run(self, program, ctx: PassContext) -> dict:
        raise NotImplementedError


def default_passes() -> List[Pass]:
    """The standard pipeline, in dependency order: DCE first (nothing
    downstream wastes work on dead ops), folding before CSE (folding
    creates identical assign_value ops CSE then merges), fusion after
    the simplifiers (it splices the surviving chains), buffer reuse
    after fusion (it must see — and rename inside — the final fused
    slot maps), donation last (it only annotates and must see the
    final op list)."""
    from .constant_fold import ConstantFolding
    from .cse import CommonSubexprElimination
    from .dce import DeadOpElimination
    from .donation import DonationPlanner
    from .fusion import ElementwiseFusionScopes
    from .reuse import BufferReuse
    return [DeadOpElimination(), ConstantFolding(),
            CommonSubexprElimination(), ElementwiseFusionScopes(),
            BufferReuse(), DonationPlanner()]


class PassManager:
    def __init__(self, passes: Optional[List[Pass]] = None):
        self.passes = list(passes) if passes is not None \
            else default_passes()

    def run(self, program, feed_names=(), fetch_names=(),
            level: Optional[int] = None) -> Tuple[object, dict]:
        """Optimize `program` at `level` (default FLAGS_graph_opt_level).
        Returns (program, report): the optimized clone when every pass
        ran and the result re-verified clean, else the original."""
        from ...core.flags import FLAGS
        if level is None:
            level = int(FLAGS.graph_opt_level)
        level = int(level)

        gb = program.global_block()
        ops_before = len(gb.ops)
        report = {"opt_level": level, "ops_before": ops_before,
                  "ops_after": ops_before, "vars_eliminated": 0,
                  "passes": []}
        if level <= 0 or ops_before == 0:
            return program, report

        ctx = PassContext(feed_names, fetch_names, level)
        opt = program.clone()
        vars_before = referenced_var_names(opt)

        for p in self.passes:
            if level < p.min_level:
                continue
            n0 = len(opt.global_block().ops)
            t0 = time.perf_counter()
            detail = p.run(opt, ctx) or {}
            dt = time.perf_counter() - t0
            STAT_OBSERVE("analysis.pass_seconds", dt)
            entry = {"name": p.name, "ops_before": n0,
                     "ops_after": len(opt.global_block().ops),
                     "seconds": round(dt, 6)}
            entry.update(detail)
            report["passes"].append(entry)

        # rewrites mutate op lists/attrs directly; the cached
        # fingerprint (cleared by clone) must not survive them
        opt._fp_cache = None
        report["ops_after"] = len(opt.global_block().ops)
        report["vars_eliminated"] = len(
            vars_before - referenced_var_names(opt))

        # Re-verify with error semantics before the optimized program
        # replaces the original (the FLAGS_program_verify=error
        # contract): a rewrite that broke dataflow is discarded, not
        # run.
        from ..verifier import verify_program
        res = verify_program(opt, feed_names=ctx.feed_names,
                             fetch_names=ctx.fetch_names)
        if res.errors():
            STAT_ADD("analysis.pass_reverify_rejects")
            import warnings
            warnings.warn(
                f"graph_opt_level={level}: optimized program failed "
                f"re-verification and was discarded — {res.summary()}")
            report["rejected"] = True
            report["ops_after"] = ops_before
            report["vars_eliminated"] = 0
            return program, report

        STAT_ADD("analysis.pass_programs_optimized")
        return opt, report


def optimize_program(program, feed_names=(), fetch_names=(),
                     level: Optional[int] = None) -> Tuple[object, dict]:
    """Unmemoized single run of the default pipeline (CLI, tests)."""
    return PassManager().run(program, feed_names, fetch_names, level)


# ---------------------------------------------------------------------------
# the memoized gate (Executor.run / ServingEngine.warmup)
# ---------------------------------------------------------------------------

_MEMO_LOCK = threading.Lock()
_OPT_MEMO: "OrderedDict[tuple, Tuple[object, dict]]" = OrderedDict()
_MEMO_CAP = 64


def reset_memo():
    """Drop gate memoization (tests; after re-registering ops)."""
    with _MEMO_LOCK:
        _OPT_MEMO.clear()


def optimize_gate(program, feed_names=None, fetch_names=None,
                  where="executor") -> Tuple[object, Optional[dict]]:
    """Optimize once per (fingerprint, level, feeds, fetches) and
    memoize the (program, report) result. Level 0 returns the program
    untouched with no memo traffic."""
    from ...core.flags import FLAGS
    level = int(FLAGS.graph_opt_level)
    if level <= 0:
        return program, None
    # FLAGS_buffer_reuse changes what level 2 produces, so it joins the
    # memo key — flipping it mid-process must not serve a stale rewrite
    key = (program.fingerprint(), level, bool(FLAGS.buffer_reuse),
           tuple(sorted(str(n) for n in (feed_names or ()))),
           tuple(str(n) for n in (fetch_names or ())))
    with _MEMO_LOCK:
        hit = _OPT_MEMO.get(key)
        if hit is not None:
            _OPT_MEMO.move_to_end(key)
    if hit is not None:
        return hit
    out = PassManager().run(program, key[3], key[4], level=level)
    with _MEMO_LOCK:
        _OPT_MEMO[key] = out
        while len(_OPT_MEMO) > _MEMO_CAP:
            _OPT_MEMO.popitem(last=False)
    return out
