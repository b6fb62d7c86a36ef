"""Graph lints + the FLAGS_program_verify gate.

`verify_program` is the pure entry point (CLI, tests); `verify_gate` is
the memoized wrapper Executor.run and ServingEngine.warmup call so a
program is verified once per (fingerprint, feeds, fetches) and never
again — the expensive half (every lowering run on meta tensors,
shape_infer.py) is additionally memoized by fingerprint alone and shared
with the memory planner, so re-running one program with different fetch
lists only repeats the cheap graph walks.

Rule catalog: diagnostics.RULES / docs/static_analysis.md.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Iterable, Optional

from ..core.registry import REGISTRY
from ..monitor import STAT_ADD
from .diagnostics import VerifyResult
from .graph_utils import (CTRL_FLOW_SUB_BLOCK as _CTRL_FLOW_SUB_BLOCK,
                          SIDE_EFFECT_OPS as _SIDE_EFFECT_OPS,
                          available_at_entry, live_op_mask,
                          op_names as _op_names, program_read_names,
                          scan_block_hazards)
from .shape_infer import OPAQUE_OPS, program_specs
from .shape_infer import reset_memo as _reset_spec_memo

__all__ = ["verify_program", "verify_gate"]


def verify_program(program, feed_names: Optional[Iterable[str]] = None,
                   fetch_names: Optional[Iterable[str]] = None,
                   op_versions: Optional[Dict[str, int]] = None,
                   check_shapes: bool = True,
                   _core: Optional[VerifyResult] = None) -> VerifyResult:
    """Statically verify `program`; no compilation, no device work.

    feed_names: vars supplied at run time (beyond is_data/persistable
    vars) — counted as available for the dataflow lints and checked to
    exist (PTV030). fetch_names: enables dead-op reachability (PTV012)
    and the fetch-materialisation check (PTV031). op_versions: a saved
    program's {op type: version} map, checked against the registry
    (PTV002). check_shapes=False skips the abstract-evaluation pass.
    """
    feed_set = {str(n) for n in (feed_names or ())}
    fetch_list = [str(n) for n in (fetch_names or ())]

    result = VerifyResult()
    if _core is not None:
        result.extend(_core)
    else:
        result.extend(_verify_core(program, check_shapes))

    if op_versions:
        _lint_versions(op_versions, result)
    _lint_io(program, feed_set, fetch_list, result)
    if fetch_list:
        _lint_dead_ops(program, fetch_list, result)
    _lint_unused_outputs(program, fetch_list, result)
    return result


def _verify_core(program, check_shapes=True) -> VerifyResult:
    """The feed/fetch-independent findings (memoizable by fingerprint)."""
    result = VerifyResult()
    for block in program.blocks:
        _lint_block(program, block, result)
    if check_shapes:
        result.findings.extend(program_specs(program)[1])
    return result


# ---------------------------------------------------------------------------
# per-block dataflow lints
# ---------------------------------------------------------------------------

def _lint_block(program, block, result):
    avail = available_at_entry(program, block)

    for op_idx, op in enumerate(block.ops):
        opdef = REGISTRY._ops.get(op.type)
        if opdef is None:
            import difflib
            close = difflib.get_close_matches(
                op.type, list(REGISTRY._ops), n=3, cutoff=0.6)
            hint = ("; did you mean " +
                    ", ".join(repr(c) for c in close) + "?") if close \
                else ""
            result.add("PTV001",
                       f"op type {op.type!r} has no registered "
                       f"lowering{hint}",
                       op_type=op.type, block=block.idx, op_idx=op_idx)

        ins = list(_op_names(op, "in"))
        outs = list(_op_names(op, "out"))

        for name in ins:
            var = block._find_var_recursive(name)
            if var is None:
                result.add("PTV010",
                           f"input {name!r} is not declared in block "
                           f"{block.idx} or any ancestor",
                           op_type=op.type, block=block.idx,
                           op_idx=op_idx, var=name)
            elif name not in avail and name not in outs:
                result.add("PTV011",
                           f"input {name!r} is read before any op "
                           f"produces it (not persistable, not a data "
                           f"var, not fed)",
                           op_type=op.type, block=block.idx,
                           op_idx=op_idx, var=name)
        for name in outs:
            avail.add(name)

        if op.type in _CTRL_FLOW_SUB_BLOCK:
            _lint_sub_block(program, block, op, op_idx, result)

    # WAW / inplace-alias findings come from the shared scan the
    # donation planner also consumes (analysis/graph_utils.py) — lint
    # and rewrite must agree on what is hazardous.
    waw, alias_reads, _ = scan_block_hazards(block)
    for op_idx, op_type, name, p_idx, p_type in waw:
        result.add("PTV014",
                   f"{name!r} written by {p_type!r} (op {p_idx}) is "
                   f"overwritten before anything reads it",
                   op_type=op_type, block=block.idx, op_idx=op_idx,
                   var=name)
    for op_idx, op_type, name, w_idx, w_type in alias_reads:
        result.add("PTV015",
                   f"{name!r} was updated in place by {w_type!r} (op "
                   f"{w_idx}) but is read again here — the buffer may "
                   f"be donated/overwritten",
                   op_type=op_type, block=block.idx, op_idx=op_idx,
                   var=name)


def _lint_sub_block(program, block, op, op_idx, result):
    def bad(msg):
        result.add("PTV040", msg, op_type=op.type, block=block.idx,
                   op_idx=op_idx)

    sb = op.attrs.get("sub_block")
    if isinstance(sb, dict):  # {"__block__": idx} serialized form
        sb = sb.get("__block__")
    if not isinstance(sb, int) or not (0 < sb < len(program.blocks)):
        bad(f"sub_block attr {op.attrs.get('sub_block')!r} does not "
            f"name a block of this program "
            f"({len(program.blocks)} blocks)")
        return
    sub = program.blocks[sb]
    for attr in ("output_vars", "carried_vars", "input_vars"):
        for name in op.attrs.get(attr, []) or []:
            if sub._find_var_recursive(name) is None:
                bad(f"{attr} entry {name!r} is not declared in "
                    f"sub-block {sb} or its ancestors")
    cond = op.attrs.get("condition")
    if op.type == "while" and cond \
            and sub._find_var_recursive(cond) is None:
        bad(f"condition var {cond!r} is not declared in sub-block "
            f"{sb} or its ancestors")


# ---------------------------------------------------------------------------
# program-level lints
# ---------------------------------------------------------------------------

def _lint_versions(saved: Dict[str, int], result):
    for t, v in saved.items():
        if REGISTRY.has(t) and int(v) > REGISTRY.get(t).version:
            result.add("PTV002",
                       f"saved program uses {t!r} v{v} but this build "
                       f"supports v{REGISTRY.get(t).version}",
                       op_type=t)


def _lint_io(program, feed_set, fetch_list, result):
    gb = program.global_block()
    for name in sorted(feed_set):
        if not gb.has_var(name):
            result.add("PTV030",
                       f"feed {name!r} does not name a var of the "
                       f"program", var=name)
    if not fetch_list:
        return
    produced = {n for op in gb.ops for n in _op_names(op, "out")}
    for name in fetch_list:
        var = gb._find_var_recursive(name)
        if var is None:
            result.add("PTV031",
                       f"fetch target {name!r} does not name a var of "
                       f"the program", var=name)
        elif name not in produced and not var.persistable \
                and not var.is_data and name not in feed_set:
            result.add("PTV031",
                       f"fetch target {name!r} is never produced in the "
                       f"global block (sub-block values do not surface)",
                       var=name)


def _lint_dead_ops(program, fetch_list, result):
    # shared walk: the False entries here are exactly what the DCE pass
    # removes (analysis/passes/dce.py)
    block = program.global_block()
    mask = live_op_mask(program, fetch_list)
    for op_idx, live in enumerate(mask):
        if not live:
            op = block.ops[op_idx]
            outs = _op_names(op, "out")
            result.add("PTV012",
                       f"no path from its outputs {outs} to the fetch "
                       f"targets — op never affects a fetched value",
                       op_type=op.type, block=block.idx, op_idx=op_idx)


def _lint_unused_outputs(program, fetch_list, result):
    # one shared definition of "read" (graph_utils.program_read_names):
    # op inputs + attr-carried names of EVERY block, so a var whose
    # only reader sits in a (possibly nested) while/conditional_block
    # sub-block counts as used — same rule the memory planner's
    # liveness and the DCE reachability apply
    reads = set(fetch_list) | program_read_names(program)
    for blk in program.blocks:
        for op_idx, op in enumerate(blk.ops):
            if op.type in _SIDE_EFFECT_OPS or op.type in OPAQUE_OPS:
                continue
            outs = list(_op_names(op, "out"))
            if len(outs) < 2:
                # single-output dead ops are PTV012's job; flagging every
                # unfetched tail value would be noise
                continue
            for name in outs:
                v = blk._find_var_recursive(name)
                if v is not None and (v.persistable or v.is_data):
                    continue
                if name not in reads:
                    result.add("PTV013",
                               f"output {name!r} is never read, "
                               f"fetched, or persisted (auxiliary "
                               f"output that could be dropped)",
                               op_type=op.type, block=blk.idx,
                               op_idx=op_idx, var=name)


# ---------------------------------------------------------------------------
# the gate (Executor.run / ServingEngine.warmup)
# ---------------------------------------------------------------------------

_MEMO_LOCK = threading.Lock()
_CORE_MEMO: "OrderedDict[str, VerifyResult]" = OrderedDict()
_GATE_MEMO: "OrderedDict[tuple, VerifyResult]" = OrderedDict()
_MEMO_CAP = 256


def _memo_put(memo, key, val):
    memo[key] = val
    while len(memo) > _MEMO_CAP:
        memo.popitem(last=False)


def reset_memo():
    """Drop gate memoization (tests; after re-registering ops)."""
    with _MEMO_LOCK:
        _CORE_MEMO.clear()
        _GATE_MEMO.clear()
    _reset_spec_memo()


def verify_gate(program, feed_names=None, fetch_names=None,
                where="executor") -> Optional[VerifyResult]:
    """The FLAGS_program_verify gate: off | warn (default) | error.

    Runs verify_program once per (program fingerprint, feed names,
    fetch names) and memoizes; in 'error' mode error-severity findings
    raise ProgramVerificationError — BEFORE the executor prepares or
    caches a run, so Executor.cache_stats() shows zero misses for a
    rejected program. In 'warn' mode findings surface as a single summarized
    warnings.warn per program."""
    from ..core.flags import FLAGS
    mode = FLAGS.program_verify
    if mode == "off":
        return None
    if mode not in ("warn", "error"):
        raise ValueError(
            f"FLAGS_program_verify={mode!r}: expected 'off', 'warn' or "
            f"'error'")

    fp = program.fingerprint()
    key = (fp, tuple(sorted(str(n) for n in (feed_names or ()))),
           tuple(str(n) for n in (fetch_names or ())))
    with _MEMO_LOCK:
        res = _GATE_MEMO.get(key)
        core = _CORE_MEMO.get(fp)
    fresh = res is None
    if fresh:
        if core is None:
            core = _verify_core(program)
            with _MEMO_LOCK:
                _memo_put(_CORE_MEMO, fp, core)
        res = verify_program(program, feed_names=key[1],
                             fetch_names=key[2], _core=core)
        with _MEMO_LOCK:
            _memo_put(_GATE_MEMO, key, res)
        STAT_ADD("analysis.programs_verified")
        if res.errors():
            STAT_ADD("analysis.findings_error", len(res.errors()))
        if res.warnings():
            STAT_ADD("analysis.findings_warn", len(res.warnings()))
    if mode == "error":
        res.raise_if_errors()
    elif fresh and res.findings:
        import warnings
        warnings.warn(f"[{where}] {res.summary()} "
                      f"(FLAGS_program_verify=warn; see "
                      f"docs/static_analysis.md)")
    return res
