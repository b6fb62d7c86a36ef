"""Shared program-graph analyses: reachability, anchoring, alias scans.

One implementation consumed by BOTH the lint side (verifier.py: PTV012
dead ops, PTV014 write-after-write, PTV015 inplace-alias hazards) and
the rewrite side (analysis/passes/: dead-op elimination, the donation
planner) — the lint reports what the rewrite acts on, so the two must
never disagree about what is dead or hazardous.

Everything here is a pure walk over Program/Block/Operator objects: no
compilation, no device work, no mutation.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

from ..core.registry import REGISTRY

__all__ = [
    "SIDE_EFFECT_OPS", "MERGE_OPS", "CTRL_FLOW_SUB_BLOCK",
    "op_names", "attr_read_names", "op_is_anchored",
    "available_at_entry", "live_op_mask", "scan_block_hazards",
    "referenced_var_names", "sub_block_index", "sub_block_read_names",
    "program_read_names",
]

# Ops whose execution is the point (host effects), so dead-op
# reachability never flags them even when nothing reads their outputs.
SIDE_EFFECT_OPS = frozenset({
    "print", "save", "save_combine", "load", "load_combine",
    "feed", "fetch", "read", "create_custom_reader", "py_func",
    "send", "recv", "prefetch", "fetch_barrier", "send_barrier",
    "checkpoint_notify", "geo_sgd_send", "distributed_notify",
    "listen_and_serv", "fl_listen_and_serv", "delete_var",
    "push_box_sparse", "gen_nccl_id", "c_gen_nccl_id", "c_comm_init",
    "c_comm_init_all", "c_sync_calc_stream", "c_sync_comm_stream",
    # host-RPC table ops: the pull touches (and for auto-grown tables
    # mutates) pserver state, and their GRADS perform the sparse push —
    # see the grad::generic clause in op_is_anchored
    "distributed_lookup_table", "lookup_sparse_table", "pull_box_sparse",
})

# Control-flow ops that legitimately re-write a var another op already
# wrote (branch merge / carry patterns) — excluded from write-after-write.
MERGE_OPS = frozenset({
    "conditional_block", "conditional_block_infer", "while",
    "select_input", "merge_lod_tensor", "assign", "recurrent",
})

CTRL_FLOW_SUB_BLOCK = ("while", "conditional_block",
                       "conditional_block_infer", "recurrent",
                       "recompute_segment")

# Attrs through which control-flow ops read parent-scope vars by name.
_READ_ATTRS = ("input_vars", "carried_vars", "condition")


def op_names(op, which) -> List[str]:
    """Flat list of an op's input ('in') or output ('out') var names."""
    d = op.inputs if which == "in" else op.outputs
    return [n for ns in d.values() for n in ns if n]


def attr_read_names(op, attrs=_READ_ATTRS) -> set:
    """Var names an op reads through string/list attrs (control-flow
    carries, conditions) rather than input slots."""
    names = set()
    for attr in attrs:
        v = op.attrs.get(attr)
        if isinstance(v, str):
            names.add(v)
        elif isinstance(v, (list, tuple)):
            names |= {str(x) for x in v}
    return names


def sub_block_index(program, op):
    """The valid sub-block index an op carries, or None. Accepts both
    the live int form and the serialized {"__block__": idx} form."""
    sb = op.attrs.get("sub_block")
    if isinstance(sb, dict):
        sb = sb.get("__block__")
    if isinstance(sb, int) and 0 < sb < len(program.blocks):
        return sb
    return None


def sub_block_read_names(program, op) -> set:
    """Every var name read anywhere inside `op`'s sub-block — op inputs
    AND attr-based reads, transitively through nested control-flow ops
    (a conditional_block inside a while body counts).

    This is THE definition of "a sub-block read is a use", shared by
    the dead-op reachability (live_op_mask / PTV012 / DCE), the
    unused-output lint (PTV013), the donation planner, and the memory
    planner's liveness intervals, so a var whose only reader lives two
    blocks down is never declared dead by one consumer and live by
    another. The one-level scan this replaces missed nested sub-blocks
    and sub-op attr reads entirely.
    """
    names = set()
    seen = set()
    stack = [op]
    while stack:
        sb = sub_block_index(program, stack.pop())
        if sb is None or sb in seen:
            continue
        seen.add(sb)
        for sop in program.blocks[sb].ops:
            names |= set(op_names(sop, "in"))
            names |= attr_read_names(sop)
            if sop.type in CTRL_FLOW_SUB_BLOCK:
                stack.append(sop)
    return names


def op_is_anchored(op, block) -> bool:
    """Ops kept live regardless of fetch reachability: host effects,
    in-place state updates, writes to persistable vars, opless sinks."""
    if op.type in SIDE_EFFECT_OPS:
        return True
    # the grad of a host-effect op is itself a host effect (e.g. the
    # sparse PUSH inside distributed_lookup_table's grad) even when
    # nothing reads the emitted gradient tensor
    if op.type == "grad::generic" and \
            op.attrs.get("fwd_type") in SIDE_EFFECT_OPS:
        return True
    opdef = REGISTRY._ops.get(op.type)
    if opdef is not None and opdef.inplace:
        return True
    outs = op_names(op, "out")
    if not outs:
        return True
    for n in outs:
        v = block._find_var_recursive(n)
        if v is not None and v.persistable:
            return True
    return False


def available_at_entry(program, block) -> set:
    """Vars readable before any op of `block` runs: the whole ancestor
    scope chain (sub-blocks are entered mid-parent, and shapes are
    static, so the parent's full symbol table is a sound
    over-approximation) plus local persistables/data vars."""
    avail = set()
    blk = block
    while blk is not None:
        if blk is block:
            avail |= {n for n, v in blk.vars.items()
                      if v.persistable or v.is_data}
        else:
            avail |= set(blk.vars)
        blk = blk.parent
    return avail


def live_op_mask(program, fetch_list: Iterable[str]) -> List[bool]:
    """Backward reachability from the fetch targets over the global
    block: mask[i] is True iff global-block op i is anchored or some
    output transitively feeds a fetch. The False entries are exactly
    the PTV012 findings and exactly what dead-op elimination removes."""
    block = program.global_block()
    needed = set(fetch_list)
    # lengths companions are read implicitly by the feed path
    needed |= set(program.lod_link.values())
    mask = [False] * len(block.ops)
    for op_idx in reversed(range(len(block.ops))):
        op = block.ops[op_idx]
        outs = op_names(op, "out")
        live = op_is_anchored(op, block) or any(n in needed for n in outs)
        mask[op_idx] = live
        if live:
            needed |= set(op_names(op, "in"))
            # sub-block reads count: condition/carried vars resolve
            # against the parent scope too, transitively through
            # nested control flow (sub_block_read_names)
            needed |= attr_read_names(op)
            if op.type in CTRL_FLOW_SUB_BLOCK:
                needed |= sub_block_read_names(program, op)
    return mask


def scan_block_hazards(block) -> Tuple[list, list, list]:
    """One forward walk of `block` shared by the WAW/alias lints and
    the donation planner. Returns (waw, alias_reads, inplace_writes):

    - waw: (op_idx, op_type, var, prev_idx, prev_type) — `var` written
      by op prev_idx is overwritten at op_idx before anything read it
      (PTV014; persistable / inplace / merge writes are exempt).
    - alias_reads: (op_idx, op_type, var, w_idx, w_type) — `var` was
      updated in place by op w_idx but read again at op_idx, so a
      donated buffer may already be clobbered (PTV015).
    - inplace_writes: (op_idx, op_type, var) — in-place self-aliasing
      writes (optimizer state updates); minus the alias_reads vars,
      these are the safely-donatable buffers.
    """
    waw = []
    alias_reads = []
    inplace_writes = []
    last_write = {}  # var -> (op_idx, op_type, is_merge_or_inplace)
    for op_idx, op in enumerate(block.ops):
        opdef = REGISTRY._ops.get(op.type)
        ins = list(op_names(op, "in"))
        outs = list(op_names(op, "out"))

        for name in ins:
            for w_idx, w_type, w_var in inplace_writes:
                if name == w_var:
                    alias_reads.append((op_idx, op.type, name,
                                        w_idx, w_type))
            if name in last_write:
                last_write.pop(name, None)

        is_inplace = bool(opdef is not None and opdef.inplace)
        is_merge = op.type in MERGE_OPS
        for name in outs:
            var = block._find_var_recursive(name)
            persistable = bool(var is not None and var.persistable)
            prev = last_write.get(name)
            if prev is not None and not persistable \
                    and not (is_inplace or is_merge):
                p_idx, p_type, p_soft = prev
                if not p_soft:
                    waw.append((op_idx, op.type, name, p_idx, p_type))
            last_write[name] = (op_idx, op.type,
                                is_inplace or is_merge or persistable)
            if is_inplace and name in ins:
                inplace_writes.append((op_idx, op.type, name))
    return waw, alias_reads, inplace_writes


def program_read_names(program) -> set:
    """Every var name READ anywhere in the program: op inputs of every
    block plus attr-carried names (conditions, carried vars, the
    output_vars lists control-flow ops resolve by name). The complement
    of this set over an op's outputs is the PTV013 "never read"
    finding, and the memory planner's last-use scan must agree with it.
    Includes the lod_link companions the feed path reads implicitly."""
    reads = set(program.lod_link.values())
    for blk in program.blocks:
        for op in blk.ops:
            reads |= set(op_names(op, "in"))
            reads |= attr_read_names(
                op, _READ_ATTRS + ("output_vars",))
    return reads


def referenced_var_names(program) -> set:
    """Every var name any op of any block touches (inputs, outputs, or
    attr-based reads) — the working set a rewrite must not orphan;
    shrinkage of this set is the 'vars eliminated' a pass reports."""
    names = set()
    for blk in program.blocks:
        for op in blk.ops:
            names |= set(op_names(op, "in"))
            names |= set(op_names(op, "out"))
            names |= attr_read_names(
                op, _READ_ATTRS + ("output_vars",))
    return names
