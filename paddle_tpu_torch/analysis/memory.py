"""Static memory planner: liveness intervals + peak device-memory estimate.

The JAX package's planner on the port's IR: a def/last-use interval per
var over the global block, a per-op resident-bytes timeline, and a peak
estimate, all with ZERO device work, so the first signal that a program
does not fit the card is a PTV050 diagnostic before its first run
instead of an out-of-memory error in the middle of one. The plan is a
function of the program alone, so it equals the JAX package's: peak
bytes, intervals, timeline and findings. How well it predicts torch's
real peak (``torch.cuda.max_memory_allocated``) is measured on the card
(chip_smoke.py), not assumed.

The liveness model:

- Persistables, fed vars, fetch targets, and lod_link companions are
  PINNED: resident for the whole program.
- Every other var referenced by a global-block op is TRANSIENT: live
  from its first writer to its last reader. A read anywhere inside a
  control-flow op's sub-blocks — transitively, including attr-carried
  names — counts as a use AT that control-flow op's index
  (graph_utils.sub_block_read_names, the same rule PTV012/PTV013 and
  DCE apply).
- Vars declared only inside sub-blocks are charged to their
  control-flow op's single index.
- Sizes come from shape_infer specs; dynamic (-1/_DYN_DIM) dims
  resolve from the concrete feed shapes when the caller supplies them
  (the gate path seeds the spec inference) and otherwise fall back to
  Spec.nbytes' documented lower bound with a `dynamic` marker PTV050
  reports instead of guessing.

What torch holds beyond the liveness plan. `peak_bytes` is the JAX
package's plan, equal to it byte for byte. `device_peak_bytes` adds what
the card really holds under the port's eager, recorded execution, and is
what the gate prices (stricter, never looser):

- the caching allocator's rounding: a block is a multiple of 512 B, and
  a tensor above 1 MiB is charged whole 2 MiB segments;
- the cuBLAS and cuBLASLt workspaces of a program that runs a GEMM or a
  convolution (torch's sm_90 default, 32 MiB each, or what
  CUBLAS_WORKSPACE_CONFIG sets);
- the autograd records: a forward op whose grad op reads its record
  keeps its inputs and outputs until that grad op runs, wherever their
  last program reader is (core/lowering.py), and the tensors its
  lowering saves besides (the log-softmax of softmax_with_cross_entropy,
  dropout's keep mask);
- an unrolled `recurrent` loop keeps every step's body tensors for its
  grad op: its sub-block's vars count once per step, at the step
  input's batch (the plan sizes their dynamic batch dim at 1).

`MemoryPlan.device_charges` splits the difference at the device peak.
Under a `SpecLayout` (the sharded executor), each persistable's bytes
divide by its shard count: the per-rank plan.

Consumers: the memory_gate below (Executor.run / ServingEngine.warmup —
refuse before the cache key), analysis/passes/reuse.py (the rewrite
that aliases non-overlapping same-spec intervals), and chip_smoke.py's
estimate-to-peak lines.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

from ..monitor import STAT_ADD, STAT_SET
from .diagnostics import VerifyResult
from .graph_utils import (CTRL_FLOW_SUB_BLOCK, attr_read_names, op_names,
                          sub_block_index, sub_block_read_names)
from .shape_infer import Spec, declared_spec, program_specs

__all__ = ["VarInterval", "MemoryPlan", "analyze_program_memory",
           "reuse_assignments", "peak_from_intervals",
           "state_update_sinks", "apply_state_update_sinks",
           "resolve_budget_bytes", "memory_gate", "reset_memo"]

# Attrs through which ops read parent-scope vars by name (superset of
# graph_utils._READ_ATTRS: output_vars is a write-by-name, but a var
# named there must never be renamed/retimed either).
_NAME_ATTRS = ("input_vars", "carried_vars", "condition", "output_vars")

# PTV052 fires only when the estimated reuse savings are worth acting
# on: at least 1 MiB AND at least 5% of the estimated peak.
_REUSE_FINDING_MIN_BYTES = 1 << 20
_REUSE_FINDING_MIN_FRAC = 0.05

# torch's caching allocator: blocks are 512 B multiples; a tensor above
# 1 MiB is charged whole 2 MiB segments
ALLOC_BLOCK_BYTES = 512
ALLOC_LARGE_BYTES = 1 << 20
ALLOC_SEGMENT_BYTES = 2 << 20
# torch's default cuBLAS workspace on sm_90 (":4096:8"), and as much for
# cuBLASLt
DEFAULT_WORKSPACE_BYTES = 32 << 20
# tensors a lowering's autograd graph saves beyond the op's inputs and
# outputs: {op type: (input slot, bytes an element or None for the
# input's own itemsize)}: the log-softmax of the logits, dropout's keep
# mask
_SAVED_BY_LOWERING = {"softmax_with_cross_entropy": ("Logits", None),
                      "dropout": ("X", 1)}
# ops that run a cuBLAS GEMM or a cuDNN convolution (forward or grad)
_GEMM_OPS = frozenset({
    "mul", "matmul", "matmul_v2", "fc", "bmm", "conv2d",
    "depthwise_conv2d", "conv2d_transpose", "conv3d", "flash_attention",
    "multihead_matmul", "recurrent", "gru", "lstm", "dynamic_gru",
    "dynamic_lstm", "fusion_gru", "fusion_lstm", "sequence_conv",
})


@dataclasses.dataclass
class VarInterval:
    """One var's footprint: [def_idx, last_use] over global-block op
    indices. Pinned vars span the whole program (def_idx -1). A
    dynamic=True nbytes is a lower bound (Spec.nbytes)."""
    name: str
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int
    def_idx: int
    last_use: int
    pinned: bool = False
    dynamic: bool = False

    def overlaps(self, other: "VarInterval") -> bool:
        return not (self.last_use < other.def_idx
                    or other.last_use < self.def_idx)

    def to_dict(self) -> dict:
        return {"name": self.name, "nbytes": int(self.nbytes),
                "def": int(self.def_idx), "last_use": int(self.last_use),
                "pinned": bool(self.pinned),
                "dynamic": bool(self.dynamic)}


class MemoryPlan:
    """The artifact: intervals + timeline + peak, JSONL-serializable."""

    def __init__(self, program, intervals: Dict[str, VarInterval],
                 timeline: List[int], pinned_bytes: int,
                 unsized_vars: int, budget_bytes: int = 0,
                 reuse_bytes_available: int = 0, device_peak_bytes=None,
                 device_charges=None):
        self.fingerprint = program.fingerprint()
        block = program.global_block()
        self.op_count = len(block.ops)
        self.intervals = intervals
        self.timeline = timeline
        self.pinned_bytes = int(pinned_bytes)
        self.unsized_vars = int(unsized_vars)
        self.budget_bytes = int(budget_bytes)
        self.reuse_bytes_available = int(reuse_bytes_available)
        if timeline:
            self.peak_bytes = max(timeline)
            self.peak_op_idx = timeline.index(self.peak_bytes)
            op = block.ops[self.peak_op_idx]
            self.peak_op = f"{op.type}:0/{self.peak_op_idx}"
        else:
            self.peak_bytes = self.pinned_bytes
            self.peak_op_idx = -1
            self.peak_op = "program"
        self.dynamic = any(iv.dynamic for iv in intervals.values())
        # what the card holds: the plan plus the allocator's rounding,
        # the GEMM workspaces, the autograd records and unrolled loops
        self.device_peak_bytes = int(self.peak_bytes
                                     if device_peak_bytes is None
                                     else device_peak_bytes)
        self.device_charges = dict(device_charges or {})

    # -- queries ---------------------------------------------------------
    def residents_at(self, op_idx: int) -> List[VarInterval]:
        return [iv for iv in self.intervals.values()
                if iv.def_idx <= op_idx <= iv.last_use]

    def top_residents(self, k: int = 10,
                      at: Optional[int] = None) -> List[VarInterval]:
        """The k largest vars resident at `at` (default: the peak op)."""
        at = self.peak_op_idx if at is None else at
        live = self.residents_at(at) if at >= 0 \
            else list(self.intervals.values())
        return sorted(live, key=lambda iv: (-iv.nbytes, iv.name))[:k]

    def kv_summary(self) -> Optional[dict]:
        """Decode KV-cache footprint, when this program holds one.

        Recognizes the two generation KV layouts by persistable naming
        convention: `*.kv_pool_k` / `*.kv_pool_v` are the block pools
        of the paged decode step (models/gpt.build_paged_decode_step —
        sized num_blocks x block_size, decoupled from max_slots x
        max_seq), `*.cache_k` / `*.cache_v` are the contiguous slabs of
        the classic step (sized max_slots x max_seq). Both are pinned
        at full size by the planner, so `kv_bytes` is exactly what the
        PTV050 budget gate prices them at. None when the program holds
        neither (i.e. it is not a decode program)."""
        paged = [iv for iv in self.intervals.values()
                 if iv.name.endswith((".kv_pool_k", ".kv_pool_v"))]
        slab = [iv for iv in self.intervals.values()
                if iv.name.endswith((".cache_k", ".cache_v"))]
        if not paged and not slab:
            return None
        group = paged or slab
        return {"layout": "paged" if paged else "slab",
                "kv_bytes": int(sum(iv.nbytes for iv in group)),
                "kv_vars": len(group),
                "kv_frac_of_peak": round(
                    sum(iv.nbytes for iv in group)
                    / max(self.peak_bytes, 1), 4)}

    # -- diagnostics -----------------------------------------------------
    def findings(self) -> VerifyResult:
        """PTV05x findings against `budget_bytes` (0 = no budget: only
        the budget-free PTV052 reuse advisory can fire)."""
        res = VerifyResult()
        budget = self.budget_bytes
        bound = " (lower bound: unresolved dynamic dims sized at 1)" \
            if self.dynamic else ""
        if budget > 0 and self.peak_bytes > budget:
            res.add("PTV050",
                    f"estimated peak {_fmt_bytes(self.peak_bytes)}"
                    f"{bound} exceeds the "
                    f"{_fmt_bytes(budget)} budget "
                    f"(FLAGS_memory_budget_bytes) at op {self.peak_op}; "
                    f"top residents: " + ", ".join(
                        f"{iv.name}={_fmt_bytes(iv.nbytes)}"
                        for iv in self.top_residents(3)),
                    op_type=None if self.peak_op_idx < 0 else
                    self.peak_op.split(":", 1)[0],
                    block=0, op_idx=max(self.peak_op_idx, 0))
        elif budget > 0 and self.device_peak_bytes > budget:
            res.add("PTV050",
                    f"estimated device peak "
                    f"{_fmt_bytes(self.device_peak_bytes)}{bound} "
                    f"(the plan's {_fmt_bytes(self.peak_bytes)} plus "
                    + ", ".join(f"{k} {_fmt_bytes(v)}" for k, v in
                                self.device_charges.items())
                    + f") exceeds the {_fmt_bytes(budget)} budget "
                    f"(FLAGS_memory_budget_bytes)")
        if budget > 0:
            over = [iv for iv in self.intervals.values()
                    if iv.nbytes > budget]
            for iv in sorted(over, key=lambda iv: -iv.nbytes)[:5]:
                res.add("PTV051",
                        f"tensor {iv.name!r} alone is "
                        f"{_fmt_bytes(iv.nbytes)}"
                        f"{' (lower bound)' if iv.dynamic else ''}, "
                        f"larger than the {_fmt_bytes(budget)} budget — "
                        f"no buffer plan can fit it", var=iv.name)
        save = self.reuse_bytes_available
        if save >= _REUSE_FINDING_MIN_BYTES and \
                save >= _REUSE_FINDING_MIN_FRAC * max(self.peak_bytes, 1):
            res.add("PTV052",
                    f"{_fmt_bytes(save)} of dead-buffer reuse is "
                    f"available (same-spec non-overlapping intervals) — "
                    f"FLAGS_graph_opt_level>=2 with FLAGS_buffer_reuse "
                    f"rewrites them onto shared buffers")
        return res

    # -- serialization ---------------------------------------------------
    def to_record(self, model: Optional[str] = None) -> dict:
        rec = {"kind": "memory_plan",
               "fingerprint": self.fingerprint[:12],
               "ops": self.op_count,
               "vars": len(self.intervals),
               "est_peak_bytes": int(self.peak_bytes),
               "pinned_bytes": int(self.pinned_bytes),
               "peak_op": self.peak_op,
               "peak_op_idx": int(self.peak_op_idx),
               "dynamic": bool(self.dynamic),
               "unsized_vars": int(self.unsized_vars),
               "budget_bytes": int(self.budget_bytes),
               "reuse_bytes_available": int(self.reuse_bytes_available),
               "top_residents": [iv.to_dict()
                                 for iv in self.top_residents(10)],
               "findings": [d.to_dict()
                            for d in self.findings().findings]}
        kv = self.kv_summary()
        if kv is not None:
            rec["kv"] = kv
        if model is not None:
            rec["model"] = model
        return rec


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------

def _spec_of(name, env, block) -> Optional[Spec]:
    spec = env.get(name)
    if spec is None:
        var = block._find_var_recursive(name)
        spec = declared_spec(var) if var is not None else None
    return Spec(*spec) if spec is not None else None


def analyze_program_memory(program, feed_names: Iterable[str] = (),
                           fetch_names: Iterable[str] = (),
                           feed_shapes: Optional[Dict] = None,
                           budget_bytes: int = 0,
                           layout=None) -> MemoryPlan:
    """Liveness + timeline + peak for `program`'s global block.

    feed_shapes: {name: (shape, dtype)} of the concrete feed arrays —
    seeded into shape inference so dynamic dims resolve before size
    arithmetic; without it dynamic vars carry the Spec.nbytes lower
    bound and the plan is marked dynamic. feed_names defaults to
    feed_shapes' keys, else the program's is_data vars. layout: a
    parallel.layout.SpecLayout; each persistable's bytes divide by its
    shard count (the per-rank plan of the sharded executor, whose feeds
    are already the rank's rows).
    """
    block = program.global_block()
    n = len(block.ops)

    if feed_shapes:
        seed = {str(k): Spec(tuple(int(d) for d in s[0]), str(s[1]))
                for k, s in feed_shapes.items()}
    else:
        seed = None
    env = program_specs(program, seed)[0]

    feed_set = {str(x) for x in (feed_names or ())}
    if not feed_set and seed:
        feed_set = set(seed)
    if not feed_set:
        feed_set = {name for name, v in block.vars.items() if v.is_data}
    fetch_set = {str(x) for x in (fetch_names or ())}
    # lengths companions ride along with every ragged feed
    pin_names = set(feed_set) | fetch_set | set(program.lod_link.values())
    for name, v in block.vars.items():
        if v.persistable:
            pin_names.add(name)

    # -- def / last-use over the global block ---------------------------
    first_def: Dict[str, int] = {}
    last_use: Dict[str, int] = {}
    sub_local: Dict[str, VarInterval] = {}
    for op_idx, op in enumerate(block.ops):
        reads = set(op_names(op, "in")) | attr_read_names(op)
        if op.type in CTRL_FLOW_SUB_BLOCK:
            reads |= sub_block_read_names(program, op)
            _collect_sub_locals(program, op, op_idx, env, sub_local)
        if op.type == "recompute_segment":
            # a segment's inner tensors the reads above do not cover
            # (outputs nothing reads, and what its lowerings keep) live
            # only while it runs
            _collect_segment_locals(program, op, op_idx, env, block,
                                    sub_local, reads)
        for name in reads:
            last_use[name] = op_idx
        for name in op_names(op, "out"):
            first_def.setdefault(name, op_idx)
            last_use.setdefault(name, op_idx)

    intervals: Dict[str, VarInterval] = {}
    pinned_bytes = 0
    unsized = 0
    touched = set(first_def) | set(last_use) | pin_names
    for name in sorted(touched):
        spec = _spec_of(name, env, block)
        if spec is None:
            # no declared or inferred spec (opaque host-side values,
            # TensorArrays): lost coverage, surfaced as unsized_vars
            unsized += 1
            continue
        nbytes, dynamic = spec.nbytes(dyn_defaults=1)
        pinned = name in pin_names
        var = block.vars.get(name)
        if layout is not None and var is not None and var.persistable:
            nbytes //= layout.shard_count(name, tuple(spec.shape))
        iv = VarInterval(
            name=name, shape=tuple(spec.shape), dtype=str(spec.dtype),
            nbytes=nbytes, pinned=pinned, dynamic=dynamic,
            def_idx=-1 if pinned else first_def.get(
                name, last_use.get(name, 0)),
            last_use=max(n - 1, 0) if pinned
            else last_use.get(name, first_def.get(name, 0)))
        intervals[name] = iv
        if pinned:
            pinned_bytes += nbytes
    intervals.update(sub_local)

    timeline = _timeline(intervals.values(), n, pinned_bytes)
    reuse_avail = sum(nb for _, _, nb in reuse_assignments(
        program, intervals, feed_set, fetch_set))
    device_peak, charges = _device_peak(program, intervals, n, env,
                                        layout)
    plan = MemoryPlan(program, intervals, timeline, pinned_bytes,
                      unsized, budget_bytes=budget_bytes,
                      reuse_bytes_available=reuse_avail,
                      device_peak_bytes=device_peak,
                      device_charges=charges)
    return plan


def _hint_aliases(block, intervals):
    """({hint output: its input}, intervals with each such output of no
    bytes and its input living while the output is read): a shard_hint
    without a model-parallel reshard returns its input tensor itself; a
    view a recompute segment makes holds no bytes either. The device
    peak's view only; the plan's own intervals stay the JAX package's."""
    alias, out = {}, dict(intervals)
    for i, op in enumerate(block.ops):
        if op.type == "recompute_segment":
            # a view made inside a segment shares its input's bytes
            for sop in block.program.blocks[op.attrs["sub_block"]].ops:
                if sop.type not in _VIEW_OPS:
                    continue
                for n in op_names(sop, "out"):
                    iv = out.get(n)
                    if iv is not None and iv.def_idx == iv.last_use == i:
                        out[n] = dataclasses.replace(iv, nbytes=0)
            continue
        if op.type != "shard_hint" or (op.attrs.get("_mp") or {}).get("in"):
            continue
        src = (op.inputs.get("X") or [None])[0]
        dst = (op.outputs.get("Out") or [None])[0]
        a, b = out.get(src), out.get(dst)
        if a is None or b is None or a.pinned or b.pinned:
            continue
        src = alias.get(src, src)
        a = out[src]
        alias[dst] = src
        out[src] = dataclasses.replace(
            a, last_use=max(a.last_use, b.last_use))
        out[dst] = dataclasses.replace(b, nbytes=0)
    return alias, out


def alloc_bytes(nbytes: int) -> int:
    """The bytes torch's caching allocator charges for a tensor of
    `nbytes`: 512 B blocks, whole 2 MiB segments above 1 MiB."""
    if nbytes <= 0:
        return 0
    unit = ALLOC_SEGMENT_BYTES if nbytes > ALLOC_LARGE_BYTES \
        else ALLOC_BLOCK_BYTES
    return -(-int(nbytes) // unit) * unit


def workspace_bytes() -> int:
    """cuBLAS + cuBLASLt workspace: CUBLAS_WORKSPACE_CONFIG's
    ':KiB:count' pairs when set, else torch's sm_90 default, each."""
    import os
    import re
    cfg = os.environ.get("CUBLAS_WORKSPACE_CONFIG", "")
    pairs = re.findall(r":(\d+):(\d+)", cfg)
    one = sum(int(k) * 1024 * int(c) for k, c in pairs) if pairs \
        else DEFAULT_WORKSPACE_BYTES
    return 2 * one


def _itemsize(dtype) -> int:
    from ..core.dtypes import as_torch_dtype
    return as_torch_dtype(dtype).itemsize


def _recurrent_steps(op, env, block):
    """(steps, batch) of a `recurrent` op: its first step input's time
    and batch dims."""
    names = [n for n in op.inputs.get("X", ()) if n]
    spec = _spec_of(names[0], env, block) if names else None
    if spec is None or len(spec.shape) < 2:
        return 1, 1
    t, b = spec.shape[:2]
    if not op.attrs.get("time_major", False):
        t, b = b, t
    return max(int(t), 1), max(int(b), 1)


def _adapter_buffers(op, i, g, intervals):
    """The tensors a model-parallel rank program's adapters make for op
    `i` (parallel/model_parallel.py): a gathered input is the whole
    tensor, held by the op's record to its grad op `g`; a partial sum
    reduced to the whole output is one more output-sized buffer."""
    spec = op.attrs.get("_mp") or {}
    sizes = spec.get("sizes") or {}
    out = []
    for side, slots in (("in", op.inputs), ("out", op.outputs)):
        for slot, per in (spec.get(side) or {}).items():
            names = slots.get(slot, [])
            for j, ads in per.items():
                j = int(j)
                iv = intervals.get(names[j]) if j < len(names) else None
                if iv is None:
                    continue
                nb = iv.nbytes
                grown = False
                for ad in ads:
                    n = int(sizes.get(ad[1], 1))
                    if ad[0] in ("gather", "fsdp"):
                        nb *= n
                        grown = True
                    elif ad[0] == "scatter":
                        nb //= max(n, 1)
                    elif ad[0] in ("reduce", "rs"):
                        grown = True
                if grown:
                    out.append(VarInterval(
                        name=f"{names[j]}@mp{i}", shape=iv.shape,
                        dtype=iv.dtype, nbytes=nb, def_idx=i,
                        last_use=i if g is None else g))
    return out


def _device_peak(program, intervals, n_ops, env, layout=None):
    """(device peak bytes, {charge: bytes}): the plan's timeline with the
    autograd records' liveness, the unrolled loops' steps, the
    recompute segments' second run, the model-parallel adapters'
    buffers, the allocator's rounding and the GEMM workspaces added in
    that order; each charge is what it adds to the peak."""
    block = program.global_block()
    rec_alias = dict(getattr(program, "_record_alias", None) or {})
    grad_at = {}
    for i, op in enumerate(block.ops):
        if op.type == "grad::generic":
            fid = op.attrs["fwd_id"]
            grad_at[rec_alias.get(fid, fid)] = i
    alias, intervals = _hint_aliases(block, intervals)
    held = {}       # var -> the grad op index its record holds it to
    loops = {}      # sub-block local -> (bytes of all steps, grad op)
    saved = []      # tensors lowerings save: VarIntervals to the grad op
    again = []      # recompute segments' inner tensors at their grad op
    adapted = []    # model-parallel adapters' buffers
    gemm = False
    for i, op in enumerate(block.ops):
        gemm = gemm or op.type in _GEMM_OPS
        if op.type == "recompute_segment":
            gemm = gemm or any(
                sop.type in _GEMM_OPS for sop in
                program.blocks[op.attrs["sub_block"]].ops)
        g = grad_at.get(op.id)
        if op.attrs.get("_mp"):
            adapted.extend(_adapter_buffers(op, i, g, intervals))
        if g is None:
            continue
        if op.type == "recompute_segment":
            sb = op.attrs["sub_block"]
            inner = set(_segment_locals(program, op))
            for name, iv in intervals.items():
                base = name.split("@")[0]
                if f"@b{sb}" in name or (base in inner
                                         and "@" not in name):
                    again.append(dataclasses.replace(
                        iv, name=f"{name}@again", def_idx=g,
                        last_use=g))
        for name in op_names(op, "in") + op_names(op, "out"):
            if name in intervals:
                # a hint's output is its input: hold the input
                name = alias.get(name, name)
                held[name] = max(held.get(name, -1), g)
        if op.type in _SAVED_BY_LOWERING:
            slot, per = _SAVED_BY_LOWERING[op.type]
            src = (op.inputs.get(slot) or [None])[0]
            iv = intervals.get(src)
            if iv is not None:
                nb = iv.nbytes if per is None else \
                    iv.nbytes // _itemsize(iv.dtype) * per
                saved.append(VarInterval(
                    name=f"{src}@saved{i}", shape=iv.shape, dtype=iv.dtype,
                    nbytes=nb, def_idx=i, last_use=g))
        if op.type == "recurrent":
            # a step var's dynamic dim is the batch (sized 1 in the plan)
            steps, batch = _recurrent_steps(op, env, block)
            sb = sub_block_index(program, op)
            for name in (program.blocks[sb].vars if sb is not None
                         else ()):
                iv = intervals.get(f"{name}@b{sb}")
                if iv is not None:
                    one = Spec(iv.shape, iv.dtype).nbytes(batch)[0]
                    loops[iv.name] = (one * steps, g)

    def peak(use_held, use_loops, rounded, use_again=True,
             use_adapted=True):
        ivs = list(saved) if use_held else []
        if use_held and use_again:
            ivs += again
        if use_held and use_adapted:
            ivs += adapted
        if rounded:
            ivs = [dataclasses.replace(iv, nbytes=alloc_bytes(iv.nbytes))
                   for iv in ivs]
        pinned = 0
        for name, iv in intervals.items():
            nb = iv.nbytes
            last = iv.last_use
            if use_held and name in held:
                last = max(last, held[name])
            if use_loops and name in loops:
                nb, grad_op = loops[name]
                last = max(last, grad_op)
            if rounded:
                nb = alloc_bytes(nb)
            if iv.pinned:
                pinned += nb
            else:
                ivs.append(dataclasses.replace(iv, nbytes=nb,
                                               last_use=last))
        tl = _timeline(ivs, n_ops, pinned)
        return max(tl) if tl else pinned

    steps = [peak(False, False, False),
             peak(True, False, False, False, False),
             peak(True, True, False, False, False),
             peak(True, True, False, True, False),
             peak(True, True, False), peak(True, True, True)]
    ws = workspace_bytes() if gemm else 0
    charges = {"autograd_records": steps[1] - steps[0],
               "loop_steps": steps[2] - steps[1],
               "alloc_rounding": steps[5] - steps[4],
               "workspaces": ws}
    if again:
        charges["recompute_segments"] = steps[3] - steps[2]
    if adapted:
        charges["collective_buffers"] = steps[4] - steps[3]
    return steps[5] + ws, charges


# ops whose output is a view of their input: inside a recompute segment
# (every inner tensor held until the segment returns) it adds no bytes
_VIEW_OPS = frozenset({"reshape2", "reshape", "transpose2", "transpose",
                       "squeeze2", "unsqueeze2", "flatten2"})


def _segment_locals(program, op):
    """The vars a recompute segment's ops write that it does not
    output, views of another tensor left out: its inner activations."""
    keep = set(op.attrs.get("output_vars", ()))
    names = []
    for sop in program.blocks[op.attrs["sub_block"]].ops:
        if sop.type in _VIEW_OPS:
            continue
        names += [n for n in op_names(sop, "out")
                  if n not in keep and n not in names]
    return names


def _collect_segment_locals(program, op, op_idx, env, block, out,
                            charged):
    """A recompute segment's inner tensors not in `charged` (the names
    the segment op's own interval already covers: what its ops read)
    and the tensors its lowerings keep (_SAVED_BY_LOWERING), charged to
    its index: the segment holds every inner tensor until it returns."""
    sb = op.attrs["sub_block"]

    def spec_of(name):
        var = block._find_var_recursive(name)
        spec = env.get(name) or (declared_spec(var) if var is not None
                                 else None)
        return None if spec is None else Spec(*spec)

    def add(key, spec, nbytes, dynamic):
        out[key] = VarInterval(
            name=key, shape=tuple(spec.shape), dtype=str(spec.dtype),
            nbytes=nbytes, def_idx=op_idx, last_use=op_idx,
            dynamic=dynamic)

    for name in _segment_locals(program, op):
        spec = spec_of(name)
        if spec is not None and name not in charged:
            add(f"{name}@b{sb}", spec, *spec.nbytes(dyn_defaults=1))
    for i, sop in enumerate(program.blocks[sb].ops):
        if sop.type in _SAVED_BY_LOWERING:
            slot, per = _SAVED_BY_LOWERING[sop.type]
            src = (sop.inputs.get(slot) or [None])[0]
            spec = spec_of(src) if src else None
            if spec is not None:
                nb, dyn = spec.nbytes(dyn_defaults=1)
                if per is not None:
                    nb = nb // _itemsize(spec.dtype) * per
                add(f"{src}@saved@b{sb}.{i}", spec, nb, dyn)


def _collect_sub_locals(program, op, op_idx, env, out):
    """Vars declared only inside `op`'s sub-blocks: charged to the
    control-flow op's single index (keyed name@bN to avoid colliding
    with a same-named global var)."""
    stack = [op]
    seen = set()
    while stack:
        sb = sub_block_index(program, stack.pop())
        if sb is None or sb in seen:
            continue
        seen.add(sb)
        blk = program.blocks[sb]
        for name, var in blk.vars.items():
            spec = env.get(name) or declared_spec(var)
            if spec is None:
                continue
            nbytes, dynamic = Spec(*spec).nbytes(dyn_defaults=1)
            out[f"{name}@b{sb}"] = VarInterval(
                name=f"{name}@b{sb}", shape=tuple(spec[0]),
                dtype=str(spec[1]), nbytes=nbytes, def_idx=op_idx,
                last_use=op_idx, dynamic=dynamic)
        for sop in blk.ops:
            if sop.type in CTRL_FLOW_SUB_BLOCK:
                stack.append(sop)


def _timeline(intervals, n_ops, pinned_bytes) -> List[int]:
    alloc = [0] * (n_ops + 1)
    free = [0] * (n_ops + 1)
    for iv in intervals:
        if iv.pinned:
            continue
        alloc[max(iv.def_idx, 0)] += iv.nbytes
        free[max(iv.last_use, 0)] += iv.nbytes
    timeline = []
    cur = pinned_bytes
    for i in range(n_ops):
        cur += alloc[i]
        timeline.append(cur)
        cur -= free[i]
    return timeline


def peak_from_intervals(intervals, n_ops, pinned_bytes) -> int:
    """Peak of a rebuilt timeline — the reuse pass's cheap 'what would
    the peak be after merging these intervals' query (no re-inference)."""
    tl = _timeline(intervals, n_ops, pinned_bytes)
    return max(tl) if tl else pinned_bytes


# ---------------------------------------------------------------------------
# reuse planning (consumed by analysis/passes/reuse.py and PTV052)
# ---------------------------------------------------------------------------

def reuse_assignments(program, intervals: Dict[str, VarInterval],
                      feed_set, fetch_set) -> List[Tuple[str, str, int]]:
    """Greedy linear-scan packing of same-(shape, dtype) transient
    intervals onto shared buffers -> [(victim, root, nbytes)]: rename
    `victim` to `root` and the allocation disappears.

    A var is a candidate iff renaming it can never change observable
    values or break name resolution: transient (not pinned), written
    exactly once in the global block by a plain op (no inplace/merge/
    control-flow/side-effect writers), read at least once there, and
    never referenced by name anywhere else — not in any sub-block, not
    through name-carrying attrs, not in lod_link.

    Two interval relationships qualify, mirroring the reference's
    memory_optimize_pass / inplace_op_pass split:

    - DISJOINT (the buffer's last read is strictly before the reuser's
      def op): a pure rename — each reader still receives exactly the
      value its renamed writer produced.
    - IN-PLACE (the buffer's last read IS the reuser's def op, and that
      op reads the buffer): the rename yields `root = f(root, ...)`.
      run_op gathers every input before any output is bound, so the
      dying input value is fully consumed first and the result is still
      bit-exact — but it is only the in-place form that can LOWER the
      estimated peak, because at the def op one buffer now stands where
      two were resident. fused_elementwise def ops are excluded here:
      their lowering replays sub-ops against a mutable env, so a later
      sub-op could re-read the clobbered external input.

    Either way the PTV014/PTV015 lints stay silent on the result: the
    WAW scan pops a var on read before the re-write lands, and PTV015
    only tracks registry-inplace ops.

    The pool key is the SYMBOLIC (shape, dtype): dynamic dims pair only
    with identically-placed dynamic dims, so re-verification's PTV020
    declared-vs-inferred check stays clean, and the one batch/seq axis
    a program resolves at feed time resolves identically for both.
    """
    from ..core.registry import REGISTRY
    from .graph_utils import MERGE_OPS, SIDE_EFFECT_OPS
    from .shape_infer import OPAQUE_OPS

    block = program.global_block()
    banned = set(feed_set) | set(fetch_set)
    banned |= set(program.lod_link) | set(program.lod_link.values())
    writers: Dict[str, List[int]] = {}
    for op_idx, op in enumerate(block.ops):
        banned |= attr_read_names(op, _NAME_ATTRS)
        for name in op_names(op, "out"):
            writers.setdefault(name, []).append(op_idx)
        if op.type in CTRL_FLOW_SUB_BLOCK:
            banned |= sub_block_read_names(program, op)
    for blk in program.blocks:
        if blk.idx == block.idx:
            continue
        for op in blk.ops:
            banned |= set(op_names(op, "in"))
            banned |= set(op_names(op, "out"))
            banned |= attr_read_names(op, _NAME_ATTRS)

    def plain_writer(op_idx) -> bool:
        op = block.ops[op_idx]
        if op.type in SIDE_EFFECT_OPS or op.type in OPAQUE_OPS \
                or op.type in MERGE_OPS \
                or op.type in CTRL_FLOW_SUB_BLOCK:
            return False
        opdef = REGISTRY._ops.get(op.type)
        if opdef is None or opdef.inplace:
            return False
        # writers re-reading one of their own outputs are inplace-ish
        return not (set(op_names(op, "in")) & set(op_names(op, "out")))

    cands = []
    for iv in intervals.values():
        if iv.pinned or iv.nbytes <= 0 or iv.name in banned:
            continue
        w = writers.get(iv.name, [])
        if len(w) != 1 or not plain_writer(w[0]):
            continue
        if iv.last_use <= iv.def_idx:
            # never read after its def: a root no reader ever pops
            # would trip the WAW lint on the rewritten program
            continue
        cands.append(iv)

    rename: Dict[str, str] = {}

    def inplace_ok(iv, root) -> bool:
        # equality case: the slot's last read is AT iv's def op — legal
        # only if that op actually consumes the buffer (reads root, or
        # a victim already renamed onto it) and replays nothing from a
        # mutable env (no fused_elementwise)
        op = block.ops[iv.def_idx]
        if op.type == "fused_elementwise":
            return False
        return any(rename.get(n, n) == root
                   for n in op_names(op, "in"))

    cands.sort(key=lambda iv: (iv.def_idx, iv.name))
    pool: Dict[tuple, List[list]] = {}
    out: List[Tuple[str, str, int]] = []
    for iv in cands:
        key = (iv.shape, iv.dtype)
        slots = pool.setdefault(key, [])
        # prefer the in-place form: only a handoff AT the def op
        # collapses two resident buffers into one and lowers the peak
        chosen = next((s for s in slots
                       if s[0] == iv.def_idx and inplace_ok(iv, s[1])),
                      None)
        if chosen is None:
            chosen = next((s for s in slots if s[0] < iv.def_idx), None)
        if chosen is not None:
            out.append((iv.name, chosen[1], iv.nbytes))
            rename[iv.name] = chosen[1]
            chosen[0] = iv.last_use
        else:
            slots.append([iv.last_use, iv.name])
    return out


def state_update_sinks(program) -> Dict[int, int]:
    """Plan {op_idx: target_idx} moves that sink each in-place state
    update (adamw/sgd/momentum/... — registry-inplace ops whose every
    output is a persistable) from the optimizer tail up to just past
    its dependency frontier.

    Why this lives in the memory planner: builders append ALL optimizer
    ops after the whole backward, so every weight gradient stays
    resident from its producer until the tail — on the bench builders
    that stack of w@GRAD buffers IS the peak op's resident set, and no
    rename can shrink it (the intervals genuinely overlap). Moving each
    update to the earliest legal index ends the gradient's interval at
    the point the weight was last read, deflating the plateau.

    The interchange is observationally exact under the executor's
    env-dict semantics iff nothing between target and origin (a) writes
    any of the op's inputs, (b) reads any of its outputs (they would
    see the updated value), or (c) writes any of its outputs. The
    frontier below is the last such index; reads include attr-carried
    names and transitive sub-block reads, the same rule liveness uses.
    Every op before the origin is scanned, so a mover can never hop
    over its gradient producer, a stale-weight reader, or another
    mover it depends on.
    """
    from ..core.registry import REGISTRY
    from .graph_utils import SIDE_EFFECT_OPS

    block = program.global_block()
    ops = block.ops
    reads_at, writes_at = [], []
    for op in ops:
        r = set(op_names(op, "in")) | attr_read_names(op)
        if op.type in CTRL_FLOW_SUB_BLOCK:
            r |= sub_block_read_names(program, op)
        reads_at.append(r)
        writes_at.append(set(op_names(op, "out")))

    moves: Dict[int, int] = {}
    for i, op in enumerate(ops):
        opdef = REGISTRY._ops.get(op.type)
        if opdef is None or not opdef.inplace \
                or op.type in SIDE_EFFECT_OPS \
                or op.type in CTRL_FLOW_SUB_BLOCK:
            continue
        outs = writes_at[i]
        if not outs:
            continue
        var_of = {nm: block._find_var_recursive(nm) for nm in outs}
        if any(v is None or not v.persistable for v in var_of.values()):
            continue
        ins = reads_at[i]
        frontier = -1
        for j in range(i):
            if writes_at[j] & ins or reads_at[j] & outs \
                    or writes_at[j] & outs:
                frontier = j
        if frontier + 1 < i:
            moves[i] = frontier + 1
    return moves


def apply_state_update_sinks(program,
                             moves: Optional[Dict[int, int]] = None) -> int:
    """Reorder the global block per `moves` (default: plan them).
    Movers land just before the op currently at their target index;
    relative order among ops with equal keys is preserved (stable
    sort), which keeps mover-vs-mover dependencies legal — a mover
    reading another's output has a frontier at or past that mover's
    origin. Returns the number of ops moved."""
    if moves is None:
        moves = state_update_sinks(program)
    if not moves:
        return 0
    block = program.global_block()
    keyed = sorted(enumerate(block.ops),
                   key=lambda t: (moves.get(t[0], t[0]) - 0.5
                                  if t[0] in moves else t[0], t[0]))
    block.ops = [op for _, op in keyed]
    program._fp_cache = None
    return len(moves)


# ---------------------------------------------------------------------------
# the memory gate (Executor.run / ServingEngine.warmup)
# ---------------------------------------------------------------------------

_MEMO_LOCK = threading.Lock()
_GATE_MEMO: "OrderedDict[tuple, MemoryPlan]" = OrderedDict()
_MEMO_CAP = 128


def reset_memo():
    """Drop gate memoization (tests; after flag flips)."""
    with _MEMO_LOCK:
        _GATE_MEMO.clear()
    from .shape_infer import reset_memo as _reset_spec_memo
    _reset_spec_memo()


def resolve_budget_bytes() -> int:
    """FLAGS_memory_budget_bytes resolved: >0 = explicit budget; 0 =
    auto from the card's reported bytes_limit, its total memory (0
    without a card — the gate then cannot fire); -1 = never apply a
    budget."""
    from ..core.flags import FLAGS
    b = int(FLAGS.memory_budget_bytes)
    if b > 0:
        return b
    if b < 0:
        return 0
    from ..core.memory import device_bytes_limit
    return device_bytes_limit()


def memory_gate(program, feed_shapes: Optional[Dict] = None,
                fetch_names=None, where="executor", layout=None
                ) -> Optional[MemoryPlan]:
    """The FLAGS_memory_gate gate: off | warn | error (default error).

    Analyzes once per (program fingerprint, concrete feed shapes,
    fetch names, resolved budget, layout's mesh) and memoizes; the gate
    prices the device peak (`device_peak_bytes`). In 'error' mode PTV050/
    PTV051 raise ProgramVerificationError — callers place this BEFORE
    the executor's cache key, so a program that cannot fit is refused
    with cache_stats() showing no miss and nothing allocated. PTV052 (and
    everything in 'warn' mode) surfaces as one summarized warning.
    """
    from ..core.flags import FLAGS
    mode = FLAGS.memory_gate
    if mode == "off":
        return None
    if mode not in ("warn", "error"):
        raise ValueError(
            f"FLAGS_memory_gate={mode!r}: expected 'off', 'warn' or "
            f"'error'")

    budget = resolve_budget_bytes()
    shapes_sig = tuple(sorted(
        (str(n), tuple(int(d) for d in s[0]), str(s[1]))
        for n, s in (feed_shapes or {}).items()))
    key = (program.fingerprint(), shapes_sig,
           tuple(str(n) for n in (fetch_names or ())), budget,
           None if layout is None else tuple(
               (str(a), int(layout.mesh.shape[a]))
               for a in layout.mesh.axis_names))
    with _MEMO_LOCK:
        plan = _GATE_MEMO.get(key)
        if plan is not None:
            _GATE_MEMO.move_to_end(key)
    fresh = plan is None
    if fresh:
        plan = analyze_program_memory(
            program, feed_names=[n for n, _, _ in shapes_sig],
            fetch_names=key[2], feed_shapes=dict(
                (n, (shp, dt)) for n, shp, dt in shapes_sig),
            budget_bytes=budget, layout=layout)
        with _MEMO_LOCK:
            _GATE_MEMO[key] = plan
            while len(_GATE_MEMO) > _MEMO_CAP:
                _GATE_MEMO.popitem(last=False)
        STAT_ADD("analysis.mem_plans")
        STAT_SET("analysis.mem_peak_bytes", plan.peak_bytes)

    res = plan.findings()
    if mode == "error":
        if res.errors():
            STAT_ADD("analysis.mem_gate_rejects")
            res.raise_if_errors()
        if fresh and res.findings:
            _warn_once(where, res)
    elif fresh and res.findings:
        _warn_once(where, res)
    return plan


def _warn_once(where, res):
    import warnings
    warnings.warn(f"[{where}] memory analysis: {res.summary()} "
                  f"(FLAGS_memory_gate; see docs/memory_planning.md)")
