"""Static sharding analyzer: layout propagation + communication costs.

Reference analogue: the cross-replica weight-update sharding analysis of
"Automatic Cross-Replica Sharding of Weight Update in Data-Parallel
Training" (arxiv 2004.13336) — decide statically how tensors split over
the mesh and what collectives reconcile the splits — applied to the
Program IR the way analysis/memory.py applied liveness analysis: with
ZERO device work, before a program's first run. The JAX package's
analyzer on the port's IR: the same rules, findings and prices over the
port's `SpecLayout` (a mesh of ranks, or a rank-free MeshDims).

The pass propagates the `parallel/layout.SpecLayout` annotations through
the global block op-by-op:

- elementwise ops preserve their operands' per-dim axis assignment (and
  flag operands that DISAGREE on a mesh axis — PTV060);
- matmul-family ops contract: both contraction dims sharded on the same
  axis means a partial-sum output (priced as an all-reduce, the Megatron
  row-parallel pattern); one side sharded means an implicit all-gather
  reshard (PTV061 when the bytes are large); different axes on the two
  contraction dims is PTV060;
- reshape/transpose remap the assignment dim-for-dim (merged/split dims
  that cannot carry their axis are priced as reshards);
- reductions drop axes: reducing over a sharded dim yields a partial
  result, priced as an all-reduce of the output;
- explicit collectives (`c_allreduce_*`, `c_allgather`, ...) and the
  MULTICHIP ops (`ring_attention`, `ulysses_attention`, `moe_ffn`,
  `shard_hint`) have dedicated rules;
- unknown ops fall back to "replicate the outputs + reshard any sharded
  input" and emit one PTV063 finding per op type.

Every priced collective sums into `collective_bytes_per_step` — the
predicted counterpart of the sharded bench path's measured value, and
now the ONE oracle behind `SpecLayout.collective_bytes_estimate`. Ring
conventions: all-reduce costs 2x the payload, all-gather /
reduce-scatter / all-to-all 1x. Gradient synchronisation is priced
per-parameter at the op that produces `{param}@GRAD` (2x payload /
shard count — identical arithmetic to the closed-form
`SpecLayout.gradient_sync_bytes`, which the regression tests reconcile
against). Non-divisible dims the layout silently replicated
(`SpecLayout.fallbacks`) become PTV062 findings.

Consumers: the `sharding_gate` below (Executor.run /
ServingEngine.warmup — FLAGS_sharding_verify, reject before the cache
key records a miss), `SpecLayout.collective_bytes_estimate`, and
chip_smoke.py's data-parallel phases, which print it beside the bytes
the sharded executor moved.

The rank walk (`plan_rank_sharding`, the port's own) is the same walk
over one model axis as each rank of a model-parallel mesh runs the
program: it gives every var its layout and every op the collectives
that reconcile them, and parallel/model_parallel.py builds the rank
program from exactly that plan. Its prices are what the rank program
moves (collective.py's counts, forward and backward); the gate prices a
model-parallel run with it.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..core.dtypes import as_np_dtype, as_torch_dtype
from ..monitor import STAT_ADD, STAT_SET
from ..ops.collective import Split
from .diagnostics import VerifyResult
from .shape_infer import OPAQUE_OPS, Spec, declared_spec, program_specs

__all__ = ["ShardingReport", "analyze_program_sharding", "sharding_gate",
           "plan_rank_sharding", "reset_memo", "RESHARD_FINDING_MIN_BYTES"]

# PTV061 fires only when one op's implicit reshard moves at least this
# many bytes — below it the reshard is noise, not a hot-path hazard.
RESHARD_FINDING_MIN_BYTES = 1 << 20

# Caps so a malformed 1000-op program yields a readable report, not a
# thousand findings.
_MAX_FINDINGS_PER_RULE = 12

# Elementwise / activation-shaped ops: per-dim layouts pass through
# unchanged (superset of the fusion pass's set — here only the layout
# contract matters, not fusibility).
_ELEMENTWISE = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "elementwise_mod", "elementwise_floordiv",
    "relu", "relu6", "gelu", "sigmoid", "tanh", "sqrt", "rsqrt",
    "square", "exp", "log", "abs", "floor", "ceil", "round", "pow",
    "scale", "cast", "clip", "dropout", "fill_any_like", "assign",
    "label_smooth", "sum", "fused_elementwise", "leaky_relu", "swish",
    "hard_swish", "hard_sigmoid", "elu", "softplus", "softsign",
    "silu", "increment", "logical_not", "logical_and", "logical_or",
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "maximum", "minimum",
})

# Ops that keep dim 0 (batch) from their principal input and replicate
# the rest: the window/channel dims are never sharded by the layout
# rules, so carrying only the batch axis is exact for them.
_DIM0_PRESERVING = frozenset({
    "conv2d", "conv2d_transpose", "depthwise_conv2d", "pool2d",
    "batch_norm", "bilinear_interp", "nearest_interp", "one_hot",
    "top_k", "accuracy", "add_position_encoding", "sequence_softmax",
    "lrn", "pad2d",
})

# Principal-input layouts pass through whole (same-rank, same meaning).
_PRESERVE_ALL = frozenset({"flash_attention", "layer_norm", "softmax"})

_MATMUL_OPS = frozenset({"mul", "matmul", "matmul_v2"})

_REDUCE_OPS = frozenset({"reduce_mean", "reduce_sum", "reduce_max",
                         "reduce_min", "reduce_prod", "mean"})

_ALLREDUCE_OPS = frozenset({"c_allreduce_sum", "c_allreduce_max",
                            "c_allreduce_min", "c_allreduce_prod",
                            "allreduce"})

# Principal input slot preference for rules that key on one input.
_PRINCIPAL_SLOTS = ("X", "Input", "Q", "Logits", "Out@GRAD")


def _principal_input(op) -> Optional[str]:
    for slot in _PRINCIPAL_SLOTS:
        names = op.inputs.get(slot) or ()
        for n in names:
            if n:
                return n
    for names in op.inputs.values():
        for n in names:
            if n:
                return n
    return None


class _Cost:
    """One priced collective."""
    __slots__ = ("kind", "axis", "bytes", "op_idx", "op_type", "note")

    def __init__(self, kind, axis, nbytes, op_idx, op_type, note=""):
        self.kind = kind
        self.axis = axis
        self.bytes = int(max(nbytes, 0))
        self.op_idx = op_idx
        self.op_type = op_type
        self.note = note

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "bytes": int(self.bytes),
             "where": f"{self.op_type}:0/{self.op_idx}"}
        if self.axis:
            d["axis"] = str(self.axis)
        if self.note:
            d["note"] = self.note
        return d


def _fmt_parts(parts) -> str:
    def one(p):
        if p is None:
            return "-"
        if isinstance(p, (tuple, list)):
            return "(" + ",".join(str(a) for a in p) + ")"
        return str(p)
    return "[" + ",".join(one(p) for p in parts) + "]"


class ShardingReport:
    """The artifact: per-op layouts + priced collectives + findings."""

    def __init__(self, program, layout):
        self.fingerprint = program.fingerprint()
        self.op_count = len(program.global_block().ops)
        self.mesh_axes = [str(a) for a in layout.mesh.axis_names]
        self.mesh_shape = [int(layout.mesh.shape[a])
                           for a in layout.mesh.axis_names]
        self.mesh_devices = int(layout.mesh.size)
        self.costs: List[_Cost] = []
        self.rows: List[dict] = []          # per-op: sharded/priced ops
        self.uncovered: List[str] = []      # op types with no rule
        self.result = VerifyResult()
        self.dynamic = False                # some bytes were lower bounds

    # -- totals ----------------------------------------------------------
    @property
    def collective_bytes_per_step(self) -> int:
        return int(sum(c.bytes for c in self.costs))

    @property
    def reshard_bytes_per_step(self) -> int:
        return int(sum(c.bytes for c in self.costs
                       if c.kind == "reshard"))

    @property
    def grad_sync_bytes(self) -> int:
        return int(sum(c.bytes for c in self.costs
                       if c.kind == "grad_sync"))

    def findings(self) -> VerifyResult:
        return self.result

    # -- serialization ---------------------------------------------------
    def to_record(self, model: Optional[str] = None) -> dict:
        top = sorted(self.costs, key=lambda c: (-c.bytes, c.op_idx))
        rec = {"kind": "sharding_report",
               "fingerprint": self.fingerprint[:12],
               "mesh_shape": list(self.mesh_shape),
               "mesh_axes": list(self.mesh_axes),
               "mesh_devices": int(self.mesh_devices),
               "ops": int(self.op_count),
               "uncovered_op_types": sorted(self.uncovered),
               "collective_bytes_per_step":
                   int(self.collective_bytes_per_step),
               "reshard_bytes_per_step":
                   int(self.reshard_bytes_per_step),
               "grad_sync_bytes": int(self.grad_sync_bytes),
               "dynamic": bool(self.dynamic),
               "collectives": [c.to_dict() for c in top[:20]],
               "counts": {"error": len(self.result.errors()),
                          "warn": len(self.result.warnings())},
               "findings": [d.to_dict()
                            for d in self.result.findings]}
        if model is not None:
            rec["model"] = model
        return rec


# ---------------------------------------------------------------------------
# the analysis
# ---------------------------------------------------------------------------

class _Analyzer:
    def __init__(self, program, layout, report,
                 reshard_threshold=RESHARD_FINDING_MIN_BYTES):
        self.program = program
        self.block = program.global_block()
        self.layout = layout
        self.report = report
        self.threshold = int(reshard_threshold)
        self.mesh_shape = {str(a): int(layout.mesh.shape[a])
                           for a in layout.mesh.axis_names}
        self.env: Dict[str, Tuple] = {}     # var name -> parts tuple
        self.specs: Dict[str, Spec] = {}
        self._rule_counts: Dict[str, int] = {}
        self._uncovered_seen = set()

    # -- small helpers ---------------------------------------------------
    def _find(self, rule, msg, op=None, op_idx=None, var=None):
        n = self._rule_counts.get(rule, 0)
        self._rule_counts[rule] = n + 1
        if n >= _MAX_FINDINGS_PER_RULE:
            return
        self.report.result.add(
            rule, msg, op_type=getattr(op, "type", None), block=0,
            op_idx=op_idx, var=var)

    def _spec(self, name) -> Optional[Spec]:
        spec = self.specs.get(name)
        if spec is None:
            var = self.block._find_var_recursive(name)
            spec = declared_spec(var) if var is not None else None
        return Spec(*spec) if spec is not None else None

    def _nbytes(self, name) -> int:
        spec = self._spec(name)
        if spec is None:
            return 0
        n, dyn = spec.nbytes(dyn_defaults=1)
        if dyn:
            self.report.dynamic = True
        return n

    def _axis_size(self, axes) -> int:
        n = 1
        for a in (axes if isinstance(axes, (tuple, list)) else (axes,)):
            if a is not None:
                n *= int(self.mesh_shape.get(str(a), 1))
        return n

    def _shard_factor(self, parts) -> int:
        n = 1
        for p in parts or ():
            if p is not None:
                n *= self._axis_size(p)
        return n

    def _parts_of(self, name, rank=None) -> tuple:
        parts = self.env.get(name)
        if parts is None:
            parts = ()
        if rank is not None:
            parts = tuple(parts)[:rank] \
                + (None,) * max(rank - len(parts), 0)
        return tuple(parts)

    def _rank_of(self, name) -> int:
        spec = self._spec(name)
        return len(spec.shape) if spec is not None else 0

    def _cost(self, kind, axis, nbytes, op_idx, op_type, note=""):
        self.report.costs.append(
            _Cost(kind, axis, nbytes, op_idx, op_type, note))

    def _reshard(self, name, parts, op, op_idx, why):
        """Price gathering `name` out of `parts` to replicated: the
        conservative reshard — full bytes minus what stays local."""
        factor = self._shard_factor(parts)
        if factor <= 1:
            return
        nbytes = self._nbytes(name)
        moved = nbytes - nbytes // factor
        axes = tuple(a for p in parts if p is not None
                     for a in (p if isinstance(p, (tuple, list))
                               else (p,)))
        self._cost("reshard", ",".join(str(a) for a in axes), moved,
                   op_idx, op.type, note=f"{name}: {why}")
        if moved >= self.threshold:
            self._find("PTV061",
                       f"implicit reshard of {name!r} "
                       f"({_fmt_parts(parts)} -> replicated, "
                       f"~{moved} bytes): {why}",
                       op=op, op_idx=op_idx, var=name)

    # -- the walk --------------------------------------------------------
    def run(self, feed_shapes=None, feed_names=()):
        program, layout = self.program, self.layout
        seed = None
        if feed_shapes:
            seed = {str(k): Spec(tuple(int(d) for d in s[0]),
                                 str(s[1]))
                    for k, s in feed_shapes.items()}
        self.specs = dict(program_specs(program, seed)[0])
        if len(layout) == 0:
            layout.add_program(program)

        # seed persistables from the layout table, feeds from feed_spec
        feed_set = {str(n) for n in (feed_names or ())}
        if not feed_set and seed:
            feed_set = set(seed)
        for name, var in self.block.vars.items():
            spec = self._spec(name)
            rank = len(spec.shape) if spec is not None else 0
            if getattr(var, "persistable", False):
                pspec = layout._table.get(name)
                if pspec is None:
                    pspec = layout.spec_for(
                        name, spec.shape if spec else (),
                        is_param=getattr(var, "is_parameter", False))
                parts = tuple(pspec)[:rank] \
                    + (None,) * max(rank - len(tuple(pspec)), 0)
                self.env[name] = parts
            elif var.is_data or name in feed_set:
                shape = spec.shape if spec is not None else ()
                if shape and int(shape[0]) > 0:
                    self.env[name] = tuple(
                        layout.feed_spec(name, shape))[:rank] \
                        + (None,) * max(rank - 1, 0)

        for op_idx, op in enumerate(self.block.ops):
            self._dispatch(op, op_idx)
            self._emit_row(op, op_idx)

        self._price_grad_sync()
        self._fallback_findings()
        return self.report

    def _emit_row(self, op, op_idx):
        outs = {}
        for names in op.outputs.values():
            for n in names:
                if n and any(p is not None
                             for p in self.env.get(n, ())):
                    outs[n] = _fmt_parts(self.env[n])
        costs_here = [c for c in self.report.costs
                      if c.op_idx == op_idx]
        if not outs and not costs_here:
            return
        self.report.rows.append(
            {"op": op.type, "where": f"{op.type}:0/{op_idx}",
             "out": outs,
             "bytes": int(sum(c.bytes for c in costs_here))})

    # -- dispatch --------------------------------------------------------
    def _dispatch(self, op, op_idx):
        t = op.type
        if t in ("feed", "fetch"):
            self._rule_passthrough(op)
        elif t in _ELEMENTWISE:
            self._rule_elementwise(op, op_idx)
        elif t in _MATMUL_OPS:
            self._rule_matmul(op, op_idx)
        elif t in _REDUCE_OPS:
            self._rule_reduce(op, op_idx)
        elif t == "softmax_with_cross_entropy":
            self._rule_softmax_xent(op, op_idx)
        elif t in _PRESERVE_ALL:
            self._rule_preserve(op, op_idx, all_dims=True)
        elif t in _DIM0_PRESERVING:
            self._rule_preserve(op, op_idx, all_dims=False)
        elif t in ("reshape2", "reshape", "squeeze2", "unsqueeze2",
                   "flatten2", "flatten_contiguous_range"):
            self._rule_reshape(op, op_idx)
        elif t in ("transpose2", "transpose"):
            self._rule_transpose(op, op_idx)
        elif t == "slice":
            self._rule_slice(op, op_idx)
        elif t == "concat":
            self._rule_concat(op, op_idx)
        elif t in ("lookup_table_v2", "lookup_table"):
            self._rule_lookup(op, op_idx)
        elif t == "shard_hint":
            self._rule_shard_hint(op, op_idx)
        elif t in _ALLREDUCE_OPS:
            self._rule_collective(op, op_idx, "all_reduce", 2.0)
        elif t == "c_allgather":
            self._rule_collective(op, op_idx, "all_gather", 1.0)
        elif t == "c_reducescatter":
            self._rule_collective(op, op_idx, "reduce_scatter", 1.0)
        elif t in ("c_broadcast", "broadcast"):
            self._rule_collective(op, op_idx, "broadcast", 1.0)
        elif t == "c_alltoall":
            self._rule_collective(op, op_idx, "all_to_all", 1.0)
        elif t == "ring_attention":
            self._rule_seq_attention(op, op_idx, kv_rotations=True)
        elif t == "ulysses_attention":
            self._rule_seq_attention(op, op_idx, kv_rotations=False)
        elif t == "moe_ffn":
            self._rule_moe(op, op_idx)
        elif t == "grad::generic":
            self._rule_grad(op, op_idx)
        elif "Param" in op.inputs and "Grad" in op.inputs:
            # optimizer family (sgd/momentum/adam/adamw/...): the
            # dp/fsdp mismatch between replicated grads and sharded
            # accumulators IS the priced ZeRO reduce-scatter/all-gather
            # decomposition (arxiv 2004.13336) — outputs keep their
            # table layouts, no extra cost, no PTV060.
            self._rule_passthrough(op)
        elif t in OPAQUE_OPS or t in ("while", "conditional_block",
                                      "recompute_segment"):
            self._rule_passthrough(op)
        else:
            self._rule_uncovered(op, op_idx)

    # -- rules -----------------------------------------------------------
    def _rule_passthrough(self, op):
        """Outputs take their already-seeded layouts (persistables keep
        the table spec; everything else stays replicated)."""

    def _set_out(self, name, parts):
        parts = tuple(parts)
        if any(p is not None for p in parts):
            self.env[name] = parts
        else:
            self.env.pop(name, None)

    def _aligned_in_parts(self, op, out_rank, axis_attr=None):
        """[(name, parts aligned to out_rank)] for every input with a
        known layout, numpy trailing broadcast (or the paddle
        elementwise `axis` attr when >= 0)."""
        out = []
        for names in op.inputs.values():
            for n in names:
                if not n:
                    continue
                parts = self.env.get(n)
                if parts is None:
                    continue
                rank = len(parts)
                if rank == out_rank:
                    out.append((n, tuple(parts)))
                elif rank < out_rank:
                    if axis_attr is not None and axis_attr >= 0:
                        lead = axis_attr
                    else:
                        lead = out_rank - rank
                    out.append((n, (None,) * lead + tuple(parts)
                                + (None,) * (out_rank - rank - lead)))
                else:
                    out.append((n, tuple(parts)[rank - out_rank:]))
        return out

    def _merge_parts(self, op, op_idx, aligned, out_rank):
        """Per-dim merge with PTV060 on disagreement."""
        merged = [None] * out_rank
        axis_dim: Dict[str, int] = {}
        for name, parts in aligned:
            for d, p in enumerate(parts):
                if p is None:
                    continue
                for a in (p if isinstance(p, (tuple, list)) else (p,)):
                    a = str(a)
                    if a in axis_dim and axis_dim[a] != d:
                        self._find(
                            "PTV060",
                            f"operands disagree on mesh axis {a!r}: "
                            f"{name!r} shards dim {d} but another "
                            f"operand shards dim {axis_dim[a]}",
                            op=op, op_idx=op_idx, var=name)
                        continue
                    axis_dim[a] = d
                if merged[d] is None:
                    merged[d] = p
                elif merged[d] != p:
                    self._find(
                        "PTV060",
                        f"operands disagree on dim {d}: "
                        f"{_fmt_parts([merged[d]])} vs "
                        f"{_fmt_parts([p])} ({name!r})",
                        op=op, op_idx=op_idx, var=name)
        return merged

    def _rule_elementwise(self, op, op_idx):
        out_names = [n for ns in op.outputs.values() for n in ns if n]
        if not out_names:
            return
        out_rank = max((self._rank_of(n) for n in out_names),
                       default=0)
        axis_attr = op.attrs.get("axis") \
            if isinstance(op.attrs.get("axis"), int) else None
        aligned = self._aligned_in_parts(op, out_rank, axis_attr)
        if not aligned:
            return
        merged = self._merge_parts(op, op_idx, aligned, out_rank)
        for n in out_names:
            r = self._rank_of(n)
            self._set_out(n, tuple(merged)[:r]
                          + (None,) * max(r - len(merged), 0))

    def _rule_preserve(self, op, op_idx, all_dims):
        src = _principal_input(op)
        if src is None:
            return
        src_parts = self.env.get(src)
        if src_parts is None:
            return
        for names in op.outputs.values():
            for n in names:
                if not n:
                    continue
                r = self._rank_of(n)
                if all_dims:
                    parts = tuple(src_parts)[:r] \
                        + (None,) * max(r - len(src_parts), 0)
                else:
                    parts = ((src_parts[0],) if src_parts else ()) \
                        + (None,) * max(r - 1, 0)
                self._set_out(n, parts)

    def _rule_matmul(self, op, op_idx):
        xn = (op.inputs.get("X") or [None])[0]
        yn = (op.inputs.get("Y") or [None])[0]
        on = next((n for ns in op.outputs.values()
                   for n in ns if n), None)
        if not xn or not yn or not on:
            return
        xs, ys = self._spec(xn), self._spec(yn)
        if xs is None or ys is None:
            return
        xr, yr = len(xs.shape), len(ys.shape)
        xp = list(self._parts_of(xn, xr))
        yp = list(self._parts_of(yn, yr))
        if op.type == "mul":
            xnc = int(op.attrs.get("x_num_col_dims", 1))
            ync = int(op.attrs.get("y_num_col_dims", 1))
            x_contract = list(range(xnc, xr))
            y_contract = list(range(0, ync))
            x_free, y_free = list(range(0, xnc)), list(range(ync, yr))
        else:
            tx = bool(op.attrs.get("transpose_X",
                                   op.attrs.get("trans_x", False)))
            ty = bool(op.attrs.get("transpose_Y",
                                   op.attrs.get("trans_y", False)))
            x_contract = [xr - 2 if tx else xr - 1]
            y_contract = [yr - 1 if ty else yr - 2]
            x_free = [d for d in range(xr) if d not in x_contract]
            y_free = [yr - 2 if ty else yr - 1]

        def axes_on(parts, dims):
            s = set()
            for d in dims:
                p = parts[d] if d < len(parts) else None
                if p is None:
                    continue
                for a in (p if isinstance(p, (tuple, list)) else (p,)):
                    s.add(str(a))
            return s

        cx, cy = axes_on(xp, x_contract), axes_on(yp, y_contract)
        out_rank = self._rank_of(on)
        out_parts = [None] * out_rank
        partial_axes = set()
        if cx and cy:
            if cx == cy:
                partial_axes = cx  # row-parallel partial sum
            else:
                self._find(
                    "PTV060",
                    f"contraction dims sharded on different axes: "
                    f"{xn!r} on {sorted(cx)}, {yn!r} on {sorted(cy)}",
                    op=op, op_idx=op_idx, var=on)
        elif cx or cy:
            # one-sided contraction sharding: gather that operand
            # (covers the fsdp weight all-gather — W's dim 0 is the
            # contraction dim)
            name, parts, dims = (xn, xp, x_contract) if cx \
                else (yn, yp, y_contract)
            masked = [parts[d] if d in dims else None
                      for d in range(len(parts))]
            self._reshard(name, masked, op, op_idx,
                          "contraction dim sharded on one side only")

        # free-dim propagation: X's free dims lead, Y's trail
        j = 0
        used_axes = set(partial_axes)
        lead = out_rank - len(y_free) - len(x_free)
        j = max(lead, 0)
        for d in x_free:
            if j >= out_rank:
                break
            p = xp[d] if d < len(xp) else None
            if p is not None:
                axes = {str(a) for a in
                        (p if isinstance(p, (tuple, list)) else (p,))}
                if axes & used_axes:
                    self._find(
                        "PTV060",
                        f"mesh axis {sorted(axes & used_axes)} would "
                        f"shard two output dims of {on!r}",
                        op=op, op_idx=op_idx, var=on)
                    p = None
                else:
                    used_axes |= axes
            out_parts[j] = p
            j += 1
        for k, d in enumerate(y_free):
            jj = out_rank - len(y_free) + k
            if jj < 0 or jj >= out_rank:
                continue
            p = yp[d] if d < len(yp) else None
            if p is not None:
                axes = {str(a) for a in
                        (p if isinstance(p, (tuple, list)) else (p,))}
                if axes & used_axes:
                    self._find(
                        "PTV060",
                        f"mesh axis {sorted(axes & used_axes)} would "
                        f"shard two output dims of {on!r}",
                        op=op, op_idx=op_idx, var=on)
                    p = None
                else:
                    used_axes |= axes
            if out_parts[jj] is None:
                out_parts[jj] = p
        self._set_out(on, out_parts)

        if partial_axes:
            payload = self._nbytes(on) // self._shard_factor(out_parts)
            self._cost("all_reduce",
                       ",".join(sorted(partial_axes)), 2 * payload,
                       op_idx, op.type,
                       note=f"{on}: partial sum over contraction")

    def _rule_reduce(self, op, op_idx):
        src = _principal_input(op)
        on = next((n for ns in op.outputs.values()
                   for n in ns if n), None)
        if src is None or on is None:
            return
        parts = self.env.get(src)
        if parts is None:
            return
        rank = len(parts)
        if op.type == "mean" or op.attrs.get("reduce_all"):
            dims = list(range(rank))
        else:
            dims = [d % rank if rank else 0
                    for d in (op.attrs.get("dim") or [0])]
        keep = bool(op.attrs.get("keep_dim", False))
        reduced_axes = set()
        out_parts = []
        for d in range(rank):
            if d in dims:
                p = parts[d]
                if p is not None:
                    for a in (p if isinstance(p, (tuple, list))
                              else (p,)):
                        reduced_axes.add(str(a))
                if keep:
                    out_parts.append(None)
            else:
                out_parts.append(parts[d])
        r = self._rank_of(on)
        self._set_out(on, tuple(out_parts)[:r]
                      + (None,) * max(r - len(out_parts), 0))
        if reduced_axes:
            payload = self._nbytes(on) // self._shard_factor(out_parts)
            self._cost("all_reduce", ",".join(sorted(reduced_axes)),
                       2 * payload, op_idx, op.type,
                       note=f"{on}: reduced over a sharded dim")

    def _rule_softmax_xent(self, op, op_idx):
        ln = (op.inputs.get("Logits") or [None])[0]
        if not ln:
            return
        parts = list(self._parts_of(ln, self._rank_of(ln)))
        vocab_axes = set()
        if parts and parts[-1] is not None:
            p = parts[-1]
            for a in (p if isinstance(p, (tuple, list)) else (p,)):
                vocab_axes.add(str(a))
        for slot, names in op.outputs.items():
            for n in names:
                if not n:
                    continue
                r = self._rank_of(n)
                if slot == "Softmax":
                    self._set_out(n, tuple(parts)[:r]
                                  + (None,) * max(r - len(parts), 0))
                else:  # Loss: class dim reduced away
                    lp = list(parts[:-1]) if parts else []
                    self._set_out(n, tuple(lp)[:r]
                                  + (None,) * max(r - len(lp), 0))
                    if vocab_axes:
                        # Megatron parallel cross-entropy: max and
                        # sum-exp all-reduce over the class axis
                        payload = self._nbytes(n)
                        self._cost("all_reduce",
                                   ",".join(sorted(vocab_axes)),
                                   2 * 2 * payload, op_idx, op.type,
                                   note=f"{n}: class dim sharded")

    def _rule_reshape(self, op, op_idx):
        src = _principal_input(op)
        on = next((n for n in (op.outputs.get("Out") or []) if n),
                  None)
        if src is None or on is None:
            return
        in_parts = self.env.get(src)
        if in_parts is None:
            return
        ispec, ospec = self._spec(src), self._spec(on)
        if ispec is None or ospec is None:
            return
        out_parts, lost = _remap_reshape(
            ispec.shape, tuple(in_parts), ospec.shape,
            lambda axes: self._axis_size(axes))
        self._set_out(on, out_parts)
        if lost:
            masked = [p if d in lost else None
                      for d, p in enumerate(in_parts)]
            self._reshard(src, masked, op, op_idx,
                          "sharded dim merged/split by reshape")

    def _rule_transpose(self, op, op_idx):
        src = _principal_input(op)
        on = next((n for n in (op.outputs.get("Out") or []) if n),
                  None)
        if src is None or on is None:
            return
        parts = self.env.get(src)
        if parts is None:
            return
        perm = op.attrs.get("axis") or op.attrs.get("perm") or []
        rank = len(parts)
        if len(perm) != rank:
            return
        self._set_out(on, tuple(parts[int(p) % rank] for p in perm))

    def _rule_slice(self, op, op_idx):
        src = _principal_input(op)
        on = next((n for ns in op.outputs.values()
                   for n in ns if n), None)
        if src is None or on is None:
            return
        parts = self.env.get(src)
        if parts is None:
            return
        axes = {int(a) for a in (op.attrs.get("axes") or [])}
        out = []
        sliced_sharded = []
        for d, p in enumerate(parts):
            if d in axes:
                if p is not None:
                    sliced_sharded.append(d)
                out.append(None)
            else:
                out.append(p)
        decrease = {int(a) for a in
                    (op.attrs.get("decrease_axis") or [])}
        out = [p for d, p in enumerate(out) if d not in decrease]
        r = self._rank_of(on)
        self._set_out(on, tuple(out)[:r]
                      + (None,) * max(r - len(out), 0))
        if sliced_sharded:
            masked = [p if d in sliced_sharded else None
                      for d, p in enumerate(parts)]
            self._reshard(src, masked, op, op_idx,
                          "slice along a sharded dim")

    def _rule_concat(self, op, op_idx):
        on = next((n for ns in op.outputs.values()
                   for n in ns if n), None)
        if on is None:
            return
        out_rank = self._rank_of(on)
        cat = int(op.attrs.get("axis", 0)) % max(out_rank, 1)
        aligned = self._aligned_in_parts(op, out_rank)
        if not aligned:
            return
        merged = self._merge_parts(op, op_idx, aligned, out_rank)
        if merged and merged[cat] is not None:
            for name, parts in aligned:
                if parts[cat] is not None:
                    masked = [p if d == cat else None
                              for d, p in enumerate(parts)]
                    self._reshard(name, masked, op, op_idx,
                                  "concat along a sharded dim")
            merged[cat] = None
        self._set_out(on, merged)

    def _rule_lookup(self, op, op_idx):
        ids = (op.inputs.get("Ids") or [None])[0]
        w = (op.inputs.get("W") or [None])[0]
        on = next((n for ns in op.outputs.values()
                   for n in ns if n), None)
        if not ids or not w or not on:
            return
        wp = list(self._parts_of(w, self._rank_of(w)))
        if wp and wp[0] is not None:
            # vocab dim sharded (fsdp): gather the table before lookup
            self._reshard(w, [wp[0]] + [None] * (len(wp) - 1), op,
                          op_idx, "embedding table row-sharded")
            wp[0] = None
        idp = self._parts_of(ids, self._rank_of(ids))
        r = self._rank_of(on)
        emb_part = wp[-1] if len(wp) >= 2 else None
        # ids often carry a trailing [.., 1] dim the lookup squeezes
        lead = list(idp)[:max(r - 1, 0)]
        parts = tuple(lead) + (None,) * max(r - 1 - len(lead), 0) \
            + (emb_part,)
        self._set_out(on, parts[:r])

    def _rule_shard_hint(self, op, op_idx):
        src = _principal_input(op)
        on = next((n for ns in op.outputs.values()
                   for n in ns if n), None)
        if on is None:
            return
        raw = op.attrs.get("spec") or []
        spec = self._spec(on) or (src and self._spec(src))
        shape = spec.shape if spec else ()
        parts = []
        for d, p in enumerate(raw):
            if p is None:
                parts.append(None)
                continue
            axes = tuple(p) if isinstance(p, (tuple, list)) else (p,)
            known = [str(a) for a in axes
                     if str(a) in self.mesh_shape]
            if len(known) != len(axes):
                parts.append(None)
                continue
            size = self._axis_size(known)
            dim = int(shape[d]) if d < len(shape) else -1
            if dim > 0 and size > 1 and dim % size != 0:
                self._find(
                    "PTV062",
                    f"shard_hint wants {on!r} dim {d} ({dim}) over "
                    f"{known} (size {size}) but it does not divide — "
                    f"silently replicated", op=op, op_idx=op_idx,
                    var=on)
                parts.append(None)
            elif size > 1:
                parts.append(known[0] if len(known) == 1
                             else tuple(known))
            else:
                parts.append(None)
        r = self._rank_of(on)
        parts = tuple(parts)[:r] + (None,) * max(r - len(parts), 0)
        if src is not None:
            in_parts = self._parts_of(src, r)
            if any(p is not None for p in in_parts) \
                    and tuple(in_parts) != tuple(parts):
                self._reshard(src, in_parts, op, op_idx,
                              "shard_hint changes the layout")
        self._set_out(on, parts)

    def _rule_collective(self, op, op_idx, kind, mult):
        src = _principal_input(op)
        on = next((n for ns in op.outputs.values()
                   for n in ns if n), None)
        if src is None:
            return
        axis = op.attrs.get("axis_name")
        nbytes = self._nbytes(src)
        self._cost(kind, axis, int(mult * nbytes), op_idx, op.type)
        if on is not None:
            parts = self.env.get(src)
            if parts is not None:
                self._set_out(on, parts)

    def _rule_seq_attention(self, op, op_idx, kv_rotations):
        qn = (op.inputs.get("Q") or [None])[0]
        on = next((n for ns in op.outputs.values()
                   for n in ns if n), None)
        axis = op.attrs.get("seq_axis")
        kv_bytes = sum(self._nbytes((op.inputs.get(s) or [""])[0])
                       for s in ("K", "V"))
        if kv_rotations:
            # ring: K/V blocks traverse the whole seq axis once
            self._cost("ring", axis, kv_bytes, op_idx, op.type,
                       note="K/V rotation around the seq axis")
        else:
            # Ulysses: all-to-all on Q/K/V in and on the output back
            q_bytes = self._nbytes(qn) if qn else 0
            out_bytes = self._nbytes(on) if on else 0
            self._cost("all_to_all", axis,
                       q_bytes + kv_bytes + out_bytes, op_idx,
                       op.type, note="head<->seq resharding")
        if qn and on is not None:
            parts = self.env.get(qn)
            if parts is not None:
                self._set_out(on, parts)

    def _rule_moe(self, op, op_idx):
        xn = (op.inputs.get("X") or [None])[0]
        axis = op.attrs.get("ep_axis")
        if xn:
            x_bytes = self._nbytes(xn)
            # dispatch + combine all-to-alls over the expert axis
            self._cost("all_to_all", axis, 2 * x_bytes, op_idx,
                       op.type, note="expert dispatch + combine")
        for names in op.outputs.values():
            for n in names:
                if n and xn:
                    parts = self.env.get(xn)
                    if parts is not None:
                        r = self._rank_of(n)
                        self._set_out(
                            n, tuple(parts)[:r]
                            + (None,) * max(r - len(parts), 0))

    def _rule_grad(self, op, op_idx):
        """grad::generic (backward.py): the grad of forward var F takes
        F's layout — gradients co-shard with what they differentiate.
        Synchronisation is priced once per parameter at the end (the
        per-param all-reduce / reduce-scatter+all-gather), not here, so
        partial-grad merges never double-count."""
        for slot, names in op.outputs.items():
            if not slot.endswith("@GRAD"):
                continue
            fwd_names = op.inputs.get(slot[:-len("@GRAD")]) or []
            for gname, fname in zip(names, fwd_names):
                if not gname or not fname:
                    continue
                base = gname.split("@RENAME@", 1)[0]
                fwd_parts = self.env.get(fname)
                if fwd_parts is None and base.endswith("@GRAD"):
                    fwd_parts = self.env.get(base[:-len("@GRAD")])
                if fwd_parts is not None:
                    r = self._rank_of(gname) or len(fwd_parts)
                    self._set_out(
                        gname, tuple(fwd_parts)[:r]
                        + (None,) * max(r - len(fwd_parts), 0))

    def _rule_uncovered(self, op, op_idx):
        """Conservative default: outputs replicate; sharded inputs are
        priced as a gather-to-replicated reshard (PTV063 once per op
        type)."""
        if op.type not in self._uncovered_seen:
            self._uncovered_seen.add(op.type)
            self.report.uncovered.append(op.type)
            self._find("PTV063",
                       f"no sharding propagation rule for "
                       f"{op.type!r}: outputs treated as replicated, "
                       f"sharded inputs priced as reshards",
                       op=op, op_idx=op_idx)
        for names in op.inputs.values():
            for n in names:
                if not n:
                    continue
                parts = self.env.get(n)
                if parts is not None \
                        and any(p is not None for p in parts):
                    self._reshard(n, parts, op, op_idx,
                                  f"input of uncovered op "
                                  f"{op.type!r}")
        for names in op.outputs.values():
            for n in names:
                if n:
                    self.env.pop(n, None)

    # -- program-level pricing -------------------------------------------
    def _price_grad_sync(self):
        """Per-parameter gradient synchronisation: 2x payload per step
        (ring all-reduce, or the equivalent reduce-scatter+all-gather
        when the update is sharded) — the same arithmetic as
        SpecLayout.gradient_sync_bytes, attributed to the op producing
        each {param}@GRAD."""
        layout = self.layout
        sync = layout.dp * (layout.fsdp
                            if getattr(layout, "fsdp_axis", None)
                            and layout.fsdp > 1 else 1)
        if sync <= 1:
            return
        last_writer: Dict[str, int] = {}
        for op_idx, op in enumerate(self.block.ops):
            for names in op.outputs.values():
                for n in names:
                    if n:
                        last_writer[n] = op_idx
        axis = layout.data_axis or getattr(layout, "fsdp_axis", None)
        for v in self.program.list_vars():
            if not getattr(v, "is_parameter", False):
                continue
            gname = f"{v.name}@GRAD"
            if gname not in last_writer:
                continue
            shape = tuple(s for s in (getattr(v, "shape", ()) or ())
                          if s and s > 0)
            if not shape:
                continue
            try:
                itemsize = np.dtype(as_np_dtype(v.dtype)).itemsize
            except Exception:
                itemsize = 4
            nbytes = int(np.prod(shape)) * itemsize
            payload = nbytes // layout.shard_count(v.name, shape)
            op_idx = last_writer[gname]
            self._cost("grad_sync", axis, 2 * payload, op_idx,
                       self.block.ops[op_idx].type,
                       note=f"{gname}: per-step gradient sync")

    def _fallback_findings(self):
        for fb in getattr(self.layout, "fallbacks", ()):
            self._find(
                "PTV062",
                f"{fb['name']!r} dim {fb['dim']} ({fb['dim_size']}) "
                f"does not divide mesh axis {fb['axis']!r} "
                f"(size {fb['axis_size']}) — silently replicated",
                var=fb["name"])


def _remap_reshape(in_shape, in_parts, out_shape, axis_size):
    """Dim-correspondence remap for reshape: returns (out_parts,
    lost_in_dims). Sharded dims carry over 1:1 matches and the leading
    dim of a merge/split group (when the axis still divides); anything
    else is lost (-> reshard)."""
    out_parts = [None] * len(out_shape)
    lost = []
    i = j = 0
    ni, nj = len(in_shape), len(out_shape)

    def dyn(d):
        return d is None or int(d) < 0

    while i < ni and j < nj:
        i0, j0 = i, j
        pi = 1 if dyn(in_shape[i]) else int(in_shape[i])
        pj = 1 if dyn(out_shape[j]) else int(out_shape[j])
        any_dyn = dyn(in_shape[i]) or dyn(out_shape[j])
        i += 1
        j += 1
        while pi != pj and not any_dyn:
            if pi < pj:
                if i >= ni:
                    break
                any_dyn = any_dyn or dyn(in_shape[i])
                pi *= 1 if dyn(in_shape[i]) else int(in_shape[i])
                i += 1
            else:
                if j >= nj:
                    break
                any_dyn = any_dyn or dyn(out_shape[j])
                pj *= 1 if dyn(out_shape[j]) else int(out_shape[j])
                j += 1
        group_in = list(range(i0, i))
        group_out = list(range(j0, j))
        if len(group_in) == 1 and len(group_out) == 1:
            out_parts[j0] = in_parts[i0] \
                if i0 < len(in_parts) else None
            continue
        # merge/split group: only the leading in-dim's axis can ride
        # along, and only onto the leading out-dim (row-major order
        # keeps the leading-axis blocks contiguous)
        for d in group_in:
            p = in_parts[d] if d < len(in_parts) else None
            if p is None:
                continue
            size = axis_size(p)
            od = group_out[0]
            out_dim = out_shape[od] if od < len(out_shape) else -1
            if d == group_in[0] and not dyn(out_dim) \
                    and int(out_dim) % max(size, 1) == 0 \
                    and out_parts[od] is None:
                out_parts[od] = p
            else:
                lost.append(d)
    # trailing unmatched in-dims with sharding are lost
    for d in range(i, ni):
        if d < len(in_parts) and in_parts[d] is not None:
            lost.append(d)
    return tuple(out_parts), lost


# ---------------------------------------------------------------------------
# the rank plan: the walk as each rank of a model-parallel mesh runs it
# ---------------------------------------------------------------------------

_UNARY = frozenset({
    "cast", "scale", "gelu", "relu", "tanh", "sigmoid", "dropout", "exp",
    "log", "sqrt", "rsqrt", "square", "abs", "softsign", "leaky_relu",
    "elu", "swish", "silu", "relu6", "clip", "assign", "pow", "erf",
    "softplus", "hard_sigmoid", "hard_swish", "brelu", "logsigmoid",
    "sin", "cos", "floor", "ceil", "round", "reciprocal", "sign",
    "fill_any_like", "fill_zeros_like", "stanh", "thresholded_relu",
    "tanh_shrink", "softshrink", "hard_shrink", "mish"})
_BINARY = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow"})
# ops that read their input's last dim whole
_LAST_WHOLE = frozenset({"softmax_with_cross_entropy", "softmax",
                         "layer_norm", "log_softmax"})
# ops a weight's product passes through on its way to one of those
_PASS = frozenset({"elementwise_add", "cast", "scale", "reshape2",
                   "reshape"})
_SEQ_ATTENTION = frozenset({"ring_attention", "ulysses_attention"})


def _prod(xs):
    return int(math.prod(int(x) for x in xs))


def is_update(op):
    from ..core.registry import REGISTRY
    return (REGISTRY.has(op.type) and REGISTRY.get(op.type).inplace
            and "Param" in op.inputs and "Grad" in op.inputs)


def forward_ops(block):
    """The block's forward ops: everything before the first grad op, the
    loss-gradient seed or the first update."""
    out = []
    for op in block.ops:
        if op.type == "grad::generic" or is_update(op):
            break
        names = [n for n in op.output_names() if n]
        if op.type in ("fill_any_like", "fill_constant") and names and \
                all("@GRAD" in n for n in names):
            break
        out.append(op)
    return out


def _sp(v):
    return None if v is None else [int(v[0]), int(v[1]), int(v[2])]


class _Ops:
    """One op's adapters while it is planned: per input (output) slot and
    index, the list of adapters run on it, in order."""

    def __init__(self):
        self.ins: Dict[str, Dict[int, list]] = {}
        self.outs: Dict[str, Dict[int, list]] = {}
        self.fold = False
        self.flags = {}

    def add_in(self, slot, i, ads):
        if ads:
            self.ins.setdefault(slot, {}).setdefault(i, []).extend(ads)

    def add_out(self, slot, i, ads):
        if ads:
            self.outs.setdefault(slot, {}).setdefault(i, []).extend(ads)

    def attr(self, sizes):
        if not (self.ins or self.outs or self.fold or self.flags):
            return None
        d = {"in": {s: {str(i): a for i, a in m.items()}
                    for s, m in self.ins.items()},
             "out": {s: {str(i): a for i, a in m.items()}
                     for s, m in self.outs.items()}}
        if self.fold:
            d["fold"] = self.fold
        d.update(self.flags)
        d["sizes"] = dict(sizes)
        return d


class _RankAnalyzer(_Analyzer):
    """The analyzer's walk over one model axis as each rank runs it.

    The global walk above prices the layouts GSPMD gives the program (the
    JAX package's partitioner). The port runs one process a rank and
    each runs a rewrite of the program (parallel/model_parallel.py);
    this walk is where that rewrite's layouts and collectives come from:

    - each parameter is held as this rank's shard (`storage`): the
      SpecLayout's split over the model axis, except a weight whose
      product contracts over a split dim, which is held by its rows
      (Megatron's row-parallel layer: `proj.w` and `fc2.w` of a
      transformer). One pass finds every such weight, a second plans
      with them;
    - every forward var gets a layout over the model axis: whole (absent
      from `lay`) or a `Split` (collective.Split: the dim it is cut on,
      with the outer and inner factors a reshape that merges the dim
      keeps). Each op's rule reads its inputs' layouts and records the
      adapters that make them what it computes on (`adapters`, run
      inside the op's autograd record, so the backward needs no
      rewrite) and its outputs' layouts;
    - each adapter is priced where it is placed, forward and backward,
      in the bytes ops/collective.py counts for it, and so are the
      collectives inside ring and Ulysses attention and the MoE FFN and
      the data axes' gradient sync: the report's
      collective_bytes_per_step is what a rank moves a step.

    The layouts follow Megatron-LM's f/g scheme (arxiv 1909.08053), with
    its sequence parallelism (arxiv 2205.05198) where the program carries
    `sp` hints: a whole tensor that enters an op computing on blocks is
    copied through f (its gradient all-reduced), a product over a split
    contraction dim is a partial sum resolved by g (all-reduce) or, in
    sequence-parallel mode, by a reduce-scatter over the sequence, and
    an op that needs a whole tensor all-gathers it. An op without a rule
    gathers every split input and runs whole on every rank (a PTV063
    finding names it), so the rank program computes the global result
    for any program. `fsdp` is a batch axis: a weight split on dim 0
    over it is all-gathered before each use and its gradient
    reduce-scattered."""

    def __init__(self, program, layout, report, mesh, batch_axes=(),
                 fetch_names=(), loss_name=None):
        super().__init__(program, _MeshLayout(layout, mesh), report)
        self.layout = layout
        self.mesh = mesh
        self.batch_axes = tuple(batch_axes)
        self.fetch_names = tuple(fetch_names or ())
        self.loss_name = loss_name
        self.axis = self._model_axis(program, mesh, layout)
        self.n = int(mesh.shape[self.axis]) if self.axis else 1
        fa = getattr(layout, "fsdp_axis", None) if layout is not None \
            else None
        self.fsdp_axis = fa if fa and mesh.shape.get(fa, 1) > 1 else None
        self.fsdp_n = int(mesh.shape[self.fsdp_axis]) \
            if self.fsdp_axis else 1
        self.fsdp_batch = self.fsdp_axis in self.batch_axes
        self.nbatch = _prod([mesh.shape[a] for a in self.batch_axes
                             if a in mesh.shape])
        self.sp_mode = self.axis is not None and any(
            op.type == "shard_hint" and self._hint_dim(op) == 1
            for op in self.block.ops)
        self.sizes = {str(ax): int(s) for ax, s in mesh.shape.items()}

    # -- axes --------------------------------------------------------------
    @staticmethod
    def _model_axis(program, mesh, layout):
        tp = getattr(layout, "model_axis", None) if layout is not None \
            else None
        if tp and mesh.shape.get(tp, 1) > 1:
            return tp
        wide = {a for a, s in mesh.shape.items() if s > 1}
        for op in program.global_block().ops:
            names = []
            if op.type == "shard_hint":
                for a in op.attrs.get("spec", []) or []:
                    names.extend(a if isinstance(a, (list, tuple))
                                 else [a])
            elif op.type == "moe_ffn":
                names.append(op.attrs.get("ep_axis", "ep"))
            elif op.type in _SEQ_ATTENTION:
                names.append(op.attrs.get("seq_axis", "sp"))
            for a in names:
                if a in wide and a != getattr(layout, "fsdp_axis", None) \
                        and a not in (getattr(layout, "data_axis", None),
                                      "dp"):
                    return a
        return None

    def _hint_dim(self, op):
        for d, a in enumerate(op.attrs.get("spec", []) or []):
            names = a if isinstance(a, (list, tuple)) else [a]
            if self.axis in names:
                return d
        return None

    # -- the walk ----------------------------------------------------------
    def run(self, feed_shapes=None, feed_names=()):
        seed = None
        if feed_shapes:
            seed = {str(k): Spec(tuple(int(d) for d in s[0]), str(s[1]))
                    for k, s in feed_shapes.items()}
        self.specs = dict(program_specs(self.program, seed)[0])
        self.params = {v.name: v for v in self.program.list_vars()
                       if getattr(v, "is_parameter", False)}
        self.grads = {n.split("@GRAD")[0]
                      for b in self.program.blocks for n in b.vars
                      if "@GRAD" in n}
        self.rehold: set = set()
        self.walks = 0
        for _ in range(len(self.params) + 1):
            self._want = set()
            self._walk()
            self.walks += 1
            if self._want <= self.rehold:
                break
            self.rehold |= self._want
        else:
            raise RuntimeError(
                f"model-parallel plan did not settle the weights held by "
                f"their rows: {sorted(self._want - self.rehold)}")
        for op_type, op_idx, op in self._gathered:
            self._find("PTV063",
                       f"no rank-program rule for {op_type!r}: its split "
                       f"inputs are all-gathered and it runs whole on "
                       f"every rank of {self.axis!r}", op=op, op_idx=op_idx)
            if op_type not in self.report.uncovered:
                self.report.uncovered.append(op_type)
        if self._gathered:
            STAT_ADD("parallel.mp_gathered_ops", len(self._gathered))
        self._price()
        return self.report

    def _walk(self):
        block = self.block
        in_sub = set()
        for b in self.program.blocks[1:]:
            for op in b.ops:
                in_sub.update(op.input_names())
        self.storage: Dict[str, Optional[tuple]] = {}
        self.fsdp_params: set = set()
        moe_experts = set()
        for op in block.ops:
            if op.type == "moe_ffn" and \
                    op.attrs.get("ep_axis", "ep") == self.axis:
                for slot in ("W1", "B1", "W2", "B2"):
                    moe_experts.update(op.inputs.get(slot, ()))
        for name, v in self.params.items():
            shape = tuple(v.shape or ())
            sp = None
            if name in in_sub:
                pass
            elif name in moe_experts:
                if shape and shape[0] % self.n == 0:
                    sp = Split(0)
            elif self.axis and self.layout is not None and \
                    self.axis == self.layout.model_axis:
                spec = tuple(self.layout.param_spec(name, shape))
                spec += (None,) * (len(shape) - len(spec))
                if shape and spec[-1] == self.axis:
                    sp = Split(0) if name in self.rehold else \
                        Split(len(shape) - 1)
                    if name in self.rehold and shape[0] % self.n:
                        sp = None
                elif shape and spec[0] == self.axis and \
                        shape[0] % self.n == 0:
                    sp = Split(0)
            self.storage[name] = sp
            if self.fsdp_axis and name not in in_sub:
                spec = self.layout.param_spec(name, shape)
                if spec and spec[0] == self.fsdp_axis:
                    self.fsdp_params.add(name)
        self.lay: Dict[str, tuple] = {
            n: s for n, s in self.storage.items() if s is not None}
        self.root: Dict[str, str] = {n: n for n in self.params}
        self.adapters: Dict[int, _Ops] = {}
        self.reshape_local: Dict[int, list] = {}
        self.consumers: Dict[str, list] = {}
        self._gathered = []
        fwd = forward_ops(block)
        for op in fwd:
            for n in op.input_names():
                self.consumers.setdefault(n, []).append(op)
        index = {op.id: i for i, op in enumerate(block.ops)}
        for op in fwd:
            a = _Ops()
            for slot, names in op.inputs.items():
                for i, n in enumerate(names):
                    if n in self.fsdp_params:
                        a.add_in(slot, i, [["fsdp", self.fsdp_axis,
                                            self.fsdp_batch,
                                            1.0 / self.nbatch
                                            if self.fsdp_batch else 1.0]])
            if self.axis is None:
                if op.type in _SEQ_ATTENTION or op.type == "moe_ffn":
                    _RANK_RULES[op.type](self, op, a)
            else:
                rule = _RANK_RULES.get(op.type)
                if rule is None:
                    if op.type in _UNARY:
                        rule = _RankAnalyzer._r_unary
                    elif op.type in _BINARY:
                        rule = _RankAnalyzer._r_binary
                    else:
                        if any(self.L(n) is not None
                               for n in op.input_names()):
                            self._gathered.append(
                                (op.type, index[op.id], op))
                        rule = _RankAnalyzer._r_generic
                rule(self, op, a)
            if a.attr(self.sizes) is not None:
                self.adapters[op.id] = a

    def attrs(self):
        """{op id: the `_mp` attr of the op in the rank program}."""
        return {i: a.attr(self.sizes) for i, a in self.adapters.items()}

    # -- helpers of the rules ----------------------------------------------
    def L(self, name):
        return self.lay.get(name)

    def shape(self, name):
        v = self.block._find_var_recursive(name)
        return tuple(v.shape or ()) if v is not None else ()

    def floating(self, name):
        v = self.block._find_var_recursive(name)
        return v is None or "float" in str(v.dtype) or \
            "bf16" in str(v.dtype)

    def whole(self, name, sharded):
        """Adapters that give an op the whole tensor: gathered if split,
        and copied through f when the op computes on blocks."""
        ads = []
        sp = self.L(name)
        if sp is not None:
            ads.append(["gather", self.axis, _sp(sp)])
        if sharded and self.floating(name):
            ads.append(["f", self.axis])
        return ads

    def to_split(self, name, target):
        """Adapters that give an op `target` (a Split, or None for whole,
        then the op computes on blocks)."""
        cur = self.L(name)
        if target is None:
            return self.whole(name, True)
        if cur == target:
            return []
        ads = []
        if cur is not None:
            ads.append(["gather", self.axis, _sp(cur)])
        ads.append(["scatter", self.axis, _sp(target)])
        return ads

    def split_of(self, shape, k):
        """Split(k) when dim k divides the model axis, else None."""
        if 0 <= k < len(shape) and shape[k] and shape[k] > 0 and \
                shape[k] % self.n == 0:
            return Split(k)
        return None

    def set_out(self, op, slot, sp, i=0):
        names = op.outputs.get(slot, [])
        if i < len(names) and names[i]:
            if sp is None:
                self.lay.pop(names[i], None)
            else:
                self.lay[names[i]] = sp

    def resolve_partial(self, op, a, slot="Out"):
        """The op's output is a partial sum: a reduce-scatter over the
        sequence (dim 1 of a [b, t, d] activation) in sequence-parallel
        mode, else an all-reduce (g)."""
        name = op.outputs[slot][0]
        shape = self.shape(name)
        if self.sp_mode and len(shape) == 3 and \
                self.split_of(shape, 1) is not None:
            a.add_out(slot, 0, [["rs", self.axis, _sp(Split(1))]])
            self.set_out(op, slot, Split(1))
        else:
            a.add_out(slot, 0, [["reduce", self.axis, 1.0]])
            self.set_out(op, slot, None)

    def needs_last_whole(self, name, depth=0):
        """Whether `name` flows, through adds, casts, scales and
        reshapes that keep its last dim, into an op that reads the last
        dim whole (a vocabulary projection feeding the loss)."""
        if depth > 6:
            return False
        last = self.shape(name)[-1:] or (None,)
        for op in self.consumers.get(name, ()):
            if op.type in _LAST_WHOLE:
                return True
            if op.type in _PASS:
                for out in op.output_names():
                    if out and self.shape(out)[-1:] == last and \
                            self.needs_last_whole(out, depth + 1):
                        return True
        return False

    # -- the rules ---------------------------------------------------------
    def _r_generic(self, op, a):
        """Gather every split input; the op runs whole on every rank."""
        for slot, names in op.inputs.items():
            for i, n in enumerate(names):
                a.add_in(slot, i, self.whole(n, False) if self.L(n)
                         else [])
        for slot, names in op.outputs.items():
            for i, _ in enumerate(names):
                self.set_out(op, slot, None, i)

    def _r_unary(self, op, a):
        x = (op.inputs.get("X") or [None])[0]
        if x is None:
            return self._r_generic(op, a)
        sp = self.L(x)
        if x in self.root and op.type in ("cast", "scale", "assign"):
            for n in op.output_names():
                self.root[n] = self.root[x]
        xs = self.shape(x)
        for slot, names in op.outputs.items():
            for i, n in enumerate(names):
                same = n and self.shape(n) == xs
                self.set_out(op, slot, sp if same else None, i)
                if sp is not None and n and not same:
                    # a side output of another shape: not split-aware
                    return self._r_generic(op, a)
        for slot, names in op.inputs.items():
            for i, n in enumerate(names):
                if n != x and self.floating(n) and sp is not None:
                    a.add_in(slot, i, self.to_split(n, None))
        if sp is not None and op.type == "dropout":
            a.fold = self.axis

    def _r_binary(self, op, a):
        x, y = op.inputs["X"][0], op.inputs["Y"][0]
        lx, ly = self.L(x), self.L(y)
        xs, ys = self.shape(x), self.shape(y)
        axis = op.attrs.get("axis", -1)
        if lx is None and ly is None:
            self.set_out(op, "Out", None)
            return
        if lx is not None and ly is not None and lx == ly and xs == ys:
            self.set_out(op, "Out", lx)
            return
        if ly is not None and lx is None and xs == ys:
            a.add_in("X", 0, self.to_split(x, ly))
            self.set_out(op, "Out", ly)
            return
        if lx is not None and (ly is None or ly != lx):
            if xs == ys:
                a.add_in("Y", 0, self.to_split(y, lx))
                self.set_out(op, "Out", lx)
                return
            off = len(xs) - len(ys) if axis in (-1, None) else axis
            j = lx[0] - off
            j = j if 0 <= j < len(ys) else None
            if j is None or ys[j] == 1:
                a.add_in("Y", 0, self.to_split(y, None))
                self.set_out(op, "Out", lx)
                return
            if lx.pure() and ys[j] == xs[lx[0]]:
                a.add_in("Y", 0, self.to_split(y, Split(j)))
                self.set_out(op, "Out", lx)
                return
        self._r_generic(op, a)

    def _r_mul(self, op, a):
        x, y = op.inputs["X"][0], op.inputs["Y"][0]
        xnc = int(op.attrs.get("x_num_col_dims", 1))
        ync = int(op.attrs.get("y_num_col_dims", 1))
        xs, ys = self.shape(x), self.shape(y)
        out = op.outputs["Out"][0]
        outs = self.shape(out)
        lx, ly = self.L(x), self.L(y)
        if len(ys) != 2 or ync != 1:
            return self._r_generic(op, a)
        col, row = Split(1), Split(0)
        # a split contraction dim (X's last) wants the weight's rows split
        if lx is not None and lx[0] >= xnc:
            if lx.pure() and lx[0] == len(xs) - 1 and xnc == len(xs) - 1:
                if ly == row:
                    self.resolve_partial(op, a)
                    return
                root = self.root.get(y)
                if ly == col and root in self.params and \
                        root not in self.rehold and \
                        self.storage.get(root) is not None and \
                        self.shape(root)[0] % self.n == 0:
                    # held by its rows in the next pass
                    self._want.add(root)
                if ly is None and self.split_of(ys, 0) is not None:
                    a.add_in("Y", 0, self.to_split(y, row))
                    self.resolve_partial(op, a)
                    return
            a.add_in("X", 0, [["gather", self.axis, _sp(lx)]])
            lx = None
        if ly is None and lx is None:
            return self.set_out(op, "Out", None)
        if ly is None:                       # X split on a row dim
            a.add_in("Y", 0, self.to_split(y, None))
            self.set_out(op, "Out", Split(lx[0], lx[1], lx[2]))
            return
        if ly == row:                        # a row-held weight
            if lx is not None:
                a.add_in("X", 0, [["gather", self.axis, _sp(lx)]])
            xsplit = self.split_of(xs, len(xs) - 1)
            if xsplit is None or xnc != len(xs) - 1:
                a.add_in("Y", 0, self.whole(y, False))
                return self.set_out(op, "Out", None)
            a.add_in("X", 0, [["scatter", self.axis, _sp(xsplit)]])
            self.resolve_partial(op, a)
            return
        if ly != col:
            a.add_in("Y", 0, self.whole(y, lx is not None))
            self.set_out(op, "Out", lx)
            return
        # a column-split weight
        if self.needs_last_whole(out):
            a.add_in("Y", 0, self.whole(y, lx is not None))
            self.set_out(op, "Out", lx)
            return
        if lx is not None:
            a.add_in("X", 0, [["gather", self.axis, _sp(lx)]])
        if self.floating(x):
            a.add_in("X", 0, [["f", self.axis]])
        self.set_out(op, "Out", Split(len(outs) - 1))

    def _r_reshape(self, op, a):
        x = op.inputs["X"][0]
        out = op.outputs["Out"][0]
        sp = self.L(x)
        if sp is None:
            self.set_out(op, "Out", None)
            if x in self.root:
                self.root[out] = self.root[x]
            return
        new = remap_split(self.shape(x), self.shape(out), sp, self.n)
        if new is None:
            return self._r_generic(op, a)
        self.set_out(op, "Out", new)
        local = list(self.shape(out))
        local[new[0]] //= self.n
        self.reshape_local[op.id] = local

    def _r_transpose(self, op, a):
        x = op.inputs["X"][0]
        sp = self.L(x)
        if sp is None:
            return self.set_out(op, "Out", None)
        perm = list(op.attrs.get("axis") or op.attrs.get("perm") or [])
        self.set_out(op, "Out", Split(perm.index(sp[0]), sp[1], sp[2]))

    def _r_flash(self, op, a):
        q, k, v = (op.inputs[s][0] for s in ("Q", "K", "V"))
        lq, lk, lv = self.L(q), self.L(k), self.L(v)
        if lq is not None and lq == lk == lv and lq.pure() and \
                lq[0] in (0, 1):
            return self.set_out(op, "Out", lq)
        self._r_generic(op, a)

    def _r_layer_norm(self, op, a):
        x = op.inputs["X"][0]
        sp = self.L(x)
        xs = self.shape(x)
        bna = int(op.attrs.get("begin_norm_axis", 1))
        if sp is None or sp[0] >= bna:
            return self._r_generic(op, a)
        for slot in ("Scale", "Bias"):
            for i, n in enumerate(op.inputs.get(slot, [])):
                a.add_in(slot, i, self.to_split(n, None))
        self.set_out(op, "Y", sp)
        stat = Split(0, _prod(xs[:sp[0]]) * sp[1],
                     sp[2] * _prod(xs[sp[0] + 1:bna]))
        self.set_out(op, "Mean", stat)
        self.set_out(op, "Variance", stat)

    def _r_xent(self, op, a):
        lg, lb = op.inputs["Logits"][0], op.inputs["Label"][0]
        sp = self.L(lg)
        xs = self.shape(lg)
        if sp is None or sp[0] == len(xs) - 1:
            return self._r_generic(op, a)
        a.add_in("Label", 0, self.to_split(lb, sp))
        self.set_out(op, "Softmax", sp)
        self.set_out(op, "Loss", sp)

    def _r_softmax(self, op, a):
        x = op.inputs["X"][0]
        sp = self.L(x)
        axis = int(op.attrs.get("axis", -1)) % max(1, len(self.shape(x)))
        if sp is None or sp[0] == axis:
            return self._r_generic(op, a)
        self.set_out(op, "Out", sp)

    def _r_reduce(self, op, a):
        x = op.inputs["X"][0]
        if self.L(x) is None:
            return self.set_out(op, "Out", None)
        if op.type != "mean" and not op.attrs.get("reduce_all", False):
            return self._r_generic(op, a)
        scale = 1.0 / self.n if op.type in ("mean", "reduce_mean") \
            else 1.0
        a.add_out("Out", 0, [["reduce", self.axis, scale]])
        self.set_out(op, "Out", None)

    def _r_lookup(self, op, a):
        w, ids = op.inputs["W"][0], op.inputs["Ids"][0]
        lw, li = self.L(w), self.L(ids)
        outs = self.shape(op.outputs["Out"][0])
        if lw is None and li is None:
            return self.set_out(op, "Out", None)
        if lw == Split(1) and li is None:
            return self.set_out(op, "Out", Split(len(outs) - 1))
        if li is not None and li[0] < len(outs) - 1:
            a.add_in("W", 0, self.whole(w, True))
            return self.set_out(op, "Out", li)
        self._r_generic(op, a)

    def _r_shard_hint(self, op, a):
        x = op.inputs["X"][0]
        d = self._hint_dim(op)
        target = None if d is None else self.split_of(self.shape(x), d)
        if target is None:
            if self.L(x) is not None:
                a.add_in("X", 0, [["gather", self.axis, _sp(self.L(x))]])
            return self.set_out(op, "Out", None)
        a.add_in("X", 0, self.to_split(x, target))
        self.set_out(op, "Out", target)

    def _r_slice(self, op, a):
        x = op.inputs["Input"][0]
        sp = self.L(x)
        if sp is None:
            return self.set_out(op, "Out", None)
        axes = [int(v) % len(self.shape(x))
                for v in op.attrs.get("axes", [])]
        if sp[0] in axes:
            return self._r_generic(op, a)
        self.set_out(op, "Out", sp)

    def _r_concat_sum(self, op, a):
        xs = op.inputs["X"]
        lays = {self.L(n) for n in xs}
        axis = int(op.attrs.get("axis", 0)) if op.type == "concat" \
            else None
        if len(lays) == 1:
            sp = next(iter(lays))
            if sp is None or axis is None or \
                    axis % len(self.shape(xs[0])) != sp[0]:
                return self.set_out(op, "Out", sp)
        self._r_generic(op, a)

    def _r_position(self, op, a):
        x = op.inputs["X"][0]
        sp = self.L(x)
        if sp is None:
            return self.set_out(op, "Out", None)
        if sp[0] == 0 and sp.pure():
            return self.set_out(op, "Out", sp)
        self._r_generic(op, a)

    def _r_seq_attention(self, op, a):
        """Ring or Ulysses attention over its own seq axis: inputs
        already split on the sequence over that axis run as the local
        chunks; whole ones are chunked by the op itself."""
        seq_axis = op.attrs.get("seq_axis", "sp")
        q, k, v = (op.inputs[s][0] for s in ("Q", "K", "V"))
        lays = {self.L(q), self.L(k), self.L(v)}
        if seq_axis == self.axis and lays == {Split(2)}:
            a.flags["chunked"] = True
            return self.set_out(op, "Out", Split(2))
        for s, n in (("Q", q), ("K", k), ("V", v)):
            if self.L(n) is not None:
                a.add_in(s, 0, [["gather", self.axis, _sp(self.L(n))]])
        self.set_out(op, "Out", None)

    def _r_moe(self, op, a):
        """The MoE FFN over its own ep axis: expert weights held as this
        rank's experts (dim 0); the op combines over ep itself."""
        ep = op.attrs.get("ep_axis", "ep")
        x = op.inputs["X"][0]
        if self.L(x) is not None:
            a.add_in("X", 0, [["gather", self.axis, _sp(self.L(x))]])
        if ep == self.axis and all(
                self.storage.get(op.inputs[s][0]) == Split(0)
                for s in ("W1", "B1", "W2", "B2")):
            a.flags["experts_local"] = True
        self.set_out(op, "Out", None)
        self.set_out(op, "Load", None)

    # -- pricing -----------------------------------------------------------
    def _bytes(self, name, split=None, fsdp=False):
        """This rank's bytes of `name` held as `split` over the model
        axis (and as its fsdp rows)."""
        n = self._nbytes(name)
        if split is not None:
            n //= self.n
        if fsdp:
            n //= self.fsdp_n
        return n

    def _charge(self, kind, axis, nbytes, op_idx, op, note):
        if nbytes > 0:
            self._cost(kind, axis, nbytes, op_idx, op.type, note)

    def _price_adapters(self, op, op_idx, a):
        for side, table in (("in", a.ins), ("out", a.outs)):
            slots = op.inputs if side == "in" else op.outputs
            for slot, per in table.items():
                names = slots.get(slot, [])
                for i, ads in per.items():
                    name = names[i] if i < len(names) else ""
                    if not name:
                        continue
                    # the tensor the first adapter receives: an input as
                    # the rank holds it, an output as the op computed it
                    size = self._bytes(
                        name, self.L(name) if side == "in" else None,
                        side == "in" and name in self.fsdp_params)
                    grad = name in self.grads and self.floating(name)
                    for ad in ads:
                        size = self._price_one(ad, size, grad, op, op_idx,
                                               name)

    def _price_one(self, ad, size, grad, op, op_idx, name):
        """Charge one adapter on a tensor of `size` bytes; returns the
        size of what it hands on. Forward and backward, as
        ops/collective.py counts them: an all-gather its input piece, an
        all-reduce and a reduce-scatter their whole input."""
        kind, axis = ad[0], ad[1]
        n = int(self.mesh.shape[axis])
        if kind == "gather":
            self._charge("all_gather", axis, size, op_idx, op,
                         f"{name}: gathered")
            return size * n
        if kind == "f":
            if grad:
                self._charge("all_reduce", axis, size, op_idx, op,
                             f"{name}: f's backward")
            return size
        if kind == "reduce":
            self._charge("all_reduce", axis, size, op_idx, op,
                         f"{name}: partial sums (g)")
            return size
        if kind == "scatter":
            if grad:
                self._charge("all_gather", axis, size // n, op_idx, op,
                             f"{name}: scatter's backward")
            return size // n
        if kind == "rs":
            self._charge("reduce_scatter", axis, size, op_idx, op,
                         f"{name}: partial sums over the sequence")
            if grad:
                self._charge("all_gather", axis, size // n, op_idx, op,
                             f"{name}: reduce-scatter's backward")
            return size // n
        if kind == "fsdp":
            self._charge("all_gather", axis, size, op_idx, op,
                         f"{name}: fsdp rows gathered")
            if ad[2]:
                self._charge("reduce_scatter", axis, size * n, op_idx, op,
                             f"{name}: fsdp gradient")
            return size * n
        raise ValueError(f"unknown model-parallel adapter {ad!r}")

    def _op_group_size(self, axis):
        return int(self.mesh.shape.get(axis, 1)) if axis else 1

    def _price_seq_attention(self, op, op_idx, a):
        """Ring and Ulysses attention's own collectives. On whole inputs
        the op scatters them (its backward gathers dq, dk and dv) and
        gathers its output; the ring rotates K/V chunks n - 1 times and,
        in the backward, K/V with the float32 dK/dV n - 1 times and dK/dV
        once more; Ulysses on chunks trades sequence for heads with an
        all-to-all each of q, k, v and the output (their gradients
        alike); on whole inputs it runs on its own heads."""
        axis = op.attrs.get("seq_axis", "sp")
        n = self._op_group_size(axis)
        if n <= 1:
            return
        q, k, v = (op.inputs[s][0] for s in ("Q", "K", "V"))
        out = op.outputs["Out"][0]
        chunked = a is not None and bool(a.flags.get("chunked"))
        grad = any(x in self.grads for x in (q, k, v))
        cq, ck, cv, co = (self._bytes(x) // n for x in (q, k, v, out))
        if not chunked:
            self._charge("all_gather", axis, co, op_idx, op,
                         f"{out}: the rank's part gathered")
            if grad:
                self._charge("all_gather", axis, cq + ck + cv, op_idx, op,
                             "dq, dk and dv gathered")
        if op.type == "ring_attention":
            self._charge("p2p", axis, (n - 1) * (ck + cv), op_idx, op,
                         "K/V chunks around the ring")
            if grad:
                f32 = 4 * (ck // max(self._itemsize(k), 1))
                self._charge("p2p", axis,
                             (n - 1) * (ck + cv) + n * 2 * f32, op_idx, op,
                             "K/V and the float32 dK/dV around the ring")
        elif chunked:
            self._charge("all_to_all", axis, cq + ck + cv + co, op_idx,
                         op, "sequence traded for heads and back")
            if grad:
                self._charge("all_to_all", axis, cq + ck + cv + co,
                             op_idx, op, "the gradients' all-to-alls")

    def _itemsize(self, name):
        spec = self._spec(name)
        return 4 if spec is None else \
            as_torch_dtype(spec.dtype).itemsize

    def _price_moe(self, op, op_idx, a):
        """The MoE FFN's own collectives (parallel/moe.py): f on x and
        the gate (all-reduced gradients), then the dense sum over ep (g)
        or the capacity dispatch's two all-to-alls (the combine's again
        in the backward, the dispatch's where x has a gradient) and the
        gather of each rank's rows; expert weights the rank does not hold
        as its own are cut from the whole ones (their gradients
        gathered)."""
        axis = op.attrs.get("ep_axis", "ep")
        n = self._op_group_size(axis)
        if n <= 1:
            return
        x, gate = op.inputs["X"][0], op.inputs["GateW"][0]
        sx = self._bytes(x)
        if x in self.grads:
            self._charge("all_reduce", axis, sx, op_idx, op,
                         f"{x}: f's backward")
        if gate in self.grads:
            self._charge("all_reduce", axis, self._bytes(gate), op_idx,
                         op, f"{gate}: f's backward")
        if not (a is not None and a.flags.get("experts_local")):
            for s in ("W1", "B1", "W2", "B2"):
                w = op.inputs[s][0]
                if w in self.grads:
                    self._charge("all_gather", axis, self._bytes(w) // n,
                                 op_idx, op, f"{w}: its experts' gradient")
        cap = op.attrs.get("capacity")
        if not cap:
            self._charge("all_reduce", axis, sx, op_idx, op,
                         "expert outputs summed over ep (g)")
        else:
            shape = self._spec(x).shape
            e = int(self._spec(gate).shape[-1])
            slots = e * int(cap) * int(shape[-1]) * self._itemsize(x)
            self._charge("all_to_all", axis, 2 * slots, op_idx, op,
                         "dispatch and combine")
            self._charge("all_to_all", axis,
                         slots * (2 if x in self.grads else 1), op_idx, op,
                         "the backward's all-to-alls")
            self._charge("all_gather", axis, sx // n, op_idx, op,
                         "each rank's rows gathered")
        bax = op.attrs.get("batch_axis", "dp")
        if self._op_group_size(bax) > 1:
            self._charge("all_reduce", bax, self._itemsize(x), op_idx, op,
                         "the load averaged over the batch")

    def _price(self):
        self.env = {}
        for name, sp in self.lay.items():
            r = len(self.shape(name))
            if sp[0] < r:
                self.env[name] = tuple(self.axis if d == sp[0] else None
                                       for d in range(r))
        for op_idx, op in enumerate(self.block.ops):
            a = self.adapters.get(op.id)
            if a is not None:
                self._price_adapters(op, op_idx, a)
            if op.type in _SEQ_ATTENTION:
                self._price_seq_attention(op, op_idx, a)
            elif op.type == "moe_ffn":
                self._price_moe(op, op_idx, a)
            self._emit_row(op, op_idx)
        self._price_batch_sync()
        self._price_fetches()

    def _price_fetches(self):
        """A fetch held split is gathered whole (its fsdp rows, then its
        model-axis blocks), and the loss averaged over the data axes."""
        end = len(self.block.ops)
        for name in self.fetch_names:
            base = name.split("@GRAD")[0]
            sp = self.lay.get(base) or self.storage.get(base)
            size = self._bytes(name)
            if base in self.fsdp_params:
                size //= self.fsdp_n
                self._cost("all_gather", self.fsdp_axis, size, end,
                           "fetch", f"{name}: fetched whole")
                size *= self.fsdp_n
            if sp is not None and self.axis is not None:
                self._cost("all_gather", self.axis, size // self.n, end,
                           "fetch", f"{name}: fetched whole")
            spec = self._spec(name)
            if self.nbatch > 1 and name == self.loss_name and spec and \
                    _prod(spec.shape) == 1:
                self._cost("all_reduce", ",".join(self.batch_axes), size,
                           end, "fetch", f"{name}: averaged over the batch")

    def _price_batch_sync(self):
        """The data axes' gradient sync (parallel/data_parallel.py): each
        gradient the rewrite has not reduced all-reduced (or, where ZeRO
        holds the accumulators, reduce-scattered) whole, and ZeRO's
        parameters all-gathered from their rows."""
        if self.nbatch <= 1:
            return
        axis = ",".join(a for a in self.batch_axes
                        if self.mesh.shape.get(a, 1) > 1)
        synced = {p for p in self.fsdp_params} if self.fsdp_batch \
            else set()
        layout = self.layout
        dp = int(getattr(layout, "dp", 1) or 1) if layout is not None \
            else 1
        for op_idx, op in enumerate(self.block.ops):
            if not is_update(op):
                continue
            p = op.inputs["Param"][0]
            if p not in self.params or p in synced or \
                    p not in self.grads:
                continue
            own = self._bytes(p, self.storage.get(p),
                              p in self.fsdp_params)
            self._charge("grad_sync", axis, own, op_idx, op,
                         f"{p}@GRAD: per-step gradient sync")
            if dp > 1 and hasattr(layout, "_is_zero_accumulator") and \
                    not (getattr(layout, "fsdp_axis", None)
                         and layout.fsdp > 1):
                accs = [nm for slot, names in op.inputs.items()
                        if slot not in ("Param", "Grad") for nm in names
                        if nm and layout._is_zero_accumulator(nm)]
                shape = self.shape(p)
                if accs and shape and shape[0] % dp == 0 and \
                        op.type not in ("lamb", "lars_momentum"):
                    self._charge("all_gather", axis, own // dp, op_idx,
                                 op, f"{p}: ZeRO rows gathered")


_RANK_RULES = {
    "mul": _RankAnalyzer._r_mul,
    "reshape2": _RankAnalyzer._r_reshape,
    "reshape": _RankAnalyzer._r_reshape,
    "transpose2": _RankAnalyzer._r_transpose,
    "transpose": _RankAnalyzer._r_transpose,
    "flash_attention": _RankAnalyzer._r_flash,
    "layer_norm": _RankAnalyzer._r_layer_norm,
    "softmax_with_cross_entropy": _RankAnalyzer._r_xent,
    "softmax": _RankAnalyzer._r_softmax,
    "mean": _RankAnalyzer._r_reduce,
    "reduce_sum": _RankAnalyzer._r_reduce,
    "reduce_mean": _RankAnalyzer._r_reduce,
    "lookup_table_v2": _RankAnalyzer._r_lookup,
    "shard_hint": _RankAnalyzer._r_shard_hint,
    "slice": _RankAnalyzer._r_slice,
    "concat": _RankAnalyzer._r_concat_sum,
    "sum": _RankAnalyzer._r_concat_sum,
    "add_position_encoding": _RankAnalyzer._r_position,
    "ring_attention": _RankAnalyzer._r_seq_attention,
    "ulysses_attention": _RankAnalyzer._r_seq_attention,
    "moe_ffn": _RankAnalyzer._r_moe,
}


def remap_split(in_shape, out_shape, sp, n):
    """The Split of a reshape's output from its input's, or None where
    the split does not stay one block a rank (the rank walk's
    counterpart of _remap_reshape, which keeps only a group's leading
    dim: a Split keeps a merged dim's outer and inner factors)."""
    if any(d is None or d <= 0 for d in in_shape) or \
            any(d is None or d <= 0 for d in out_shape):
        return None
    k, o, i = sp
    s = in_shape[k] // (o * i)
    a = _prod(in_shape[:k]) * o            # elements' index before S
    if s % n:
        return None
    for j in range(len(out_shape)):
        before = _prod(out_shape[:j])
        if a % before:
            return None
        upto = before * out_shape[j]
        if upto % (a * s) == 0:
            # dim j holds all of S (and maybe its neighbours)
            outer = a // before
            inner = upto // (a * s)
            if outer * s * inner != out_shape[j]:
                return None
            return Split(j, outer, inner)
        if before == a and s % out_shape[j] == 0 and \
                out_shape[j] % n == 0:
            # dim j is S's leading factor (heads of [.., h * hd]): a
            # rank's run of S is a run of dim j
            return Split(j)
    return None


def plan_rank_sharding(program, mesh, layout, batch_axes=(),
                       feed_shapes: Optional[Dict] = None, fetch_names=(),
                       loss_name=None):
    """The rank walk of `program` on `mesh` (a Mesh of ranks) under
    `layout` -> a ShardingReport whose `rank` holds the walk's layouts,
    held splits and adapters (parallel/model_parallel.py builds the rank
    program from them) and whose costs are the collectives a rank runs
    a step, its fetches' included. `program` is the rank's batch
    (parallel/data_parallel.py's local_program where the batch is
    split)."""
    report = ShardingReport(program, _MeshLayout(layout, mesh))
    walk = _RankAnalyzer(program, layout, report, mesh, batch_axes,
                         fetch_names, loss_name)
    walk.run(feed_shapes=feed_shapes)
    report.rank = walk
    return report


class _MeshLayout:
    """The report's view of a rank walk's mesh (a layout may be None)."""

    def __init__(self, layout, mesh):
        self.mesh = mesh
        self.fallbacks = list(getattr(layout, "fallbacks", ()) or ())


def analyze_program_sharding(
        program, layout, feed_names: Iterable[str] = (),
        fetch_names: Iterable[str] = (),
        feed_shapes: Optional[Dict] = None,
        reshard_threshold: int = RESHARD_FINDING_MIN_BYTES
        ) -> ShardingReport:
    """Propagate `layout` through `program`'s global block -> a
    ShardingReport (per-op layouts, priced collectives, PTV060-063
    findings). `layout` is a parallel/layout.SpecLayout over a Mesh of
    ranks or a rank-free MeshDims — no process group is needed."""
    report = ShardingReport(program, layout)
    _Analyzer(program, layout, report,
              reshard_threshold=reshard_threshold).run(
        feed_shapes=feed_shapes, feed_names=feed_names)
    return report


# ---------------------------------------------------------------------------
# the gate (Executor.run / ServingEngine.warmup)
# ---------------------------------------------------------------------------

_MEMO_LOCK = threading.Lock()
_GATE_MEMO: "OrderedDict[tuple, ShardingReport]" = OrderedDict()
_MEMO_CAP = 64


def reset_memo():
    """Drop gate memoization (tests; after flag flips)."""
    with _MEMO_LOCK:
        _GATE_MEMO.clear()


def _mesh_dims_from_flags():
    from ..core.flags import FLAGS
    spec = str(FLAGS.sharded_mesh or "").strip()
    if not spec:
        return None
    dims = tuple(int(d) for d in spec.replace("x", ",").split(",")
                 if d.strip())
    if not dims or any(d < 1 for d in dims):
        return None
    return dims


def sharding_gate(program, layout=None, feed_shapes: Optional[Dict] = None,
                  fetch_names=None, where="executor", rank=None
                  ) -> Optional[ShardingReport]:
    """The FLAGS_sharding_verify gate: off | warn (default) | error.

    Engages only when a layout is in scope: an explicit SpecLayout (the
    sharded-exec path passes the CompiledProgram's state_spec_fn), or a
    device-free one built from FLAGS_sharded_mesh. A model-parallel run
    passes `rank` = (mesh, batch axes, loss name) with its rank's
    program and feed shapes, and the gate prices the rank walk (`plan_rank_sharding`):
    the collectives the rank program runs. Analyzes once per
    (fingerprint, mesh, feed shapes, fetches) and memoizes; in 'error'
    mode PTV060 layout-inconsistent findings raise
    ProgramVerificationError — callers place this BEFORE the
    executor's cache key, so a layout-broken program is rejected with
    cache_stats() showing no miss. Everything else
    (PTV061/062/063, and all findings in 'warn' mode) surfaces as one
    summarized warning per fresh analysis.
    """
    from ..core.flags import FLAGS
    mode = FLAGS.sharding_verify
    if mode == "off":
        return None
    if mode not in ("warn", "error"):
        raise ValueError(
            f"FLAGS_sharding_verify={mode!r}: expected 'off', 'warn' "
            f"or 'error'")

    from ..parallel.layout import MeshDims, SpecLayout
    if not isinstance(layout, SpecLayout):
        layout = None
    if rank is not None:
        mesh, batch_axes, loss_name = rank
        mesh_sig = ("rank", tuple((str(a), int(mesh.shape[a]))
                                  for a in mesh.axis_names),
                    tuple(batch_axes), id(layout), loss_name)
    elif layout is not None:
        mesh_sig = tuple((str(a), int(layout.mesh.shape[a]))
                         for a in layout.mesh.axis_names)
    else:
        dims = _mesh_dims_from_flags()
        if dims is None:
            return None
        mesh_sig = ("flags", dims)

    shapes_sig = tuple(sorted(
        (str(n), tuple(int(d) for d in s[0]), str(s[1]))
        for n, s in (feed_shapes or {}).items()))
    key = (program.fingerprint(), mesh_sig, shapes_sig,
           tuple(str(n) for n in (fetch_names or ())))
    with _MEMO_LOCK:
        report = _GATE_MEMO.get(key)
        if report is not None:
            _GATE_MEMO.move_to_end(key)
    fresh = report is None
    if fresh:
        shapes = dict((n, (shp, dt)) for n, shp, dt in shapes_sig)
        if rank is not None:
            report = plan_rank_sharding(program, mesh, layout, batch_axes,
                                        feed_shapes=shapes,
                                        fetch_names=key[3],
                                        loss_name=loss_name)
        else:
            if layout is None:
                layout = SpecLayout(MeshDims(mesh_sig[1]))
            report = analyze_program_sharding(
                program, layout,
                feed_names=[n for n, _, _ in shapes_sig],
                fetch_names=key[3], feed_shapes=shapes)
        with _MEMO_LOCK:
            _GATE_MEMO[key] = report
            while len(_GATE_MEMO) > _MEMO_CAP:
                _GATE_MEMO.popitem(last=False)
        STAT_ADD("analysis.shard_reports")
        STAT_SET("analysis.shard_collective_bytes",
                 report.collective_bytes_per_step)
        STAT_SET("analysis.shard_reshard_bytes",
                 report.reshard_bytes_per_step)

    res = report.result
    if mode == "error":
        if res.errors():
            STAT_ADD("analysis.shard_gate_rejects")
            res.raise_if_errors()
        if fresh and res.findings:
            _warn_once(where, res)
    elif fresh and res.findings:
        _warn_once(where, res)
    return report


def _warn_once(where, res):
    import warnings
    warnings.warn(f"[{where}] sharding analysis: {res.summary()} "
                  f"(FLAGS_sharding_verify)")
