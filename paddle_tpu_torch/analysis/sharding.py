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
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..core.dtypes import as_np_dtype
from ..monitor import STAT_ADD, STAT_SET
from .diagnostics import VerifyResult
from .shape_infer import OPAQUE_OPS, Spec, declared_spec, program_specs

__all__ = ["ShardingReport", "analyze_program_sharding", "sharding_gate",
           "reset_memo", "RESHARD_FINDING_MIN_BYTES"]

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
                  fetch_names=None, where="executor"
                  ) -> Optional[ShardingReport]:
    """The FLAGS_sharding_verify gate: off | warn (default) | error.

    Engages only when a layout is in scope: an explicit SpecLayout (the
    sharded-exec path passes the CompiledProgram's state_spec_fn), or a
    device-free one built from FLAGS_sharded_mesh. Analyzes once per
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
    if layout is not None:
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
        if layout is None:
            layout = SpecLayout(MeshDims(mesh_sig[1]))
        report = analyze_program_sharding(
            program, layout,
            feed_names=[n for n, _, _ in shapes_sig],
            fetch_names=key[3],
            feed_shapes=dict((n, (shp, dt))
                             for n, shp, dt in shapes_sig))
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
