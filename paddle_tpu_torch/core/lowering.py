"""Block lowering: run a Program block op by op on tensors.

PyTorch runs eagerly, so lowering a block IS running it: each op's
registered lowering is called in program order against an environment of
named tensors. Also here: build-time shape inference, which runs the
same lowerings on ``device="meta"`` tensors (shapes and dtypes only, no
data and no kernels), and the ``grad::generic`` op.

Gradients without recomputation. The JAX package's grad op re-runs the
forward lowering under ``jax.vjp`` and leaves it to XLA to merge the two
forwards; eager PyTorch would run every forward twice. Here a forward op
that a grad op names (``fwd_id``) runs under ``torch.enable_grad()`` on
its differentiable inputs detached into leaves, and its (leaves, outputs)
are recorded in the run's context. Its grad op runs
``torch.autograd.grad`` over that record and drops it, so the forward's
saved tensors are freed as the backward walks. Two rewrites of the graph
passes (analysis/passes) keep the records reachable: a sub-op of a
``fused_elementwise`` op records under its own id (ops/fused.py), and
where CSE merged two forward ops (``program._record_alias``), the
survivor's record serves the grad ops of both: it is read with its graph
retained until its last reader.

Op scopes: while a torch profiler records (and FLAGS_op_trace_scopes is
on), each op runs under ``record_function("{op.type}:{block}/{idx}")``,
so the profiler links every kernel to its Program op; an op of a fusion
group (level 2, analysis/passes/fusion.py) takes its group's label in
front, ``"ewfuse0/fused_elementwise:0/12"``, as in the JAX package,
which stamps the same scope into compiled metadata at no run-time cost; here
a scope would cost every eager step a host call an op, so none is
entered without a profiler.
"""
from __future__ import annotations

from typing import Dict

import torch

from .dtypes import as_torch_dtype, convert_dtype
from .registry import REGISTRY, OpDef

GRAD_SUFFIX = "@GRAD"

# Dtype names that build-time shape inference records for an op's
# output: the JAX package infers with 64-bit types off, so an inferred
# int64 or float64 output is recorded as its 32-bit type. Only the IR's
# name changes (programs stay byte-identical across the packages); the
# tensors at run time keep torch's dtypes.
_IR_DTYPE = {"int64": "int32", "float64": "float32"}


def ir_dtype(dtype) -> str:
    """The IR's name for a dtype (str, numpy or torch): `_IR_DTYPE`'s
    32-bit name for a 64-bit type, else its own."""
    name = convert_dtype(dtype)
    return _IR_DTYPE.get(name, name)

# Placeholder for the dynamic (batch) dimension during build-time shape
# inference; outputs containing this dim are mapped back to -1. A large
# prime so it cannot collide with a real static layer width.
_DYN_DIM = 100003

_MASK64 = (1 << 64) - 1


def _mix(*words) -> int:
    """splitmix64 over the words: a well-spread 63-bit seed per
    (program seed, step, op id)."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & _MASK64)) & _MASK64
        h = (h + 0x9E3779B97F4A7C15) & _MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h & ((1 << 63) - 1)


class LowerCtx:
    """Per-run context: the device, random seeds, train/infer mode, the
    autograd records of the forward ops named in `record_ids`, and per op
    id the outputs that nothing reads (`unread`: an op may skip them).
    `record_alias` maps a forward op id that CSE merged away to its
    survivor's; `record_readers` counts, per recorded id, the grad ops
    that read it (1 when absent)."""

    def __init__(self, device, seed=0, step=0, is_test=False,
                 record_ids=frozenset(), unread=None, record_alias=None,
                 record_readers=None):
        self.device = torch.device(device)
        self.seed = int(seed)
        self.step = int(step)
        self.is_test = is_test
        self.record_ids = record_ids
        self.unread = unread or {}
        self.record_alias = record_alias or {}
        self.readers_left = dict(record_readers or {})
        # forward op id -> (its inputs with leaves, its outputs)
        self.records = {}
        # the data-parallel run's group: batch_norm all-reduces its
        # moments over it (the global batch's statistics)
        self.sync_group = None

    def generator_for(self, op_id: int, extra=None):
        """A fresh generator for one op: seeded from the program seed
        with the step and the op's stable id folded in, so every op draws
        its own reproducible stream (and `extra`, a rank, where given).
        None on the meta device (shape inference draws nothing)."""
        if self.device.type == "meta":
            return None
        g = torch.Generator(device=self.device)
        words = (self.seed, self.step, op_id) if extra is None else \
            (self.seed, self.step, op_id, int(extra) + 1)
        g.manual_seed(_mix(*words))
        return g


def _gather_slot(env, names):
    vals = []
    for n in names:
        if n == "":
            continue
        if n not in env:
            raise KeyError(f"var {n!r} not materialised before use")
        vals.append(env[n])
    return vals


def _nan_inf_check(op, name, val, op_idx):
    """FLAGS_check_nan_inf: raise naming the op and the output."""
    if bool(torch.isfinite(val).all()):
        return
    block_idx = op.block.idx if getattr(op, "block", None) is not None \
        else 0
    in_names = [n for ns in op.inputs.values() for n in ns if n]
    where = f"block {block_idx}/op {'?' if op_idx is None else op_idx}"
    raise FloatingPointError(
        f"Operator {op.type!r} at {where} output {name!r} contains "
        f"Inf/Nan; op inputs {in_names} (FLAGS_check_nan_inf)")


def run_op(op, env, ctx, op_idx=None):
    """Execute one op's lowering against env (name -> tensor)."""
    from .flags import FLAGS
    blk = op.block.idx if getattr(op, "block", None) is not None else 0
    opdef = REGISTRY.get(
        op.type, where=f"{blk}/{'?' if op_idx is None else op_idx}")
    ins = {}
    for slot, names in op.inputs.items():
        vals = _gather_slot(env, names)
        if vals:
            ins[slot] = vals
    opctx = _OpCtx(ctx, op)
    # the live env: a skipped conditional block keeps its outputs' values
    opctx.env = env
    if torch.autograd._profiler_enabled() and FLAGS.op_trace_scopes:
        # FLAGS_op_trace_scopes: the profiler links each kernel to the op
        # that launched it (profiler.summarize_profile's by_framework_op);
        # without a profiler no scope is entered
        group = getattr(op, "_fusion_group", None)
        with torch.profiler.record_function(
                f"{group + '/' if group else ''}{op.type}:{blk}/"
                f"{'?' if op_idx is None else op_idx}"):
            outs = _lower(op, opdef, opctx, ins, ctx)
    else:
        outs = _lower(op, opdef, opctx, ins, ctx)
    check = FLAGS.check_nan_inf and ctx.device.type != "meta"
    for slot, names in op.outputs.items():
        if slot not in outs:
            continue
        for name, val in zip(names, outs[slot]):
            if name:
                env[name] = val
                if check and val.is_floating_point():
                    _nan_inf_check(op, name, val, op_idx)


def _lower(op, opdef, opctx, ins, ctx):
    """The op's lowering on `ins`; a forward op named in the run's
    record_ids runs on leaves under autograd and leaves its record."""
    try:
        if op.id in ctx.record_ids:
            ins = _with_leaves(opdef, ins)
            with torch.enable_grad():
                outs = _adapted(opdef, opctx, ins, op.attrs)
            ctx.records[op.id] = (ins, outs)
            return outs
        return _adapted(opdef, opctx, ins, op.attrs)
    except Exception as e:
        # name the program op, its input shapes and attrs on failure
        shapes = {s: [tuple(getattr(v, "shape", ())) for v in vs]
                  for s, vs in ins.items()}
        e.add_note(f"[operator {op.type!r}] inputs {shapes} -> outputs "
                   f"{dict(op.outputs)}, attrs {op.attrs}")
        raise


def _adapted(opdef, opctx, ins, attrs):
    """The lowering, with a model-parallel rank program's adapters
    (parallel/model_parallel.py) on its inputs and outputs: they run
    inside the op's autograd record, so its grad op differentiates
    through them."""
    spec = attrs.get("_mp")
    if not spec:
        return opdef.lower(opctx, ins, attrs)
    from ..parallel.model_parallel import apply_adapters
    outs = opdef.lower(opctx, apply_adapters(spec, "in", ins), attrs)
    return apply_adapters(spec, "out", outs)


class _OpCtx:
    """View of LowerCtx bound to one op."""

    def __init__(self, ctx: LowerCtx, op):
        self._ctx = ctx
        self._op = op
        self.device = ctx.device
        self.is_test = ctx.is_test or bool(op.attrs.get("is_test", False))
        self.sync_group = getattr(ctx, "sync_group", None)
        self.block = getattr(op, "block", None)
        self.attrs = op.attrs
        self.inputs = getattr(op, "inputs", {})
        self.outputs = getattr(op, "outputs", {})
        # a model-parallel rank program's flags for this op
        self.mp = op.attrs.get("_mp") or {}

    def sub_block(self, idx):
        """Block `idx` of the op's program (a control-flow body)."""
        return self._op.block.program.blocks[idx]

    def lower_sub_block(self, block, env):
        """Run a sub-block's ops on `env` in this run's context. Op ids
        are unique across a program's blocks, so no sub-block op matches
        the run's record ids or its drop list (both the global block's)."""
        for i, op in enumerate(block.ops):
            run_op(op, env, self._ctx, op_idx=i)
        return env

    def wants(self, slot):
        """Whether a later op reads, or a fetch names, a var of the output
        slot. An op may leave an unwanted optional output out."""
        dead = self._ctx.unread.get(self._op.id, ())
        return any(n and n not in dead for n in self.outputs.get(slot, ()))

    def persistable(self, name):
        """Whether the op's block declares `name` a persistable var."""
        v = self.block._find_var_recursive(name) \
            if self.block is not None else None
        return v is not None and v.persistable

    def pop_record(self, fwd_id):
        """(the forward op's (inputs, outputs) record or None if it left
        none, whether this is its last reader). The last reader removes
        it from the run's context."""
        ctx = self._ctx
        fwd_id = ctx.record_alias.get(fwd_id, fwd_id)
        left = ctx.readers_left.get(fwd_id, 1) - 1
        if left > 0:
            ctx.readers_left[fwd_id] = left
            return ctx.records.get(fwd_id), False
        return ctx.records.pop(fwd_id, None), True

    @property
    def generator(self):
        """The op's generator; an op on a split activation of a
        model-parallel run folds its rank on that axis into the seed."""
        fold = self.mp.get("fold")
        extra = None
        if fold and self.device.type != "meta":
            from ..parallel.mesh import get_mesh
            extra = get_mesh().axis_index(fold)
        return self._ctx.generator_for(
            self._op.attrs.get("fwd_id", self._op.id), extra)

    def rand(self, shape, device=None):
        """Uniform [0, 1) float32 draws from this op's generator."""
        device = device or self.device
        if torch.device(device).type == "meta":
            return torch.empty(shape, device="meta")
        return torch.rand(shape, generator=self.generator, device=device)

    def randn(self, shape, device=None):
        """Standard normal float32 draws from this op's generator."""
        device = device or self.device
        if torch.device(device).type == "meta":
            return torch.empty(shape, device="meta")
        return torch.randn(shape, generator=self.generator, device=device)


def _with_leaves(opdef, ins):
    """The op's inputs with each differentiable slot (not in
    nondiff_inputs, every tensor floating) detached into leaves that
    require grad: the recorded graph starts at this op."""
    out = dict(ins)
    for slot, vals in ins.items():
        if slot in opdef.nondiff_inputs:
            continue
        if opdef.type == "recompute_segment":
            # a segment's inputs mix ids and floats: each float is a leaf
            out[slot] = [v.detach().requires_grad_()
                         if v.is_floating_point() else v for v in vals]
            continue
        if not all(v.is_floating_point() for v in vals):
            continue
        out[slot] = [v.detach().requires_grad_() for v in vals]
    return out


def _generic_grad(ctx, ins, attrs):
    """grad::generic: d(forward inputs) from the forward op's record and
    the cotangents of its outputs. Outputs without a cotangent and inputs
    the outputs do not reach get zeros, as jax.vjp gives."""
    fwd_id = attrs["fwd_id"]
    record, last = ctx.pop_record(fwd_id)
    if record is None:
        raise RuntimeError(
            f"grad::generic of {attrs['fwd_type']!r} (forward op id "
            f"{fwd_id}): the forward op left no autograd record; it must "
            f"run earlier in the same block")
    fwd_ins, fwd_outs = record
    # which positions of each output slot have a cotangent: the grad op's
    # inputs drop empty names, so the mask restores their positions
    grad_mask = attrs.get("fwd_out_grad_mask", {})
    outs, cots = [], []
    for slot in attrs["fwd_out_slots"]:
        prims = fwd_outs.get(slot, [])
        avail = list(ins.get(slot + GRAD_SUFFIX, []))
        mask = grad_mask.get(slot, [bool(avail)] * len(prims))
        for a, present in zip(prims, mask):
            if present and avail and a.is_floating_point():
                g = avail.pop(0)
                if a.requires_grad:
                    outs.append(a)
                    cots.append(g.to(a.dtype))
    result, targets, where = {}, [], []
    for gslot, names in ctx.outputs.items():
        vals = fwd_ins.get(gslot[:-len(GRAD_SUFFIX)], [])
        result[gslot] = [None] * len(names)
        for i, (name, leaf) in enumerate(zip(names, vals)):
            if not name:
                continue
            if leaf.requires_grad:
                targets.append(leaf)
                where.append((gslot, i))
            else:
                result[gslot][i] = torch.zeros_like(leaf)
    grads = torch.autograd.grad(outs, targets, cots, allow_unused=True,
                                retain_graph=not last) \
        if outs and targets else [None] * len(targets)
    for (gslot, i), leaf, g in zip(where, targets, grads):
        result[gslot][i] = torch.zeros_like(leaf) if g is None else g
    return result


REGISTRY.register(OpDef(type="grad::generic", lower=_generic_grad))


def lower_block(block, env: Dict, ctx: LowerCtx, drop_after=None,
                hooks=None):
    """Run the block's ops in order. `drop_after` maps an op index to the
    var names whose last use it is: they leave `env` once the op ran, so
    a step holds each activation and gradient only as long as it is
    needed. `hooks` maps an op index to a function of `env` run just
    before that op (index len(ops): after the last), the data-parallel
    run's collectives."""
    hooks = hooks or {}
    for i, op in enumerate(block.ops):
        if i in hooks:
            hooks[i](env)
        run_op(op, env, ctx, op_idx=i)
        for n in (drop_after or {}).get(i, ()):
            env.pop(n, None)
    if len(block.ops) in hooks:
        hooks[len(block.ops)](env)
    return env


# ---------------------------------------------------------------------------
# Build-time shape inference
# ---------------------------------------------------------------------------

def infer_op_shapes(op, block):
    """Fill in output var shapes/dtypes by running the lowering on meta
    tensors."""
    REGISTRY.get(op.type)  # unregistered -> NotImplementedError

    env = {}
    for slot, names in op.inputs.items():
        for n in names:
            if not n or n in env:
                continue
            v = block.var(n)
            if v.shape is None:
                return  # cannot infer yet
            shape = tuple(_DYN_DIM if d == -1 else d for d in v.shape)
            env[n] = torch.empty(shape, dtype=as_torch_dtype(v.dtype),
                                 device="meta")

    run_op(op, env, LowerCtx("meta"))
    for name in op.output_names():
        if not name or name not in env:
            continue
        out = env[name]
        v = block.var(name)
        v.shape = tuple(-1 if d == _DYN_DIM else int(d) for d in out.shape)
        v.dtype = ir_dtype(out.dtype)

