"""The executor's data-parallel run: one process per rank.

The JAX package jits one step over a device mesh, the caller feeds the
global batch, and GSPMD inserts the collectives. The port runs the same
program in every rank process, as the reference's ParallelExecutor did,
and issues the collectives itself, so that each rank computes what the
JAX package computes on the global batch:

- feeds: every rank is given the global batch; a feed whose dim 0
  divides the data axis keeps rows [r·B/N, (r+1)·B/N) of rank r, any
  other feed is replicated (compiler.CompiledProgram.feed_rows). A
  program that bakes the global batch B into a `shape` attr (a
  reshape2 of the bench builders) runs as a clone whose dim 0 there,
  and in the declared shapes of its non-persistable vars, reads B/N
  (local_program);
- each persistable of a scope is broadcast from rank 0 once, by the
  first run that reads it, whatever program or cache entry that is: a
  later broadcast would copy rank 0's rows of a ZeRO accumulator over
  this rank's own;
- between the last backward op and the first update op, the parameter
  gradients are summed over the data axis and divided by its size
  (GradientScaleStrategy.CoeffNumDevice), one flattened buffer per
  dtype;
- ZeRO (a SpecLayout whose zero_spec splits an accumulator's dim 0 over
  the data axis): the scope keeps only this rank's rows of that
  accumulator; the gradient is reduce-scattered (or sliced, where other
  ops read it between the backward and its update), the update op runs
  on this rank's rows of parameter, gradient and moments, and the
  parameters are all-gathered after the last update. A dim that does not
  divide, and an update that reads whole-tensor norms (LAMB, LARS, DGC),
  keeps the replicated all-reduce and is listed in `layout.fallbacks`;
- `batch_norm` normalises by the global batch's statistics: its moments
  are all-reduced (LowerCtx.sync_group), as GSPMD computes them;
- fetches: a tensor with the batch dim is all-gathered on dim 0, the
  `loss_name` scalar is averaged over the ranks, and any other fetch is
  this rank's own value (a scalar that is not a mean over the batch, a
  sum say, differs from the JAX package's global value).

A mesh with a model axis or an fsdp layout runs the model-parallel
rewrite's rank program (model_parallel.py); this plan then splits and
syncs over the one batch axis above one rank, as before.
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Dict, List

import torch

from ..analysis.sharding import is_update as _is_update
from ..monitor import STAT_ADD
from ..ops import collective as coll

__all__ = ["DataParallelPlan", "GRAD_SYNC_BYTES"]

# update ops that read whole-tensor norms: never run on a shard
_NORM_UPDATES = frozenset({"lamb", "lars_momentum", "dgc_momentum",
                           "dgc"})
_BACKWARD_TYPES = frozenset({"sum", "fill_any_like", "fill_constant",
                             "assign", "scale"})

# gradient bytes this process synchronised (summed payload of the
# all-reduces and reduce-scatters of the cut)
GRAD_SYNC_BYTES = {"bytes": 0}


# scope -> the persistables rank 0 already broadcast into it
_SYNCED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

_LOCAL_LOCK = threading.Lock()
_LOCAL_MEMO: "OrderedDict[tuple, object]" = OrderedDict()
_LOCAL_CAP = 16


def local_program(program, total, local):
    """`program` with the global batch `total` read as this rank's
    `local` rows in dim 0 of every `shape` attr (the grad ops' copies of
    their forward attrs too) and of the declared shape of every var but
    the persistables and their gradients; the program itself when
    nothing names `total`. Memoized per
    (fingerprint, total, local), so the cache key stays stable."""
    key = (program.fingerprint(), total, local)
    with _LOCAL_LOCK:
        hit = _LOCAL_MEMO.get(key)
    if hit is not None:
        return hit
    p = program.clone()
    changed = False
    state = {v.name for v in p.list_vars() if v.persistable}
    for blk in p.blocks:
        for op in blk.ops:
            for attrs in (op.attrs, op.attrs.get("fwd_attrs")):
                shape = attrs.get("shape") if isinstance(attrs, dict) \
                    else None
                if isinstance(shape, (list, tuple)) and shape and \
                        shape[0] == total:
                    attrs["shape"] = [local, *shape[1:]]
                    changed = True
        for var in blk.vars.values():
            if var.persistable or var.name.split("@GRAD")[0] in state:
                continue  # state and its gradients have no batch dim
            shape = tuple(var.shape or ())
            # an XShape (reshape2, transpose2, ...) is (0, *x.shape)
            lead = 1 if len(shape) > 1 and shape[0] == 0 else 0
            if len(shape) > lead and shape[lead] == total:
                var.shape = (*shape[:lead], local, *shape[lead + 1:])
                changed = True
    out = p if changed else program
    with _LOCAL_LOCK:
        _LOCAL_MEMO[key] = out
        while len(_LOCAL_MEMO) > _LOCAL_CAP:
            _LOCAL_MEMO.popitem(last=False)
    return out


class DataParallelPlan:
    """What one prepared program does across the ranks of `group`."""

    def __init__(self, program, block, compiled, layout, group, dp,
                 index, synced=()):
        self.group, self.dp, self.index = group, dp, index
        self.layout = layout
        self.loss_name = compiled._loss_name
        ops = block.ops
        params = {v.name for v in program.list_vars()
                  if getattr(v, "is_parameter", False)}
        last_bwd = -1
        first_update = len(ops)
        updates = []
        for i, op in enumerate(ops):
            if _is_update(op):
                first_update = min(first_update, i)
                updates.append(i)
            elif i < first_update and (
                    op.type == "grad::generic" or (
                        op.type in _BACKWARD_TYPES and op.output_names()
                        and all("@GRAD" in n for n in op.output_names()))):
                last_bwd = i
        self.cut = last_bwd + 1
        produced = set()
        for op in ops[:self.cut]:
            produced.update(op.output_names())
        # a gradient the model-parallel rewrite already reduced over the
        # batch (an fsdp weight's) is not synced again
        self.grads = sorted(p + "@GRAD" for p in params
                            if p + "@GRAD" in produced
                            and p + "@GRAD" not in synced)
        # readers of each grad between the cut and the end
        readers: Dict[str, List[int]] = {}
        for i, op in enumerate(ops[self.cut:], self.cut):
            for n in op.input_names():
                readers.setdefault(n, []).append(i)
        # ZeRO: update op index -> (param, grad, row range, accumulators)
        self.zero: Dict[int, tuple] = {}
        self.scattered = []     # grads reduce-scattered at the cut
        self.sharded_accs = {}  # accumulator -> (rows, full dim 0)
        self.last_update = updates[-1] if updates else -1
        if layout is not None and dp > 1:
            for i in updates:
                self._plan_zero(ops[i], i, block, readers)
        scattered = set(self.scattered)
        self.reduced = [g for g in self.grads if g not in scattered]

    def _plan_zero(self, op, i, block, readers):
        layout = self.layout
        p = op.inputs["Param"][0]
        g = op.inputs["Grad"][0]
        accs = [n for slot, names in op.inputs.items()
                if slot not in ("Param", "Grad") for n in names
                if n and layout._is_zero_accumulator(n)]
        if not accs:
            return
        shape = tuple(block.var(p).shape or ())
        specs = [layout.zero_spec(a, tuple(block.var(a).shape or ()))
                 for a in accs]
        if not all(len(s) and s[0] == layout.data_axis for s in specs):
            return  # not divisible: layout.zero_spec noted the fallback
        if op.type in _NORM_UPDATES:
            for a in accs:
                layout._note_fallback(a, 0, layout.data_axis, shape[0],
                                      self.dp)
                layout.fallbacks[-1]["reason"] = \
                    f"{op.type} reads whole-tensor norms"
            return
        rows = shape[0] // self.dp
        r0 = self.index * rows
        for a in accs:
            self.sharded_accs[a] = ((r0, r0 + rows), shape[0])
        direct = g == p + "@GRAD" and readers.get(g, []) == [i]
        if direct:
            self.scattered.append(g)
        self.zero[i] = (p, g, (r0, r0 + rows), accs)

    # -- state ------------------------------------------------------------
    def broadcast_state(self, scope, names):
        """Rank 0's persistables that `scope` has not had yet into every
        rank, one buffer per dtype."""
        synced = _SYNCED.setdefault(scope, set())
        tensors = {n: scope.find_var(n) for n in sorted(names)
                   if n not in synced}
        tensors = {n: t for n, t in tensors.items()
                   if isinstance(t, torch.Tensor)}
        synced.update(tensors)
        ts = list(tensors.values())
        for t, root in zip(ts, coll.coalesced(
                ts, lambda f: coll.broadcast(f, self.group, 0))):
            t.copy_(root.view_as(t))

    def shard_state(self, scope):
        """Keep this rank's rows of each ZeRO accumulator in the scope."""
        for name, ((r0, r1), full) in self.sharded_accs.items():
            t = scope.find_var(name)
            if isinstance(t, torch.Tensor) and t.shape[0] == full:
                scope.set(name, t[r0:r1].clone())

    # -- the step's hooks -------------------------------------------------
    def hooks(self):
        """{op index: fn(env)} to run before that op (index len(ops):
        after the last)."""
        todo: Dict[int, list] = {self.cut: [self._sync_grads]}
        for i in sorted(self.zero):
            todo.setdefault(i, []).append(self._shard_update(i))
        if self.zero:
            todo.setdefault(self.last_update + 1, []).append(
                self._gather_params)
        return {i: (lambda env, _fns=fns: [f(env) for f in _fns])
                for i, fns in todo.items()}

    def _sync_grads(self, env):
        scale = 1.0 / self.dp
        grads = [g for g in self.reduced if g in env]
        ts = [env[n] for n in grads]
        for n, t, avg in zip(grads, ts, coll.coalesced(
                ts, lambda f: coll.all_reduce(f, self.group, "sum")
                .mul_(scale))):
            env[n] = avg.view_as(t)
        scattered = [g for g in self.scattered if g in env]
        sts = [env[n] for n in scattered]
        # block r of the buffer holds rank r's rows of every gradient
        for n, t, rows in zip(scattered, sts, coll.coalesced(
                sts, lambda f: coll.reduce_scatter(f, self.group)
                .mul_(scale), blocks=self.dp)):
            env[n] = rows.view(t.shape[0] // self.dp, *t.shape[1:])
        nbytes = sum(t.numel() * t.element_size() for t in ts + sts)
        GRAD_SYNC_BYTES["bytes"] += nbytes
        STAT_ADD("parallel.grad_sync_bytes", nbytes)

    def _shard_update(self, i):
        p, g, (r0, r1), _ = self.zero[i]

        def hook(env):
            full = env[p]
            self._full = getattr(self, "_full", {})
            self._full[p] = full
            env[p] = full[r0:r1]
            if env[g].shape[0] == full.shape[0]:
                env[g] = env[g][r0:r1]
        return hook

    def _gather_params(self, env):
        """All-gather every ZeRO parameter's rows, one buffer per
        dtype, into the full tensors the scope holds."""
        full = getattr(self, "_full", {})
        names = [p for p, *_ in self.zero.values() if p in full]
        local = [full[p].reshape(self.dp, -1)[self.index] for p in names]
        for p, per_rank in zip(names, coll.coalesced(
                local, lambda f: coll.all_gather(f, self.group))):
            full[p].view(self.dp, -1).copy_(per_rank)
            env[p] = full[p]
        self._full = {}

    # -- fetches ----------------------------------------------------------
    def fetch(self, name, t, var, rows):
        """The JAX package's global value of a fetch where the port can
        rebuild it: batch rows all-gathered, the loss averaged."""
        local, total = rows
        if name == self.loss_name and t.numel() == 1:
            return coll.all_reduce(t, self.group, "sum") / self.dp
        declared = tuple(getattr(var, "shape", None) or ())
        if (local and t.dim() >= 1 and t.shape[0] == local
                and total == local * self.dp and declared
                and declared[0] in (-1, total)):
            return coll.all_gather(t, self.group)
        return t
