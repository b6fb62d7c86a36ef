"""The rank program of a model-parallel run: tensor, sequence, expert and
weight sharding.

The JAX package jits one global program and GSPMD partitions it: the
SpecLayout gives every parameter a PartitionSpec (the last dim of a
matrix over `tp`, dim 0 over `fsdp`), `shard_hint` pins an activation,
and the partitioner inserts the collectives. The port runs one process a
rank, so it rewrites the global program into this rank's program once
per (program, mesh, rank) and runs that.

The sharding analyzer's rank walk (analysis/sharding.py,
`plan_rank_sharding`) decides everything: which shard of each parameter
the rank holds (Megatron's row-held `proj.w` and `fc2.w` among them),
the layout of every var over the model axis, and the adapters each op
runs on its inputs and outputs (f, g, all-gathers, reduce-scatters,
fsdp gathers), each priced where it is placed. This module turns that
plan into the rank program:

- each op's adapters become its `_mp` attr; core/lowering runs them
  inside the op's autograd record, so the op's `grad::generic`
  differentiates through them and the backward needs no rewrite;
- the declared shapes of the split vars (their gradients and XShapes
  too), the reshapes' `shape` attrs and the parameters' accumulators
  read local sizes;
- the scope's state is cut to this rank's shards on the first run, and
  fetches and checkpoints gather them back (`gather_param`).
Checkpoints still write the SpecLayout's spec (io_sharded.py).

Dropout on a split activation draws a different mask on each rank (the
op's seed folded with the rank), and the same mask on every rank for a
whole one: neither is the single-rank run's mask (ROADMAP §C).
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Dict, Optional

import torch

from ..analysis.sharding import forward_ops, is_update as _is_update
from ..ops import collective as coll
from ..ops.collective import Split

__all__ = ["ModelParallelPlan", "plan_for", "apply_adapters", "MP_ATTR",
           "storage_of", "gather_param", "RankLayout"]

MP_ATTR = "_mp"


class ModelParallelPlan:
    """This rank's program of `program` on `mesh` (see the module doc),
    from the analyzer's rank walk (`report.rank`).

    `axis` is the model axis the layouts split over: `tp` when it has
    more than one rank, else the axis the program's hints or its
    sequence-parallel or MoE ops name. `fsdp_axis` (and `fsdp_batch`:
    whether the batch is split over it) shards weights on dim 0."""

    def __init__(self, program, mesh, layout, batch_axes=()):
        from ..analysis.sharding import plan_rank_sharding
        self.mesh = mesh
        self.layout = layout
        self.batch_axes = tuple(batch_axes)
        self.report = plan_rank_sharding(program, mesh, layout,
                                         self.batch_axes)
        walk = self.report.rank
        for k in ("axis", "n", "fsdp_axis", "fsdp_n", "fsdp_batch",
                  "nbatch", "sp_mode", "params", "storage", "fsdp_params",
                  "lay", "reshape_local", "rehold"):
            setattr(self, k, getattr(walk, k))
        self.attrs = walk.attrs()
        self.program = self._rank_program(program)

    # -- the rank program --------------------------------------------------
    def _rank_program(self, program):
        p = program.clone()
        n = self.n
        block = p.global_block()
        for blk in p.blocks:
            for op in blk.ops:
                attr = self.attrs.get(op.id)
                if attr is not None:
                    op.attrs[MP_ATTR] = attr
                local = self.reshape_local.get(op.id)
                if local is not None:
                    for attrs in (op.attrs, op.attrs.get("fwd_attrs")):
                        if isinstance(attrs, dict) and "shape" in attrs:
                            attrs["shape"] = [
                                s if s in (0, -1) else loc
                                for s, loc in zip(attrs["shape"], local)]
        # local declared shapes: split vars, their gradients and XShapes
        grads: Dict[str, list] = {}
        for v in block.vars.values():
            if "@GRAD" in v.name:
                grads.setdefault(v.name.split("@GRAD")[0], []).append(
                    v.name)
        split = dict(self.lay)
        for name, sp in list(split.items()):
            for g in grads.get(name, ()):
                split.setdefault(g, sp)
        for op in forward_ops(block):
            if op.type in ("reshape2", "transpose2", "squeeze2",
                           "unsqueeze2"):
                x = op.inputs.get("X", [""])[0]
                xs = op.outputs.get("XShape", [""])
                if xs and xs[0] and x in split:
                    sp = split[x]
                    split[xs[0]] = Split(sp[0] + 1, sp[1], sp[2])
        for name, sp in split.items():
            v = block._find_var_recursive(name)
            if v is None or not v.shape:
                continue
            shape = list(v.shape)
            k = sp[0]
            if k < len(shape) and shape[k] and shape[k] > 0:
                shape[k] //= n
                v.shape = tuple(shape)
        for name in self.fsdp_params:
            for vn in [name] + grads.get(name, []):
                v = block._find_var_recursive(vn)
                if v is not None and v.shape:
                    v.shape = (v.shape[0] // self.fsdp_n, *v.shape[1:])
        self._accumulators(block)
        for name, sp in self.acc_storage.items():
            v = block._find_var_recursive(name)
            if v is not None and v.shape and sp is not None:
                shape = list(v.shape)
                shape[sp[0]] //= n
                v.shape = tuple(shape)
        for name in self.acc_fsdp:
            v = block._find_var_recursive(name)
            if v is not None and v.shape:
                v.shape = (v.shape[0] // self.fsdp_n, *v.shape[1:])
        p._fp_cache = None
        return p

    def _accumulators(self, block):
        """Each update op's param-shaped state holds the param's shard."""
        self.acc_storage: Dict[str, Optional[Split]] = {}
        self.acc_fsdp: set = set()
        self.acc_of: Dict[str, str] = {}
        for op in block.ops:
            if not _is_update(op):
                continue
            p = op.inputs["Param"][0]
            pshape = tuple(self.params[p].shape) if p in self.params \
                else ()
            for slot, names in op.inputs.items():
                if slot in ("Param", "Grad", "LearningRate"):
                    continue
                for n in names:
                    v = block._find_var_recursive(n)
                    if v is None or tuple(v.shape or ()) != pshape:
                        continue
                    self.acc_of[n] = p
                    if self.storage.get(p) is not None:
                        self.acc_storage[n] = self.storage[p]
                    if p in self.fsdp_params:
                        self.acc_fsdp.add(n)

    # -- run time ----------------------------------------------------------
    def global_shapes(self, program):
        """{state name: its global shape} of the global program."""
        return {v.name: tuple(v.shape or ()) for v in program.list_vars()
                if v.persistable}

    def state_split(self, name):
        """(model-axis Split or None, fsdp-sharded) of a persistable."""
        if name in self.storage:
            return self.storage[name], name in self.fsdp_params
        return self.acc_storage.get(name), name in self.acc_fsdp

    def shard_state(self, scope, global_shapes):
        """Keep this rank's shard of every split persistable: rank 0's
        global tensor is broadcast over the mesh once (a state the
        scope already holds as a shard stays)."""
        import torch.distributed as dist
        from .data_parallel import _SYNCED
        synced = _SYNCED.setdefault(scope, set())
        todo = []
        for name, gshape in sorted(global_shapes.items()):
            t = scope.find_var(name)
            if not isinstance(t, torch.Tensor) or name in synced:
                continue
            synced.add(name)
            if tuple(t.shape) == gshape:
                todo.append(name)
        ts = [scope.find_var(nm) for nm in todo]
        if ts and dist.is_initialized() and dist.get_world_size() > 1:
            for t, root in zip(ts, coll.coalesced(
                    ts, lambda f: coll.broadcast(f, dist.group.WORLD, 0))):
                t.copy_(root.view_as(t))
        record = _STORAGE.setdefault(scope, {})
        for name in todo:
            sp, fs = self.state_split(name)
            if sp is None and not fs:
                continue
            t = scope.find_var(name)
            if fs:
                t = self._fsdp_block(t)
            if sp is not None:
                t = coll.take_block(t, sp, self.n,
                                    self.mesh.axis_index(self.axis))
            scope.set(name, t.contiguous().clone())
        for name in global_shapes:
            sp, fs = self.state_split(name)
            if sp is not None or fs:
                record[name] = (self.axis, sp, self.fsdp_axis if fs
                                else None, global_shapes[name], self.mesh,
                                self.layout)

    def note_shard(self, scope, name, gshape):
        """Record that `scope` holds this rank's shard of `name` (a
        sharded checkpoint loaded it so): the first run neither
        broadcasts nor cuts it, and gather_param rebuilds it."""
        from .data_parallel import _SYNCED
        _SYNCED.setdefault(scope, set()).add(name)
        sp, fs = self.state_split(name)
        if sp is not None or fs:
            _STORAGE.setdefault(scope, {})[name] = (
                self.axis, sp, self.fsdp_axis if fs else None,
                tuple(gshape), self.mesh, self.layout)

    def _fsdp_block(self, t):
        r = self.mesh.axis_index(self.fsdp_axis)
        rows = t.shape[0] // self.fsdp_n
        return t[r * rows:(r + 1) * rows]

    def fetch(self, name, t):
        """The global value of a fetch held split on this rank (a
        gradient is split as its var)."""
        base = name.split("@GRAD")[0]
        sp = self.lay.get(base)
        if sp is None:
            sp = self.storage.get(base) or self.acc_storage.get(base)
        if base in self.fsdp_params or base in self.acc_fsdp:
            t = coll.all_gather(t, self.mesh.group(self.fsdp_axis))
        if sp is None or self.axis is None:
            return t
        return coll._gather_blocks(t, sp, self.mesh.group(self.axis))

    def synced_grads(self):
        """Gradients the rewrite already reduced over the batch (fsdp):
        the data-parallel plan leaves them alone."""
        if not self.fsdp_batch:
            return set()
        return {p + "@GRAD" for p in self.fsdp_params}


class RankLayout:
    """The memory planner's view of a rank program's state: its declared
    shapes are already this rank's model-axis and fsdp shards, so a
    persistable divides further only by the data axis, where ZeRO keeps
    an accumulator's rows (parallel/data_parallel.py)."""

    def __init__(self, layout, plan):
        self.layout = layout
        self.mesh = plan.mesh
        self.dp = int(getattr(layout, "dp", 1) or 1) if layout is not None \
            else 1

    def shard_count(self, name, shape=None):
        lay = self.layout
        if lay is None or self.dp <= 1 or not shape or \
                not hasattr(lay, "_is_zero_accumulator"):
            return 1
        if getattr(lay, "fsdp_axis", None) and lay.fsdp > 1:
            return 1
        if lay._is_zero_accumulator(name) and shape[0] % self.dp == 0:
            return self.dp
        return 1


# -- applying the adapters ----------------------------------------------------

def _meta_shape(x, ad, n):
    kind = ad[0]
    shape = list(x.shape)
    if kind in ("scatter", "rs"):
        shape[ad[2][0]] //= n
    elif kind == "gather":
        shape[ad[2][0]] *= n
    elif kind == "fsdp":
        shape[0] *= n
    return torch.empty(shape, dtype=x.dtype, device="meta")


def _apply_one(x, ad, mesh):
    kind, axis = ad[0], ad[1]
    if x.device.type == "meta":
        if kind in ("f", "reduce"):
            return x
        return _meta_shape(x, ad, int(mesh.shape[axis]))
    group = mesh.group(axis)
    if group is None:
        return x
    if kind == "f":
        return coll.copy_to(x, group) if x.is_floating_point() else x
    if kind == "reduce":
        return coll.reduce_from(x, group, ad[2])
    if kind == "scatter":
        return coll.scatter_to(x, group, Split(*ad[2]))
    if kind == "gather":
        return coll.gather_from(x, group, Split(*ad[2]))
    if kind == "rs":
        return coll.reduce_scatter_to(x, group, Split(*ad[2]))
    if kind == "fsdp":
        return coll.fsdp_gather(x, group, ad[2], ad[3])
    raise ValueError(f"unknown model-parallel adapter {ad!r}")


def apply_adapters(spec, side, tensors):
    """{slot: [tensors]} with the op's `side` ("in" or "out") adapters
    applied, over the mesh in scope."""
    from .mesh import get_mesh
    table = spec.get(side) or {}
    if not table:
        return tensors
    mesh = get_mesh()
    out = dict(tensors)
    for slot, per in table.items():
        if slot not in out:
            continue
        vals = list(out[slot])
        for i, ads in per.items():
            i = int(i)
            if i < len(vals):
                for ad in ads:
                    vals[i] = _apply_one(vals[i], ad, mesh)
        out[slot] = vals
    return out


# -- plans and stored shards ---------------------------------------------------

_LOCK = threading.Lock()
_MEMO: "OrderedDict[tuple, ModelParallelPlan]" = OrderedDict()
_CAP = 16
# scope -> {name: (model axis, Split, fsdp axis, global shape, mesh,
# layout)}
_STORAGE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def plan_for(program, mesh, layout, batch_axes):
    """The memoized plan of `program` on `mesh` for this rank."""
    from .mesh import world
    key = (program.fingerprint(), tuple(mesh.axis_names),
           tuple(mesh.devices.reshape(-1).tolist()),
           tuple(sorted(mesh.shape.items())), world()[1], id(layout),
           tuple(batch_axes))
    with _LOCK:
        hit = _MEMO.get(key)
    if hit is not None:
        return hit
    plan = ModelParallelPlan(program, mesh, layout, batch_axes)
    with _LOCK:
        _MEMO[key] = plan
        while len(_MEMO) > _CAP:
            _MEMO.popitem(last=False)
    return plan


def storage_of(scope) -> Dict[str, tuple]:
    """{persistable: (model axis, Split, fsdp axis, global shape, mesh,
    layout)} of the shards a model-parallel run left in `scope`."""
    return dict(_STORAGE.get(scope, {}))


def gather_param(scope, name):
    """The global value of a persistable the scope holds as this rank's
    shard (the value itself when it is whole)."""
    t = scope.find_var(name)
    info = _STORAGE.get(scope, {}).get(name)
    if info is None or not isinstance(t, torch.Tensor):
        return t
    axis, sp, fsdp_axis, gshape, mesh = info[:5]
    if fsdp_axis is not None:
        t = coll.all_gather(t, mesh.group(fsdp_axis))
    if sp is not None and mesh.group(axis) is not None:
        t = coll._gather_blocks(t, sp, mesh.group(axis))
    return t
