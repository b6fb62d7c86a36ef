"""Sharded checkpoints of model-parallel state, in the JAX package's
format.

`save_sharded_persistables` has each rank write the distinct shards it
holds, one `.npy` a shard, named `<var>__shard<rank>_<k>.npy`, and a JSON
manifest (`manifest.json` from rank 0, `manifest.<rank>.json` from the
others) with every var's global shape, dtype, SpecLayout spec, shard
files and their index ranges, and the program's op-version map. The
shards are cut by the SpecLayout's spec, whatever split the rank
program holds a weight in (a row-held weight is regathered and cut by
its columns), so a checkpoint reads the same from either package.

`load_sharded_persistables` merges the manifests, refuses a checkpoint
written by newer op versions, and puts into the scope each var whole
(no mesh: one rank), or with a mesh this rank's shard of the split the
model-parallel rewrite holds it in, read from the memory-mapped files of
the shards that cover it, at any rank count.
"""
from __future__ import annotations

import glob
import json
import os

import numpy as np
import torch

from .core.scope import global_scope
from .framework import check_op_versions, op_version_map
from .io import atomic_np_save, atomic_write_text

__all__ = ["save_sharded_persistables", "load_sharded_persistables"]

_MANIFEST = "manifest.json"


def _shard_file(name, k):
    return f"{name.replace('/', '%2F')}__shard{k}.npy"


def _spec_json(spec):
    if spec is None:
        return None
    out = []
    for e in tuple(spec):
        if e is None:
            out.append(None)
        elif isinstance(e, (tuple, list)):
            out.append(list(e))
        else:
            out.append(str(e))
    return out


def _region(spec, shape, mesh):
    """This rank's [start, stop) per dim under `spec` on `mesh`, and
    whether it is the first rank holding that region."""
    index, first = [], True
    named = set()
    for d, size in enumerate(shape):
        axes = spec[d] if spec is not None and d < len(spec) else None
        axes = () if axes is None else (
            tuple(axes) if isinstance(axes, (list, tuple)) else (axes,))
        lo, hi = 0, int(size)
        for a in axes:
            named.add(a)
            n = int(mesh.shape[a])
            step = (hi - lo) // n
            lo = lo + mesh.axis_index(a) * step
            hi = lo + step
        index.append((lo, hi))
    for a in mesh.axis_names:
        if a not in named and mesh.axis_index(a) != 0:
            first = False
    return index, first


def _whole_value(scope, name, gshape):
    """The global value of a persistable this rank may hold a shard of
    (model split, fsdp rows, or ZeRO rows over the data axis)."""
    from .parallel.model_parallel import gather_param, storage_of
    from .ops import collective as coll
    t = gather_param(scope, name)
    if tuple(t.shape) != tuple(gshape) and len(gshape) and \
            t.shape[0] < gshape[0]:
        info = storage_of(scope).get(name)
        from .parallel.mesh import get_mesh
        mesh = info[4] if info else get_mesh()
        for a in mesh.axis_names:
            g = mesh.group(a)
            if g is not None and t.shape[0] * mesh.shape[a] == gshape[0]:
                t = coll.all_gather(t.contiguous(), g)
                break
    return t


def _spec_of(layout, name, shape, is_param):
    if layout is None:
        return None
    if hasattr(layout, "spec_for"):
        spec = layout.spec_for(name, shape, is_param=is_param)
    else:
        spec = layout(name)
    return spec if spec is not None and any(
        a is not None for a in spec) else None


def save_sharded_persistables(executor, dirname, main_program=None,
                              scope=None, layout=None):
    """Write this rank's distinct shards of every persistable var and its
    manifest; `layout` (a SpecLayout, or a state_spec_fn) gives the
    specs, by default the one the scope's model-parallel run used. On
    one rank every var is one whole shard."""
    from .framework import default_main_program
    from .parallel.mesh import world
    from .parallel.model_parallel import storage_of
    program = main_program or default_main_program()
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    stored = storage_of(scope)
    if layout is None:
        layout = next((info[5] for info in stored.values()
                       if len(info) > 5), None)
    n, rank = world()
    manifest = {"op_versions": op_version_map(program), "vars": {}}
    for v in program.list_vars():
        if not v.persistable or getattr(v, "is_data", False):
            continue
        t = scope.find_var(v.name)
        if not isinstance(t, torch.Tensor):
            continue
        info = stored.get(v.name)
        gshape = tuple(info[3]) if info else tuple(t.shape)
        mesh = info[4] if info else None
        spec = _spec_of(layout, v.name, gshape,
                        getattr(v, "is_parameter", False)) \
            if n > 1 else None
        full = _whole_value(scope, v.name, gshape) if n > 1 else t
        entry = {"shape": list(gshape),
                 "dtype": str(np.dtype(full.detach().cpu().numpy().dtype)
                              if full.dtype != torch.bfloat16
                              else "bfloat16"),
                 "spec": _spec_json(spec), "shards": []}
        if mesh is None and n > 1:
            from .parallel.mesh import get_mesh
            mesh = getattr(layout, "mesh", None) or get_mesh()
        if spec is None or mesh is None:
            index, first = [(0, int(s)) for s in gshape], rank == 0
        else:
            index, first = _region(spec, gshape, mesh)
        if first:
            arr = full.detach().cpu()
            arr = arr[tuple(slice(a, b) for a, b in index)].numpy()
            fn = _shard_file(v.name, f"{rank}_0")
            atomic_np_save(os.path.join(dirname, fn), arr)
            entry["shards"].append({"file": fn,
                                    "index": [list(i) for i in index]})
        manifest["vars"][v.name] = entry
    path = os.path.join(dirname, _MANIFEST if rank == 0
                        else f"manifest.{rank}.json")
    atomic_write_text(path, json.dumps(manifest, indent=1, sort_keys=True))
    if n > 1:
        import torch.distributed as dist
        dist.barrier()
    return manifest


def _read_manifest(dirname):
    with open(os.path.join(dirname, _MANIFEST)) as f:
        manifest = json.load(f)
    for extra in sorted(glob.glob(os.path.join(dirname,
                                               "manifest.*.json"))):
        with open(extra) as f:
            m2 = json.load(f)
        for name, entry in m2.get("vars", {}).items():
            base = manifest["vars"].setdefault(name, entry)
            if base is not entry:
                known = {tuple(tuple(i) for i in s["index"])
                         for s in base["shards"]}
                for s in entry["shards"]:
                    if tuple(tuple(i) for i in s["index"]) not in known:
                        base["shards"].append(s)
    return manifest


def _read_region(dirname, name, entry, want):
    """The [start, stop) region `want` of a var, from the memory-mapped
    shards that cover it; raises where they leave a gap."""
    shape = tuple(b - a for a, b in want)
    out = None
    covered = 0
    for s in entry["shards"]:
        idx = [tuple(i) for i in s["index"]]
        lo = [max(a, c) for (a, _), (c, _) in zip(want, idx)]
        hi = [min(b, d) for (_, b), (_, d) in zip(want, idx)]
        if shape and any(h <= l for l, h in zip(lo, hi)):
            continue
        arr = np.load(os.path.join(dirname, s["file"]), mmap_mode="r")
        if out is None:
            out = np.empty(shape, arr.dtype)
        src = tuple(slice(l - c, h - c) for l, h, (c, _) in
                    zip(lo, hi, idx))
        dst = tuple(slice(l - a, h - a) for l, h, (a, _) in
                    zip(lo, hi, want))
        out[dst] = arr[src]
        covered += int(np.prod([h - l for l, h in zip(lo, hi)]))
    if out is None or covered < int(np.prod(shape)):
        raise ValueError(
            f"checkpoint for {name!r} covers only {covered} of "
            f"{int(np.prod(shape))} elements of region {want} "
            f"(manifest.*.json files must accompany a sharded "
            f"checkpoint)")
    return out


def load_sharded_persistables(executor, dirname, main_program=None,
                              mesh=None, scope=None, layout=None,
                              batch_axes=("dp",)):
    """Load a sharded checkpoint into `scope`: every var whole when
    `mesh` is None (or holds one rank), else this rank's shard of the
    split the model-parallel rewrite holds it in on `mesh` under
    `layout` (default: the mesh's SpecLayout of the program)."""
    from .framework import default_main_program
    from .parallel.mesh import world
    program = main_program or default_main_program()
    scope = scope or global_scope()
    manifest = _read_manifest(dirname)
    check_op_versions(manifest.get("op_versions", {}))
    device = executor.device if executor is not None else \
        torch.device("cpu")
    plan = None
    if mesh is not None and world()[0] > 1 and mesh.size > 1:
        from .parallel.layout import SpecLayout
        from .parallel.model_parallel import ModelParallelPlan
        if layout is None:
            layout = SpecLayout(mesh).add_program(program)
        plan = ModelParallelPlan(program, mesh, layout, batch_axes)
    for name, entry in manifest["vars"].items():
        if main_program is not None and \
                not program.global_block().has_var(name):
            continue
        shape = tuple(entry["shape"])
        want = [(0, int(s)) for s in shape]
        if plan is not None:
            sp, fs = plan.state_split(name)
            if fs and shape:
                rows = shape[0] // plan.fsdp_n
                r = mesh.axis_index(plan.fsdp_axis)
                want[0] = (r * rows, (r + 1) * rows)
            if sp is not None:
                k, o, i = sp
                if o != 1:
                    raise ValueError(f"{name}: a split with outer {o} "
                                     f"is not a region of the file")
                lo, hi = want[k]
                step = (hi - lo) // plan.n
                r = mesh.axis_index(plan.axis)
                want[k] = (lo + r * step, lo + (r + 1) * step)
        arr = _read_region(dirname, name, entry, want)
        scope.set(name, torch.from_numpy(np.ascontiguousarray(arr))
                  .to(device))
        if plan is not None:
            plan.note_shard(scope, name, shape)
    return manifest
