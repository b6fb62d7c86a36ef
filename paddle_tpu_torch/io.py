"""Checkpointing, inference-model export, and the fluid.io reader names.

The JAX package's on-disk format, unchanged: ``save_inference_model``
writes ``__model__.json`` (the feed→fetch-pruned program plus feed and
fetch names) and one ``<var>.npy`` per persistable; ``save`` writes
``<path>.pdparams`` (an npz of every persistable) and ``<path>.pdmodel``
(the program's JSON). A checkpoint saved by either package loads in the
other. Every file is written to a temp name, fsynced, then renamed over
the target, so a crash mid-save never leaves a half-written file
behind. Loads place the arrays on the executor's device (the card when
no executor is given).

``DataLoader``, ``PyReader`` and ``batch`` are here as fluid.io names
them.
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from .convert import scope_from_numpy
from .core.scope import global_scope
from .core.place import default_place
from .framework import Program, Variable
from .reader import DataLoader, PyReader  # noqa: F401  (fluid.io.DataLoader)
from .reader_decorator import batch  # noqa: F401  (fluid.io.batch)

__all__ = ["DataLoader", "PyReader",
           "save_vars", "save_params", "save_persistables", "load_vars",
           "load_params", "load_persistables", "save_inference_model",
           "load_inference_model", "save", "load", "batch"]


def _var_path(dirname, name):
    return os.path.join(dirname, name.replace("/", "%2F"))


def atomic_np_save(path: str, arr) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_np_savez(path: str, blob: dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_text(path: str, text: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _select(program, vars, predicate):
    if vars is not None:
        return vars
    return [v for v in program.list_vars()
            if predicate is None or predicate(v)]


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    from .framework import default_main_program
    program = main_program or default_main_program()
    vars = _select(program, vars, predicate)
    os.makedirs(dirname, exist_ok=True)
    scope = global_scope()
    if filename is not None:
        blob = {v.name: scope.get_numpy(v.name) for v in vars
                if scope.has(v.name)}
        atomic_np_savez(os.path.join(dirname, filename), blob)
        return
    for v in vars:
        if scope.has(v.name):
            atomic_np_save(_var_path(dirname, v.name) + ".npy",
                           scope.get_numpy(v.name))


def _is_persistable(v: Variable):
    return v.persistable and not v.is_data


def _is_param(v: Variable):
    return v.is_parameter


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program, None, _is_param,
                     filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program, None, _is_persistable,
                     filename)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Read the arrays and place them on the executor's device in the
    current scope (through convert.scope_from_numpy)."""
    from .framework import default_main_program
    program = main_program or default_main_program()
    vars = _select(program, vars, predicate)
    params = {}
    if filename is not None:
        blob = np.load(os.path.join(dirname, filename))
        params = {v.name: blob[v.name] for v in vars if v.name in blob}
    else:
        for v in vars:
            path = _var_path(dirname, v.name) + ".npy"
            if os.path.exists(path):
                params[v.name] = np.load(path)
    scope_from_numpy(params, global_scope(), executor.place)


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program, None, _is_param,
                     filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program, None, _is_persistable,
                     filename)


def _prune_for_inference(program: Program, feed_names: List[str],
                         fetch_names: List[str]) -> Program:
    """Keep only the ops needed to compute the fetches from the feeds, on
    a for_test clone (dropout and attention dropout off)."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        if set(op.output_names()) & needed:
            keep.append(op)
            needed.update(op.input_names())
    keep.reverse()
    block.ops = keep
    # drop vars no kept op touches (e.g. optimizer accumulators)
    referenced = set(feed_names) | set(fetch_names)
    for op in keep:
        referenced.update(op.input_names())
        referenced.update(op.output_names())
    block.vars = {n: v for n, v in block.vars.items() if n in referenced}
    pruned._fp_cache = None
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False):
    from .framework import default_main_program
    program = main_program or default_main_program()
    fetch_names = [v.name if isinstance(v, Variable) else v
                   for v in target_vars]
    pruned = _prune_for_inference(program, list(feeded_var_names),
                                  fetch_names)
    os.makedirs(dirname, exist_ok=True)
    meta = {"program": pruned.to_dict(), "feed_names": list(feeded_var_names),
            "fetch_names": fetch_names}
    atomic_write_text(
        os.path.join(dirname, model_filename or "__model__.json"),
        json.dumps(meta))
    if not program_only:
        save_persistables(executor, dirname, pruned,
                          filename=params_filename)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """(program, feed names, fetch vars); the persistables land in the
    current scope on the executor's device."""
    with open(os.path.join(dirname, model_filename or "__model__.json")) as f:
        meta = json.load(f)
    program = Program.from_dict(meta["program"])
    load_persistables(executor, dirname, program, filename=params_filename)
    block = program.global_block()
    fetch_vars = [block.var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


def save(program, model_path):
    """Every persistable of `program` held by the current scope into
    ``<model_path>.pdparams``, and the program into
    ``<model_path>.pdmodel``."""
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    scope = global_scope()
    blob = {v.name: scope.get_numpy(v.name)
            for v in program.list_vars()
            if v.persistable and scope.has(v.name)}
    atomic_np_savez(model_path + ".pdparams", blob)
    atomic_write_text(model_path + ".pdmodel", program.to_json())


def load(program, model_path, executor=None):
    """Every array of ``<model_path>.pdparams`` (or of the older
    ``<model_path>.pdparams.npz``) into the current scope, on the
    executor's device; an array the JAX package narrowed from a 64-bit
    var of `program` (a step counter) is widened back."""
    path = model_path + ".pdparams"
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path += ".npz"  # checkpoint written before the atomic rewrite
    place = executor.place if executor is not None else default_place()
    with np.load(path) as blob:
        params = {name: blob[name] for name in blob.files}
    scope_from_numpy(params, global_scope(), place, program=program)

