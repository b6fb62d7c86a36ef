"""Executor: run a Program on a Place.

``Executor.run`` moves the feeds to the place, runs the global block op
by op, writes persistable state back to the Scope and returns the
fetches as numpy arrays. PyTorch runs eagerly and compiles nothing, but
the executor keeps the JAX package's per-instance cache of prepared
runs, keyed on (program fingerprint, feed shapes and dtypes, fetch
names), with its hit and miss counters: a serving engine's "no new
entries after warmup" contract stays meaningful, and a program or shape
that was never warmed shows up as a miss.

Two modes, chosen when a run is prepared:

- a program that writes no persistable state and holds no grad op (a
  predictor's forward) runs under ``torch.inference_mode()``;
- any other program (the startup program, a training step) runs under
  ``torch.no_grad()``, so the tensors it leaves in the Scope are plain
  tensors that later runs may differentiate through and update in place.
  The forward ops that a ``grad::generic`` op names run with grad
  enabled and record their autograd graph for it (core/lowering.py).

Any var of the block can be fetched, a gradient (``…@GRAD``) included.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from .core.dtypes import as_torch_dtype
from .core.lowering import LowerCtx, lower_block
from .core.place import Place, default_place
from .core.scope import Scope, global_scope, scope_guard, tensor_to_numpy
from .framework import Program, Variable

__all__ = ["Executor", "global_scope", "scope_guard"]


class _PreparedStep:
    """What a cache entry holds: the state the block reads and writes,
    the forward ops whose autograd graph its grad ops need, and the
    mode (inference only when the block writes no state and holds no
    grad op)."""

    def __init__(self, state_in_names, state_out_names, record_ids,
                 drop_after, unread):
        self.state_in_names = state_in_names
        self.state_out_names = state_out_names
        self.record_ids = record_ids
        self.inference = not state_out_names and not record_ids
        # op index -> vars whose last use it is (not fetched, not state)
        self.drop_after = drop_after
        # op id -> outputs no later op reads and nobody fetches
        self.unread = unread


class Executor:
    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else default_place()
        # resolving the device raises here when the place has none
        self.device = self.place.torch_device()
        self._cache: "OrderedDict[tuple, _PreparedStep]" = OrderedDict()
        self._step_counters: Dict[str, int] = {}
        self._cache_hits = 0
        self._cache_misses = 0

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, scope: Optional[Scope] = None,
            return_numpy=True, use_program_cache=True):
        if program is None:
            from .framework import default_main_program
            program = default_main_program()
        scope = scope or global_scope()
        feed = dict(feed or {})
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        block = program.global_block()
        feeds = self._prepare_feed(block, feed)

        key = self._cache_key(program, feeds, fetch_names)
        step = self._cache.get(key) if use_program_cache else None
        if step is not None:
            self._cache.move_to_end(key)
            self._cache_hits += 1
        else:
            self._cache_misses += 1
            step = self._prepare(program, block, scope, fetch_names)
            self._cache[key] = step
            from .core.flags import FLAGS
            cap = FLAGS.executor_cache_capacity
            while cap > 0 and len(self._cache) > cap:
                self._cache.popitem(last=False)

        env = {}
        for n in step.state_in_names:
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"persistable var {n!r} is not initialised — run the "
                    f"startup program first")
            if not (isinstance(v, torch.Tensor) and v.device == self.device):
                where = v.device if isinstance(v, torch.Tensor) else "host"
                raise RuntimeError(
                    f"persistable var {n!r} lies on {where} but this "
                    f"executor runs on {self.device}; place it with "
                    f"convert.scope_from_numpy")
            env[n] = v
        env.update(feeds)

        fp = program.fingerprint()
        step_idx = self._step_counters.get(fp, 0)
        self._step_counters[fp] = step_idx + 1
        ctx = LowerCtx(self.device, seed=program.random_seed, step=step_idx,
                       record_ids=step.record_ids, unread=step.unread)
        with torch.inference_mode() if step.inference else torch.no_grad():
            lower_block(block, env, ctx, step.drop_after)
        for n in fetch_names:
            if n not in env:
                raise KeyError(f"fetch var {n!r} was not computed")
        for n in step.state_out_names:
            if n in env:
                scope.set(n, env[n].detach())
        fetches = [env[n].detach() for n in fetch_names]
        if return_numpy:
            return [tensor_to_numpy(f) for f in fetches]
        return fetches

    def _prepare_feed(self, block, feed) -> Dict[str, torch.Tensor]:
        """Feeds as tensors on the place, in the declared dtype. Integer
        ids stay int64 (torch indexing wants int64; the JAX package
        narrows them to int32 on the device)."""
        out = {}
        for name, val in feed.items():
            t = val if isinstance(val, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(np.asarray(val)))
            if block.has_var(name):
                var = block.var(name)
                want = as_torch_dtype(var.dtype)
                if t.dtype != want:
                    t = t.to(want)
                declared = var.shape
                if declared and t.dim() != len(declared):
                    raise ValueError(
                        f"feed {name!r}: fed array has rank {t.dim()} "
                        f"(shape {list(t.shape)}) but the program "
                        f"declares rank {len(declared)} (shape "
                        f"{list(declared)}); reshape the feed or fix the "
                        f"data layer")
            out[name] = t.to(self.device, non_blocking=True)
        return out

    @staticmethod
    def _cache_key(program, feeds, fetch_names):
        feed_sig = tuple(sorted(
            (n, tuple(t.shape), str(t.dtype)) for n, t in feeds.items()))
        return (program.fingerprint(), feed_sig, tuple(fetch_names))

    @staticmethod
    def _prepare(program, block, scope, fetch_names) -> _PreparedStep:
        # state in: persistables already in scope or read before written
        persistables = {v.name for v in program.list_vars() if v.persistable}
        produced = set()
        consumed_first = set()
        for op in block.ops:
            for n in op.input_names():
                if n in persistables and n not in produced:
                    consumed_first.add(n)
            produced.update(op.output_names())
        state_in = sorted(n for n in persistables
                          if scope.has(n) or n in consumed_first)
        state_out = sorted(persistables & produced)
        record_ids = frozenset(op.attrs["fwd_id"] for op in block.ops
                               if op.type == "grad::generic")
        last_use, last_read = {}, {}
        for i, op in enumerate(block.ops):
            for n in op.input_names():
                last_read[n] = i
            for n in op.input_names() + op.output_names():
                if n:
                    last_use[n] = i
        keep = set(fetch_names) | set(state_out)
        drop_after = {}
        for n, i in last_use.items():
            if n not in keep:
                drop_after.setdefault(i, []).append(n)
        unread = {}
        for i, op in enumerate(block.ops):
            dead = frozenset(n for n in op.output_names() if n and n not in
                             keep and last_read.get(n, -1) <= i)
            if dead:
                unread[op.id] = dead
        return _PreparedStep(state_in, state_out, record_ids, drop_after,
                             unread)

    def cache_stats(self) -> Dict[str, int]:
        """Per-instance prepared-run cache counters."""
        return {"hits": self._cache_hits, "misses": self._cache_misses,
                "size": len(self._cache)}

    def close(self):
        self._cache.clear()

