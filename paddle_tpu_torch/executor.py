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

The JAX package's static gates run between the feed and the cache key,
in its order (analysis/):

1. the verifier (FLAGS_program_verify, default warn);
2. the graph passes (FLAGS_graph_opt_level, default 1): the optimized
   program keys the cache and runs;
3. the memory gate (FLAGS_memory_gate, default error) on the optimized
   program at the feed's shapes.

4. the sharding gate (FLAGS_sharding_verify, default warn), when a
   SpecLayout is in scope, on the global feed's shapes.

Each is memoized per program fingerprint (cached on the Program) and
signature, so after the first run they cost a few dictionary lookups. A
program a gate refuses raises before the cache records a miss and
before a feed is copied to the card. A ``CompiledProgram`` runs as its
program at one rank; over several torch.distributed ranks its
data-parallel run (parallel/data_parallel.py) splits the global batch
fed on every rank, syncs the gradients between the backward and the
update ops and rebuilds the fetches' global values, and a mesh with a
model axis (tp, sp, ep) or an fsdp layout runs this rank's program of
the model-parallel rewrite (parallel/model_parallel.py), its state held
as this rank's shards, under the mesh (gates included). FLAGS_sharded_exec
upgrades a data-parallel program to the SpecLayout path (ZeRO-sharded
optimizer state) before the gates, as the JAX package does; the traced
flags key the cache.

Instrumentation, as in the JAX package's executor: the ``executor.*``
stats (FLAGS_enable_monitor), the goodput ledger's step split
(FLAGS_enable_goodput), ``executor.feed`` / ``executor.dispatch`` /
``executor.fetch`` sub-spans under the current span (FLAGS_enable_trace),
one flight-recorder record per step, and ``last_step_timings``. The ops
run eagerly, so the split reads differently on a card: "dispatch" is the
host enqueueing the step's kernels (with the write-back of state to the
scope), and "fetch" is the copy of the fetches to the host, which
includes the wait for the card to finish them. No sync is added to make
them look otherwise. A fault spec (FLAGS_fault_spec) may fire an injected
TransientFault at the ``executor`` site before a step is dispatched; it
is retried here. Real dispatch errors, a CUDA error included, are never
retried.
"""
from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from . import goodput as _goodput
from . import trace as _trace
from .analysis import (memory_gate, optimize_gate, sharding_gate,
                       verify_gate)
from .core.dtypes import as_torch_dtype
from .core.lowering import LowerCtx, ir_dtype, lower_block
from .core.memory import record_device_memory
from .core.place import Place, default_place
from .core.scope import Scope, global_scope, scope_guard, tensor_to_numpy
from .framework import Program, Variable
from .monitor import STAT_ADD, STAT_OBSERVE, STAT_SET
from .monitor import enabled as _monitor_on
from .monitor import flight_step as _flight_step
from .resilience.faults import TransientFault
from .resilience.faults import injector as _fault_injector
from .resilience.retry import RetryPolicy

__all__ = ["Executor", "global_scope", "scope_guard"]


class _PreparedStep:
    """What a cache entry holds: the state the block reads and writes,
    the forward ops whose autograd graph its grad ops need, and the
    mode (inference only when the block writes no state and holds no
    grad op)."""

    def __init__(self, state_in_names, state_out_names, record_ids,
                 drop_after, unread, record_alias=None,
                 record_readers=None, dp_plan=None):
        self.state_in_names = state_in_names
        self.state_out_names = state_out_names
        self.record_ids = record_ids
        # CSE-merged forward op id -> survivor id, and per recorded id
        # the number of grad ops that read its record
        self.record_alias = record_alias or {}
        self.record_readers = record_readers or {}
        self.inference = not state_out_names and not record_ids
        # op index -> vars whose last use it is (not fetched, not state)
        self.drop_after = drop_after
        # op id -> outputs no later op reads and nobody fetches
        self.unread = unread
        # runs of this entry; the first is warmup for the goodput ledger
        # and the executor.compile_first_step_seconds stat
        self.runs = 0
        # the data-parallel run's plan (parallel/data_parallel.py)
        self.dp_plan = dp_plan


class Executor:
    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else default_place()
        # resolving the device raises here when the place has none
        self.device = self.place.torch_device()
        self._cache: "OrderedDict[tuple, _PreparedStep]" = OrderedDict()
        self._step_counters: Dict[str, int] = {}
        self._cache_hits = 0
        self._cache_misses = 0
        self._last_cache_hit = False
        # Sub-step timing of the most recent run() (feed staging /
        # dispatch / fetch, seconds). The generation engine reads this
        # after each step to attribute fetch time to the request spans
        # of the slots in flight.
        self.last_step_timings: Optional[Dict[str, float]] = None
        # the sharding gate's report of the most recent run() (None with
        # FLAGS_sharding_verify=off or no layout in scope); of a
        # model-parallel run, the rank program's priced collectives
        self.last_sharding_report = None
        self._last_feed_s = 0.0

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, scope: Optional[Scope] = None,
            return_numpy=True, use_program_cache=True):
        from .compiler import CompiledProgram

        if program is None:
            from .framework import default_main_program
            program = default_main_program()
        compiled = None
        if isinstance(program, CompiledProgram):
            compiled = program
            program = compiled.program
        scope = scope or global_scope()
        feed = dict(feed or {})
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        t_run0 = time.perf_counter()
        if len(program.blocks) > 1:
            from .parallel.recompute import expose_fetch_vars
            expose_fetch_vars(program, fetch_names)
        feed, lod_names = self._expand_lod_feeds(program, feed)
        dp = self._data_parallel(compiled, program)
        global_sig = self.feed_signature(program.global_block(), feed)
        rows = (0, 0)
        layout = compiled.layout() if compiled is not None else None
        gate_prog = program
        if dp is not None:
            from .parallel.data_parallel import local_program
            feed, rows = self._split_feed(compiled, feed)
            if rows[0] != rows[1]:
                program = local_program(program, rows[1], rows[0])
        mp = self._model_parallel(compiled, program)
        if mp is None:
            self.last_sharding_report = sharding_gate(
                gate_prog, layout=layout, feed_shapes=global_sig,
                fetch_names=fetch_names, where="executor")
        else:
            # the rank walk the rewrite was built from, priced on this
            # rank's feeds: the collectives the rank program runs
            self.last_sharding_report = sharding_gate(
                program, layout=layout,
                feed_shapes=self.feed_signature(program.global_block(),
                                                feed),
                fetch_names=fetch_names, where="executor",
                rank=(compiled.mesh(), compiled._batch_axes,
                      compiled._loss_name))
        mesh_ctx = contextlib.nullcontext
        if mp is not None:
            from .parallel.mesh import mesh_context
            mesh_ctx = lambda: mesh_context(compiled.mesh())  # noqa: E731
            state_shapes = mp.global_shapes(program)
            program = mp.program
        gate_layout = layout
        if mp is not None:
            from .parallel.model_parallel import RankLayout
            gate_layout = RankLayout(layout, mp)
        with mesh_ctx():
            run_prog = self._gates(program, feed, fetch_names, gate_layout)
        block = run_prog.global_block()
        feeds = self._prepare_feed(block, feed, lod_names)

        build_s = 0.0
        key = self._cache_key(run_prog, feeds, fetch_names) + (
            None if dp is None else dp[1:3] + (layout is not None,),)
        step = self._cache.get(key) if use_program_cache else None
        self._last_cache_hit = step is not None
        if step is not None:
            self._cache.move_to_end(key)
            self._cache_hits += 1
            STAT_ADD("executor.compile_cache_hit")
        else:
            self._cache_misses += 1
            STAT_ADD("executor.compile_cache_miss")
            t0 = time.perf_counter()
            step = self._prepare(run_prog, block, scope, fetch_names)
            if dp is not None:
                from .parallel.data_parallel import DataParallelPlan
                step.dp_plan = DataParallelPlan(
                    run_prog, block, compiled, layout, *dp,
                    synced=mp.synced_grads() if mp is not None else ())
            build_s = time.perf_counter() - t0
            STAT_OBSERVE("executor.compile_build_seconds", build_s)
            self._cache[key] = step
            from .core.flags import FLAGS
            cap = FLAGS.executor_cache_capacity
            while cap > 0 and len(self._cache) > cap:
                self._cache.popitem(last=False)
                STAT_ADD("executor.compile_cache_evictions")
            STAT_SET("executor.compile_cache_size", len(self._cache))
            STAT_SET("executor.compile_cache_capacity", cap)

        plan = step.dp_plan
        if mp is not None:
            mp.shard_state(scope, state_shapes)
        if plan is not None:
            plan.broadcast_state(scope, step.state_in_names)
            plan.shard_state(scope)
        state = {}
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
            state[n] = v

        fp = program.fingerprint()
        step_idx = self._step_counters.get(fp, 0)
        self._step_counters[fp] = step_idx + 1
        first_run = step.runs == 0
        step.runs += 1

        # goodput: retry backoff inside the dispatch span is attributed
        # by RetryPolicy itself, so it is subtracted from dispatch below
        gled = _goodput.active()
        bk0 = gled.category_seconds("retry_backoff") \
            if gled is not None else 0.0

        def dispatch():
            env = dict(state)
            env.update(feeds)
            ctx = LowerCtx(self.device, seed=program.random_seed,
                           step=step_idx, record_ids=step.record_ids,
                           unread=step.unread,
                           record_alias=step.record_alias,
                           record_readers=step.record_readers)
            if plan is not None:
                ctx.sync_group = plan.group
            # set here, not by the caller: grad mode is thread-local, and
            # serving engines run steps on worker threads
            with torch.inference_mode() if step.inference \
                    else torch.no_grad(), mesh_ctx():
                lower_block(block, env, ctx, step.drop_after,
                            hooks=plan.hooks() if plan else None)
            return env

        t_disp0 = time.perf_counter()
        inj = _fault_injector()
        if inj is None:
            env = dispatch()
        else:
            # an injected TransientFault fires before any op runs, so a
            # retry replays nothing; a real dispatch error is not retried
            def attempt():
                inj.pre_step("executor", step=step_idx)
                return dispatch()

            env = RetryPolicy(is_retryable=lambda e: isinstance(
                e, TransientFault)).call(attempt)
        for n in fetch_names:
            if n not in env:
                raise KeyError(f"fetch var {n!r} was not computed")
        for n in step.state_out_names:
            if n in env:
                scope.set(n, env[n].detach())
        fetches = [env[n].detach() for n in fetch_names]
        if mp is not None:
            fetches = [mp.fetch(n, t) for n, t in zip(fetch_names, fetches)]
        if plan is not None:
            fetches = [plan.fetch(n, t, block._find_var_recursive(n), rows)
                       for n, t in zip(fetch_names, fetches)]

        t_fetch0 = time.perf_counter()
        if return_numpy:
            # the copy to the host waits for the card: on a card this is
            # where the step's device time lands
            out = [tensor_to_numpy(f) for f in fetches]
            if inj is not None:
                # step_nan corrupts only these host copies; the state
                # written back above stays clean
                inj.corrupt_fetches("executor", out)
        else:
            out = fetches
        now = time.perf_counter()
        self.last_step_timings = {
            "feed_s": self._last_feed_s,
            "dispatch_s": t_fetch0 - t_disp0,
            "fetch_s": now - t_fetch0,
            "total_s": now - t_run0,
        }
        if gled is not None:
            gled.note_step(
                feed_s=self._last_feed_s, dispatch_s=t_fetch0 - t_disp0,
                fetch_s=now - t_fetch0, total_s=now - t_run0,
                build_s=build_s, first_run=first_run,
                backoff_s=gled.category_seconds("retry_backoff") - bk0)
        if _monitor_on():
            tid = _trace.current_trace_id()
            STAT_OBSERVE("executor.fetch_block_seconds", now - t_fetch0,
                         exemplar=tid)
            STAT_OBSERVE("executor.step_seconds", now - t_run0,
                         exemplar=tid)
            if first_run:
                STAT_OBSERVE("executor.compile_first_step_seconds",
                             now - t_run0, exemplar=tid)
            record_device_memory(self.device)
        cur = _trace.current_span()
        if cur is not None:
            # retroactive sub-spans under the current span (the batch
            # span in a serving worker), wall-clock endpoints rebuilt from
            # the perf deltas
            wall_end = time.time()
            w_fetch0 = wall_end - (now - t_fetch0)
            w_disp0 = wall_end - (now - t_disp0)
            w_run0 = wall_end - (now - t_run0)
            if self._last_feed_s > 0:
                _trace.record_span("executor.feed", w_run0,
                                   w_run0 + self._last_feed_s, cur)
            _trace.record_span("executor.dispatch", w_disp0, w_fetch0,
                               cur, attrs={"first_run": first_run})
            _trace.record_span("executor.fetch", w_fetch0, wall_end, cur)
        _flight_step(step=step_idx, program=fp[:12],
                     cache_hit=self._last_cache_hit, first_run=first_run,
                     step_seconds=round(now - t_run0, 6),
                     fetch_block_seconds=round(now - t_fetch0, 6),
                     fetches=len(fetch_names))
        return out

    @staticmethod
    def feed_signature(block, feed) -> Dict[str, tuple]:
        """{feed name: (shape, IR dtype name)}: the gates' view of a feed,
        read from the values as given (nothing is copied). The dtype is
        the declared var's, in the IR's names (int64 reads int32)."""
        sig = {}
        for name, val in feed.items():
            shape = tuple(val.shape) if hasattr(val, "shape") \
                else np.shape(val)
            if block.has_var(name):
                dtype = block.var(name).dtype
            else:
                dtype = val.dtype if hasattr(val, "dtype") \
                    else np.asarray(val).dtype
            sig[name] = (tuple(int(d) for d in shape), ir_dtype(dtype))
        return sig

    @classmethod
    def _gates(cls, program, feed, fetch_names, layout=None):
        """The verify, optimize and memory gates (the JAX package's order
        and place, before the cache key) on the feed's names, shapes and
        IR dtypes, read before anything is copied to the card (this
        rank's rows; the memory plan per rank under `layout`). Returns
        the program to run: the optimized one."""
        sig = cls.feed_signature(program.global_block(), feed)
        verify_gate(program, feed_names=sig.keys(),
                    fetch_names=fetch_names, where="executor")
        program, _ = optimize_gate(program, feed_names=sig.keys(),
                                   fetch_names=fetch_names,
                                   where="executor")
        memory_gate(program, feed_shapes=sig, fetch_names=fetch_names,
                    where="executor", layout=layout)
        return program

    @staticmethod
    def _data_parallel(compiled, program):
        """(group, data-axis ranks, this rank's index) of a data-parallel
        run over several ranks, or None. Applies the FLAGS_sharded_exec
        upgrade first (a SpecLayout over FLAGS_sharded_mesh or the
        registry mesh), as the JAX package does before its gates."""
        if compiled is None or not compiled._is_data_parallel:
            return None
        from .core.flags import FLAGS
        from .parallel.mesh import world
        if FLAGS.sharded_exec and compiled._state_spec_fn is None:
            from .parallel.layout import SpecLayout, mesh_from_spec
            mesh = mesh_from_spec(FLAGS.sharded_mesh) \
                if FLAGS.sharded_mesh else compiled.mesh()
            layout = SpecLayout(mesh).add_program(program)
            axes = (layout.data_axis,) if layout.data_axis else ()
            compiled.with_distributed(mesh, state_spec_fn=layout,
                                      batch_axes=axes)
        if compiled._state_spec_fn is not None:
            STAT_ADD("parallel.sharded_steps")
        mesh = compiled.mesh()
        n, idx = compiled.batch_split()
        size = world()[0]
        if mesh.size != size:
            raise ValueError(f"mesh {mesh.shape} holds {mesh.size} ranks "
                             f"but the process group has {size}")
        if size == 1 or n == 1:
            return None
        wide = [a for a in compiled._batch_axes if mesh.shape[a] > 1]
        if len(wide) != 1:
            raise NotImplementedError(
                f"batch_axes {compiled._batch_axes}: the port splits the "
                f"batch over one mesh axis")
        return mesh.group(wide[0]), n, idx

    @staticmethod
    def _model_parallel(compiled, program):
        """The model-parallel plan (parallel/model_parallel.py) of a run
        over several ranks whose mesh has an axis above one rank that is
        not a batch axis, or an fsdp layout; None otherwise. A `pp` axis
        is no model axis: GSPMD replicates a program over an axis that
        neither the batch nor a state spec names, so the ranks along it
        run the program as replicas of their batch coordinate (the
        GPipe schedule is parallel/pipeline.py's function API)."""
        if compiled is None or not compiled._is_data_parallel:
            return None
        from .parallel.mesh import world
        if world()[0] == 1:
            return None
        mesh = compiled.mesh()
        layout = compiled.spec_layout()
        wide = [a for a in mesh.axis_names
                if a not in compiled._batch_axes and a != "pp"
                and mesh.shape[a] > 1]
        fsdp = layout is not None and getattr(layout, "fsdp_axis", None) \
            and mesh.shape.get(layout.fsdp_axis, 1) > 1
        if not wide and not fsdp:
            return None
        from .parallel.model_parallel import plan_for
        return plan_for(program, mesh, layout, compiled._batch_axes)

    @staticmethod
    def _split_feed(compiled, feed):
        """(this rank's feed, (its rows, the global rows) of the split
        feeds): CompiledProgram.feed_rows' rule per feed."""
        out, rows = {}, (0, 0)
        for name, val in feed.items():
            shape = tuple(val.shape) if hasattr(val, "shape") \
                else np.shape(val)
            span = compiled.feed_rows(shape)
            if span is None:
                out[name] = val
                continue
            out[name] = val[span[0]:span[1]]
            rows = (span[1] - span[0], shape[0])
        return out, rows

    @staticmethod
    def _expand_lod_feeds(program, feed):
        """(the feed with every LoDTensor made dense, the names exempt from
        the rank check). A LoDTensor with LoD is padded to [B, T, ...] with
        T rounded up to a multiple of 8 (ragged batches then share a few
        shapes), and its lengths go to its var's companion
        (program.lod_link) unless the feed names the companion; a ragged
        feed of a var without a companion warns that padding will read as
        data. A plain array fed to a ragged var gets full lengths (T for
        every row) in its companion."""
        block = program.global_block()
        links = program.lod_link
        out, ragged = {}, set()
        for name, val in feed.items():
            if hasattr(val, "numpy_value"):
                if val.lod():
                    padded, lengths = val.to_padded(multiple=8)
                    ragged.add(name)
                    ln = links.get(name)
                    if ln and block.has_var(ln) and ln not in feed:
                        out[ln] = np.asarray(lengths, np.int64)
                    elif not ln:
                        import warnings
                        warnings.warn(
                            f"feed {name!r} carries LoD but the program "
                            f"declares no lengths var for it (was it "
                            f"created with lod_level=0?); sequence ops "
                            f"will treat padding as real data")
                    val = padded
                else:
                    val = val.numpy_value()
            out[name] = val
        for name, ln in links.items():
            if (ln not in out and name in out and block.has_var(ln)
                    and getattr(block.var(ln), "is_data", False)):
                shape = tuple(out[name].shape)
                if len(shape) >= 2:
                    out[ln] = np.full((shape[0],), shape[1], np.int64)
        return out, set(links) | set(links.values()) | ragged

    def _prepare_feed(self, block, feed, lod_names=()) -> Dict[str,
                                                               torch.Tensor]:
        """Feeds as tensors on the place, in the declared dtype. Integer
        ids stay int64 (torch indexing wants int64; the JAX package
        narrows them to int32 on the device). The rank check skips the
        ragged vars and their companions (`lod_names`): a ragged feed is
        padded to (batch, T, ...) on purpose."""
        t0 = time.perf_counter()
        out = {}
        total = host = presharded = 0
        for name, val in feed.items():
            t = val if isinstance(val, torch.Tensor) else \
                torch.from_numpy(np.ascontiguousarray(np.asarray(val)))
            staged = not isinstance(val, torch.Tensor)
            if block.has_var(name):
                var = block.var(name)
                want = as_torch_dtype(var.dtype)
                if t.dtype != want:
                    t = t.to(want)
                    staged = True
                declared = var.shape
                if declared and name not in lod_names and \
                        not var.lod_level and t.dim() != len(declared):
                    raise ValueError(
                        f"feed {name!r}: fed array has rank {t.dim()} "
                        f"(shape {list(t.shape)}) but the program "
                        f"declares rank {len(declared)} (shape "
                        f"{list(declared)}); reshape the feed or fix the "
                        f"data layer")
            nbytes = t.numel() * t.element_size()
            total += nbytes
            if t.device != self.device:
                host += nbytes if t.device.type == "cpu" else 0
                staged = True
            if not staged:
                presharded += 1
            out[name] = t.to(self.device, non_blocking=True)
        self._last_feed_s = time.perf_counter() - t0
        if _monitor_on():
            STAT_ADD("executor.feed_bytes", total)
            STAT_ADD("executor.feed_host_bytes", host)
            # feeds that arrived on the place in their dtype, untouched
            STAT_ADD("exec.feed_presharded", presharded)
            STAT_OBSERVE("executor.feed_stage_seconds", self._last_feed_s,
                         exemplar=_trace.current_trace_id())
        return out

    @staticmethod
    def _cache_key(program, feeds, fetch_names):
        from .core.flags import traced_values
        feed_sig = tuple(sorted(
            (n, tuple(t.shape), str(t.dtype)) for n, t in feeds.items()))
        return (program.fingerprint(), feed_sig, tuple(fetch_names),
                traced_values())

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
        # the forward ops whose autograd record a grad op reads: a
        # sub-op of a fused op records under its own id, and an id CSE
        # merged away resolves to its survivor's record
        alias = dict(getattr(program, "_record_alias", None) or {})
        readers = {}
        for op in block.ops:
            if op.type == "grad::generic":
                fid = alias.get(op.attrs["fwd_id"], op.attrs["fwd_id"])
                readers[fid] = readers.get(fid, 0) + 1
        record_ids = frozenset(readers)
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
                             unread, record_alias=alias,
                             record_readers={k: n for k, n in
                                             readers.items() if n > 1})

    def cache_stats(self) -> Dict[str, int]:
        """Per-instance prepared-run cache counters."""
        return {"hits": self._cache_hits, "misses": self._cache_misses,
                "size": len(self._cache)}

    def close(self):
        self._cache.clear()
