"""Serving engine: warmed, batched inference over AnalysisPredictor.

One (or a few) worker threads drain a `DynamicBatcher`. `EngineConfig`
pins a bucket ladder, `warmup()` runs one dummy batch per (batch-bucket x
seq-bucket) cell before traffic arrives, and the worker only ever feeds
ladder shapes, so after warmup the predictor's executor sees no new
cache entry (`cache_stats()["misses"]` stays put).

As in the JAX package's engine: transient batch failures (an injected
TransientFault, or a non-finite output under FLAGS_serving_nan_guard)
retry through a RetryPolicy; failures that exhaust it trip a circuit
breaker, and while it is open `submit` sheds with OverloadedError;
`health()` reports the state. Each batch gets a `serving.batch` span (the
executor's sub-spans hang under it), the `serving.*` stats and the
serving goodput counters. A CUDA error is a RuntimeError, which is
neither retried nor counted against the breaker: it fails its batch.

`warmup` runs the JAX package's static gates before the first ladder
cell runs: the verifier once, the graph passes once for the whole
ladder, and the memory gate once per cell, so a malformed or oversized
model is refused with the executor's cache still empty. The HTTP front
end is serving/http.py.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import goodput as _goodput
from .. import trace
from ..monitor import STAT_ADD, STAT_OBSERVE
from ..resilience.breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from ..resilience.faults import TransientFault
from ..resilience.faults import injector as _fault_injector
from ..resilience.retry import RetryPolicy, is_transient
from .batcher import (BATCH_BUCKETS_HIST, BucketLadder, DynamicBatcher,
                      EngineClosedError, FRACTION_BUCKETS,
                      OverloadedError)

__all__ = ["EngineConfig", "ServingEngine"]


class EngineConfig:
    """Knobs of one serving engine. Defaults come from the FLAGS_serving_*
    flags, so a deployment can tune an unmodified entry point from the
    environment."""

    def __init__(self, model_dir: Optional[str] = None,
                 max_batch_size: Optional[int] = None,
                 max_wait_us: Optional[int] = None,
                 queue_capacity: Optional[int] = None,
                 default_timeout_ms: Optional[float] = None,
                 batch_buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 seq_axis: int = 1,
                 feed_spec: Optional[Dict[str, Tuple[tuple, str]]] = None,
                 warmup: bool = True,
                 num_workers: int = 1,
                 http_port: Optional[int] = None):
        from ..core.flags import FLAGS
        self.model_dir = model_dir
        self.max_batch_size = int(max_batch_size
                                  if max_batch_size is not None
                                  else FLAGS.serving_max_batch_size)
        self.max_wait_us = int(max_wait_us if max_wait_us is not None
                               else FLAGS.serving_max_wait_us)
        self.queue_capacity = int(queue_capacity
                                  if queue_capacity is not None
                                  else FLAGS.serving_queue_capacity)
        self.default_timeout_ms = float(
            default_timeout_ms if default_timeout_ms is not None
            else FLAGS.serving_default_timeout_ms)
        if batch_buckets is None:
            # powers of two up to max_batch_size (always including it)
            batch_buckets = sorted({1 << i for i in
                                    range(self.max_batch_size.bit_length())
                                    if 1 << i <= self.max_batch_size}
                                   | {self.max_batch_size})
        self.batch_buckets = tuple(batch_buckets)
        self.seq_buckets = tuple(seq_buckets) if seq_buckets else None
        self.seq_axis = seq_axis
        # feed_spec: {name: (shape_per_example, dtype)} with None dims for
        # the seq axis; inferred from the program when omitted
        self.feed_spec = feed_spec
        self.warmup = warmup
        self.num_workers = max(1, int(num_workers))
        self.http_port = int(http_port if http_port is not None
                             else FLAGS.serving_http_port)

    def ladder(self) -> BucketLadder:
        return BucketLadder(self.batch_buckets, self.seq_buckets,
                            self.seq_axis)


class ServingEngine:
    """Batched, warmed, instrumented inference service.

    Lifecycle: construct (loads the model), `start()` (warmup + worker
    threads), `submit`/`predict` from any thread, `stop(drain=True)`.
    """

    def __init__(self, config: EngineConfig, predictor=None):
        from ..inference import AnalysisConfig, create_paddle_predictor
        if predictor is None:
            if not config.model_dir:
                raise ValueError(
                    "EngineConfig.model_dir or an explicit predictor is "
                    "required")
            predictor = create_paddle_predictor(
                AnalysisConfig(config.model_dir))
        self.config = config
        self.predictor = predictor
        self._ladder = config.ladder()
        self._batcher = DynamicBatcher(
            self._ladder, config.max_batch_size, config.max_wait_us,
            config.queue_capacity, config.default_timeout_ms)
        self._workers: List[threading.Thread] = []
        # the executor is not reentrant: serialize the device run; extra
        # workers still overlap host-side pad/concat/scatter
        self._infer_lock = threading.Lock()
        self._ready = threading.Event()
        self._stopping = False
        self._warmed_shapes: List[tuple] = []
        # batches dispatched by the workers (warmup not included)
        self.batches = 0
        # resilience: transient batch failures retry invisibly; repeated
        # failures trip the breaker and submissions shed with
        # OverloadedError until a half-open probe succeeds
        self._breaker = CircuitBreaker(name="serving")
        self._retry = RetryPolicy()
        self._state = "warming"  # warming -> ready -> stopped

    # -- shape spec ------------------------------------------------------
    def _feed_spec(self) -> Dict[str, Tuple[tuple, str]]:
        """{feed name: (per-example shape with None at the seq axis,
        numpy dtype str)} — from EngineConfig.feed_spec or inferred from
        the loaded program's data vars."""
        if self.config.feed_spec is not None:
            return dict(self.config.feed_spec)
        block = self.predictor.program().global_block()
        spec = {}
        for name in self.predictor.get_input_names():
            var = block.var(name)
            shape = list(var.shape or ())
            if not shape:
                raise ValueError(
                    f"feed {name!r} has no static shape; pass "
                    f"EngineConfig.feed_spec")
            per_example = []
            for axis, dim in enumerate(shape[1:], start=1):
                if dim == -1:
                    if axis == self.config.seq_axis \
                            and self.config.seq_buckets:
                        per_example.append(None)
                    else:
                        raise ValueError(
                            f"feed {name!r} axis {axis} is dynamic but "
                            f"not the configured seq axis; pass "
                            f"EngineConfig.feed_spec")
                else:
                    per_example.append(int(dim))
            # numpy has no bfloat16: such feeds are staged as float32
            dtype = "float32" if var.dtype == "bfloat16" else var.dtype
            spec[name] = (tuple(per_example), dtype)
        return spec

    def warmup_shapes(self) -> List[tuple]:
        """Every (batch_bucket, seq_bucket) cell of the ladder
        (seq_bucket None when the ladder has no seq dimension)."""
        seqs = self.config.seq_buckets or (None,)
        return list(itertools.product(self.config.batch_buckets, seqs))

    def warmup(self) -> int:
        """Run one dummy batch per ladder cell, so every reachable shape
        has its executor cache entry before traffic. Returns the number
        of shapes warmed."""
        from ..analysis import (memory_gate, optimize_gate, sharding_gate,
                                verify_gate)
        from ..core.lowering import ir_dtype

        # Static verification before any cell runs (FLAGS_program_verify):
        # in error mode a malformed model is refused at load, with
        # cache_stats() still at zero misses.
        prog = self.predictor.program()
        feeds = self.predictor.get_input_names()
        fetches = self.predictor.get_output_names()
        verify_gate(prog, feed_names=feeds, fetch_names=fetches,
                    where="serving.warmup")
        # The graph passes ONCE for the whole ladder (memoized per
        # fingerprint, level, feeds and fetches): every cell below, and
        # all traffic, runs the optimized program without a pass run.
        opt_prog, _ = optimize_gate(prog, feed_names=feeds,
                                    fetch_names=fetches,
                                    where="serving.warmup")
        spec = self._feed_spec()
        shapes = self.warmup_shapes()
        # The memory gate over EVERY cell before the first one runs
        # (FLAGS_memory_gate): one oversized (batch, seq) corner refuses
        # the whole ladder. Cells are keyed by the IR dtype names the
        # executor's own gate uses, so its lookups below hit these plans.
        for bb, sb in shapes:
            cell = {}
            for name, (per_example, dtype) in spec.items():
                dims = [bb] + [sb if d is None else d
                               for d in per_example]
                if any(d is None for d in dims):
                    raise ValueError(
                        f"feed {name!r} has a seq dim but the ladder "
                        f"has no seq_buckets")
                var = opt_prog.global_block()._find_var_recursive(name)
                cell[name] = (tuple(dims), ir_dtype(
                    var.dtype if var is not None else dtype))
            memory_gate(opt_prog, feed_shapes=cell, fetch_names=fetches,
                        where="serving.warmup")
            # the sharding gate per cell (FLAGS_sharding_verify): engages
            # only when FLAGS_sharded_mesh puts a layout in scope; a
            # layout-inconsistent model raises PTV060 before any cell runs
            sharding_gate(opt_prog, feed_shapes=cell, fetch_names=fetches,
                          where="serving.warmup")
        for bb, sb in shapes:
            feed = {}
            for name, (per_example, dtype) in spec.items():
                dims = [bb] + [sb if d is None else d
                               for d in per_example]
                if any(d is None for d in dims):
                    raise ValueError(
                        f"feed {name!r} has a seq dim but the ladder "
                        f"has no seq_buckets")
                feed[name] = np.zeros(dims, dtype=dtype)
            t0 = time.perf_counter()
            with self._infer_lock:
                self.predictor.run_dict(feed)
            STAT_OBSERVE("serving.warmup_seconds",
                         time.perf_counter() - t0)
            STAT_ADD("serving.warmup_shapes")
            self._warmed_shapes.append((bb, sb))
        return len(shapes)

    # -- lifecycle -------------------------------------------------------
    def start(self):
        """Warm the ladder (unless config.warmup is off), then start the
        worker thread(s) and mark the engine ready."""
        if self._workers:
            return self
        self._state = "warming"
        if self.config.warmup:
            self.warmup()
        self._stopping = False
        for i in range(self.config.num_workers):
            w = threading.Thread(target=self._worker_loop,
                                 name=f"ptt-serving-worker-{i}",
                                 daemon=True)
            w.start()
            self._workers.append(w)
        self._state = "ready"
        self._ready.set()
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = 30.0):
        """Shut down: reject new submissions, then either finish queued
        requests (drain=True) or fail them, and join the workers."""
        self._ready.clear()
        self._state = "stopped"
        self._stopping = True
        self._batcher.close(drain=drain)
        for w in self._workers:
            w.join(timeout)
        self._workers = []

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    @property
    def breaker(self) -> CircuitBreaker:
        return self._breaker

    def health(self) -> Dict[str, object]:
        """Load-balancer health view: ``state`` is one of warming /
        ready / degraded (half-open probing) / open (shedding) /
        stopped, plus the raw breaker state and the Retry-After
        seconds while open."""
        if self._state != "ready":
            return {"state": self._state, "breaker": self._breaker.state,
                    "retry_after_s": 0.0}
        b = self._breaker.state
        state = {OPEN: "open", HALF_OPEN: "degraded",
                 CLOSED: "ready"}[b]
        return {"state": state, "breaker": b,
                "retry_after_s": self._breaker.retry_after_s()}

    # -- request path ----------------------------------------------------
    def submit(self, feed: Dict[str, np.ndarray],
               timeout_ms: Optional[float] = None):
        """Enqueue; returns a response handle (`.result()` blocks).
        Raises OverloadedError while the circuit breaker is OPEN
        (load shedding: don't queue work the backend cannot do)."""
        if not self._breaker.allow():
            raise OverloadedError(
                "serving backend is unhealthy (circuit breaker open)",
                retry_after_s=self._breaker.retry_after_s())
        return self._batcher.submit(feed, timeout_ms=timeout_ms)

    def predict(self, feed: Dict[str, np.ndarray],
                timeout_ms: Optional[float] = None) -> List[np.ndarray]:
        """Blocking submit+wait: the outputs sliced to this request's
        rows, in `get_output_names()` order."""
        return self.submit(feed, timeout_ms=timeout_ms).result()

    def load(self) -> int:
        """Rows waiting in the batcher: what the router's least-loaded
        dispatch compares."""
        return self._batcher.pending_rows()

    def output_names(self) -> List[str]:
        return self.predictor.get_output_names()

    def cache_stats(self) -> Dict[str, int]:
        """The predictor executor's per-instance cache counters. With
        warmup on and traffic confined to the ladder, `misses` must not
        move after `start()` returns."""
        return self.predictor._exe.cache_stats()

    # -- worker ----------------------------------------------------------
    def _execute(self, feed):
        """One dispatch attempt: fault hook, device run, output
        hygiene. A non-finite float output (FLAGS_serving_nan_guard)
        raises TransientFault: a host-side corruption leaves the
        executor's state untouched, so re-running the same feed is a
        valid cure, and the RetryPolicy wrapping this call turns a
        glitched batch into a clean answer instead of a wrong one."""
        inj = _fault_injector()
        if inj is not None:
            inj.pre_step("serving")
        with self._infer_lock:
            outputs = self.predictor.run_dict(feed)
            self.batches += 1
        if inj is not None:
            outputs = list(outputs)
            inj.corrupt_fetches("serving", outputs)
        from ..core.flags import FLAGS
        if FLAGS.serving_nan_guard:
            for o in outputs:
                o = np.asarray(o)
                if np.issubdtype(o.dtype, np.floating) and o.size \
                        and not np.all(np.isfinite(o)):
                    STAT_ADD("resilience.nan_batches_retried")
                    raise TransientFault(
                        "non-finite value in batch outputs")
        return outputs

    def _worker_loop(self):
        while True:
            # serving goodput: time blocked in next_batch is idle;
            # everything from batch receipt to scatter is busy; pad waste
            # is execute time x the ladder's padded-row fraction
            t_wait0 = time.perf_counter()
            batch = self._batcher.next_batch(timeout=0.1)
            _goodput.serving_idle(time.perf_counter() - t_wait0)
            if batch is None:
                if self._stopping and self._batcher.pending_rows() == 0:
                    return
                continue
            t_busy0 = time.perf_counter()
            try:
                # one span per batch; it links the member request spans
                # (they live in other traces), and being current, the
                # executor's sub-spans attach under it
                bspan = trace.start_span(
                    "serving.batch", attrs={"rows": batch.rows})
                if bspan is not None:
                    for r in batch.requests:
                        bspan.add_link(r.span)
                try:
                    with trace.use_span(bspan):
                        feed, bucket, waste = batch.build_feed(
                            self._ladder)
                        t_exec0 = time.perf_counter()
                        outputs = self._retry.call(self._execute, feed)
                        _goodput.serving_pad_waste(
                            waste * (time.perf_counter() - t_exec0))
                except Exception as e:  # noqa: BLE001 — close the batch
                    # trace, then let the handler below fail the batch
                    trace.finish_trace(bspan,
                                       error=f"{type(e).__name__}: {e}",
                                       record_latency=False)
                    raise
                trace.finish_trace(bspan, record_latency=False)
                STAT_ADD("serving.batches")
                STAT_OBSERVE("serving.batch_size", batch.rows,
                             buckets=BATCH_BUCKETS_HIST)
                STAT_OBSERVE("serving.pad_waste_frac", waste,
                             buckets=FRACTION_BUCKETS)
                batch.scatter(outputs)
                self._breaker.record_success()
                _goodput.serving_busy(time.perf_counter() - t_busy0)
            except Exception as e:  # noqa: BLE001 — a poison batch must
                # fail ITS requests, not kill the worker thread
                if is_transient(e):
                    # exhausted-retry transients mean the backend is
                    # sick; poison (a bad request, a CUDA error) must not
                    # trip the breaker
                    self._breaker.record_failure()
                batch.fail(e if isinstance(e, EngineClosedError)
                           else RuntimeError(f"batch execution failed: "
                                             f"{e!r}"))
