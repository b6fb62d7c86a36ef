"""Serving engine: warmed, batched inference over AnalysisPredictor.

One (or a few) worker threads drain a `DynamicBatcher`. `EngineConfig`
pins a bucket ladder, `warmup()` runs one dummy batch per (batch-bucket x
seq-bucket) cell before traffic arrives, and the worker only ever feeds
ladder shapes, so after warmup the predictor's executor sees no new
cache entry (`cache_stats()["misses"]` stays put).

Not ported yet (listed in ROADMAP.md): the monitor's serving.* stats, the
trace spans, goodput accounting, the resilience circuit breaker and
retry, and the analysis gates the JAX package runs in `warmup`.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .batcher import BucketLadder, DynamicBatcher, EngineClosedError

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
                 num_workers: int = 1):
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

    def ladder(self) -> BucketLadder:
        return BucketLadder(self.batch_buckets, self.seq_buckets,
                            self.seq_axis)


class ServingEngine:
    """Batched, warmed inference service.

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
        self._stopping = False
        self._warmed_shapes: List[tuple] = []
        # batches dispatched by the workers (warmup not included)
        self.batches = 0

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
        spec = self._feed_spec()
        shapes = self.warmup_shapes()
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
            with self._infer_lock:
                self.predictor.run_dict(feed)
            self._warmed_shapes.append((bb, sb))
        return len(shapes)

    # -- lifecycle -------------------------------------------------------
    def start(self):
        """Warm the ladder (unless config.warmup is off), then start the
        worker thread(s) and mark the engine ready."""
        if self._workers:
            return self
        if self.config.warmup:
            self.warmup()
        self._stopping = False
        for i in range(self.config.num_workers):
            w = threading.Thread(target=self._worker_loop,
                                 name=f"ptt-serving-worker-{i}",
                                 daemon=True)
            w.start()
            self._workers.append(w)
        return self

    def stop(self, drain: bool = True, timeout: Optional[float] = 30.0):
        """Shut down: reject new submissions, then either finish queued
        requests (drain=True) or fail them, and join the workers."""
        self._stopping = True
        self._batcher.close(drain=drain)
        for w in self._workers:
            w.join(timeout)
        self._workers = []

    # -- request path ----------------------------------------------------
    def submit(self, feed: Dict[str, np.ndarray],
               timeout_ms: Optional[float] = None):
        """Enqueue; returns a response handle (`.result()` blocks)."""
        return self._batcher.submit(feed, timeout_ms=timeout_ms)

    def predict(self, feed: Dict[str, np.ndarray],
                timeout_ms: Optional[float] = None) -> List[np.ndarray]:
        """Blocking submit+wait: the outputs sliced to this request's
        rows, in `get_output_names()` order."""
        return self.submit(feed, timeout_ms=timeout_ms).result()

    def cache_stats(self) -> Dict[str, int]:
        """The predictor executor's per-instance cache counters. With
        warmup on and traffic confined to the ladder, `misses` must not
        move after `start()` returns."""
        return self.predictor._exe.cache_stats()

    # -- worker ----------------------------------------------------------
    def _worker_loop(self):
        while True:
            batch = self._batcher.next_batch(timeout=0.1)
            if batch is None:
                if self._stopping and self._batcher.pending_rows() == 0:
                    return
                continue
            try:
                feed, _, _ = batch.build_feed(self._ladder)
                with self._infer_lock:
                    outputs = self.predictor.run_dict(feed)
                    self.batches += 1
                batch.scatter(outputs)
            except Exception as e:  # noqa: BLE001 — a poison batch must
                # fail ITS requests, not kill the worker thread
                batch.fail(e if isinstance(e, EngineClosedError)
                           else RuntimeError(f"batch execution failed: "
                                             f"{e!r}"))
