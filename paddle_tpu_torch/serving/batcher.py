"""Dynamic request batching for the serving engine.

`BucketLadder` quantizes every request onto a fixed grid of batch and
sequence buckets (the same shapes `ServingEngine.warmup` runs first), and
`DynamicBatcher` coalesces compatible requests into one padded batch,
flushing on max-batch-size or max-wait-micros, with per-request
deadlines, bounded-queue backpressure, and graceful drain. The
`serving.*` stats and the `serving.request` / `queue` / `execute` spans
are the JAX package's.

Threading model: any number of producer threads call `submit`; one (or a
few) consumer threads call `next_batch`. One lock + condition guards the
pending map; request completion happens outside the lock via per-request
events, so a slow client can never stall the dispatch path.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import trace
from ..monitor import STAT_ADD, STAT_OBSERVE, STAT_SET
from ..monitor import enabled as _monitor_on

__all__ = ["ServingError", "QueueFullError", "DeadlineExceededError",
           "EngineClosedError", "OverloadedError", "BucketLadder",
           "DynamicBatcher", "MS_BUCKETS", "FRACTION_BUCKETS",
           "BATCH_BUCKETS_HIST"]

# Histogram bucket sets for the serving.* stats (milliseconds and
# fractions — the monitor default is seconds-oriented).
MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
              250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)
FRACTION_BUCKETS = (0.0, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8,
                    0.9, 0.95)
BATCH_BUCKETS_HIST = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class ServingError(RuntimeError):
    """Base of every serving-engine request failure."""


class QueueFullError(ServingError):
    """Backpressure: the bounded request queue is at capacity."""


class DeadlineExceededError(ServingError):
    """The request's deadline passed before a worker completed it."""


class EngineClosedError(ServingError):
    """Submitted to (or pending in) a batcher that has shut down."""


class OverloadedError(ServingError):
    """Shed by an OPEN circuit breaker (resilience/breaker.py): the
    backend is failing, retry after `retry_after_s`."""

    def __init__(self, msg: str, retry_after_s: float = 0.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class BucketLadder:
    """Fixed (batch, seq) shape grid.

    `batch_buckets` are the allowed padded batch sizes (ascending);
    `seq_buckets`, when set, are the allowed padded lengths of
    `seq_axis` (counted on the full array, batch dim included) for every
    feed whose runtime length varies. Every request is padded UP to the
    smallest bucket that fits, so the set of shapes that can reach the
    executor is finite — exactly the set `ServingEngine.warmup`
    precompiles.
    """

    def __init__(self, batch_buckets: Sequence[int],
                 seq_buckets: Optional[Sequence[int]] = None,
                 seq_axis: int = 1, pad_value: float = 0.0):
        if not batch_buckets:
            raise ValueError("batch_buckets must be non-empty")
        self.batch_buckets = tuple(sorted(int(b) for b in batch_buckets))
        if any(b <= 0 for b in self.batch_buckets):
            raise ValueError(f"batch buckets must be positive: "
                             f"{self.batch_buckets}")
        self.seq_buckets = tuple(sorted(int(s) for s in seq_buckets)) \
            if seq_buckets else None
        self.seq_axis = int(seq_axis)
        self.pad_value = pad_value

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    @staticmethod
    def _ceil(buckets: Tuple[int, ...], n: int, what: str) -> int:
        for b in buckets:
            if n <= b:
                return b
        raise ValueError(
            f"{what} {n} exceeds the largest bucket {buckets[-1]}")

    def bucket_batch(self, n: int) -> int:
        return self._ceil(self.batch_buckets, n, "batch size")

    def bucket_seq(self, t: int) -> int:
        if self.seq_buckets is None:
            return t
        return self._ceil(self.seq_buckets, t, "sequence length")

    def pad_seq(self, arr: np.ndarray) -> np.ndarray:
        """Pad `seq_axis` up to its bucket (no-op without seq buckets or
        for arrays too low-rank to have the axis)."""
        if self.seq_buckets is None or arr.ndim <= self.seq_axis:
            return arr
        t = arr.shape[self.seq_axis]
        bucket = self.bucket_seq(t)
        if bucket == t:
            return arr
        widths = [(0, 0)] * arr.ndim
        widths[self.seq_axis] = (0, bucket - t)
        return np.pad(arr, widths, constant_values=self.pad_value)

    def pad_batch(self, arr: np.ndarray, bucket: int) -> np.ndarray:
        """Pad axis 0 with zero rows up to the batch bucket."""
        n = arr.shape[0]
        if bucket == n:
            return arr
        widths = [(0, 0)] * arr.ndim
        widths[0] = (0, bucket - n)
        return np.pad(arr, widths, constant_values=self.pad_value)


class _Response:
    """Future-ish handle returned by DynamicBatcher.submit."""

    __slots__ = ("_event", "_value", "_error", "span")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error = None
        # Request span, completed in _complete — the one funnel every
        # success and failure path flows through, so the trace is
        # finished exactly once no matter which path filled us in.
        self.span = None

    def done(self) -> bool:
        return self._event.is_set()

    def _complete(self, value=None, error=None):
        self._value, self._error = value, error
        if self.span is not None:
            err = None if error is None else \
                f"{type(error).__name__}: {error}"
            trace.complete_request(self.span, error=err)
        self._event.set()

    def result(self, timeout: Optional[float] = None):
        """Block for the outputs (a list of per-fetch ndarrays sliced to
        this request's rows). Raises the request's failure."""
        if not self._event.wait(timeout):
            raise DeadlineExceededError("result() wait timed out")
        if self._error is not None:
            raise self._error
        return self._value


class _Request:
    __slots__ = ("feed", "rows", "response", "t_enqueue", "deadline",
                 "span", "qspan")

    def __init__(self, feed, rows, deadline):
        self.feed = feed          # {name: seq-padded ndarray}
        self.rows = rows          # size of the request's batch dim
        self.response = _Response()
        self.t_enqueue = time.perf_counter()
        self.deadline = deadline  # perf_counter deadline or None
        # Request span + its queue-wait child. Spans cross the
        # submit -> worker thread hand-off ON this object (contextvars
        # do not follow requests across threads).
        self.span = None
        self.qspan = None


class _Batch:
    """One dispatchable group of shape-compatible requests."""

    __slots__ = ("requests", "signature", "t_dispatch")

    def __init__(self, requests, signature):
        self.requests = requests
        self.signature = signature
        self.t_dispatch = time.perf_counter()

    @property
    def rows(self) -> int:
        return sum(r.rows for r in self.requests)

    def build_feed(self, ladder: BucketLadder):
        """Concatenate the member requests along axis 0 and pad to the
        batch bucket. Returns (feed, batch_bucket, pad_waste_frac)."""
        bucket = ladder.bucket_batch(self.rows)
        feed: Dict[str, np.ndarray] = {}
        real = padded = 0
        for name in self.requests[0].feed:
            arr = np.concatenate([r.feed[name] for r in self.requests],
                                 axis=0) if len(self.requests) > 1 \
                else self.requests[0].feed[name]
            arr = ladder.pad_batch(arr, bucket)
            real += sum(r.feed[name].size for r in self.requests)
            padded += arr.size
            feed[name] = arr
        waste = 1.0 - (real / padded) if padded else 0.0
        return feed, bucket, waste

    def scatter(self, outputs: List[np.ndarray]):
        """Split each padded-batch output along axis 0 back to the
        member requests (the padded tail rows are dropped) and complete
        their responses."""
        offset = 0
        now = time.perf_counter()
        t_end = time.time()
        # Wall-clock start of the execute interval (dispatch -> now),
        # recorded retroactively under each member request's span.
        t_exec0 = t_end - (now - self.t_dispatch)
        for r in self.requests:
            trace.record_span("execute", t_exec0, t_end, r.span,
                              attrs={"batch_rows": self.rows})
            r.response._complete(
                [np.asarray(o[offset:offset + r.rows]) for o in outputs])
            if _monitor_on():
                STAT_OBSERVE("serving.e2e_ms",
                             (now - r.t_enqueue) * 1e3, buckets=MS_BUCKETS,
                             exemplar=r.span.trace_id if r.span else None)
            offset += r.rows

    def fail(self, error: Exception):
        for r in self.requests:
            r.response._complete(error=error)


class DynamicBatcher:
    """Thread-safe coalescing request queue over a BucketLadder.

    Producers `submit` feeds; a worker loop calls `next_batch`, which
    blocks until some shape-group either reached `max_batch_size` or its
    oldest request has waited `max_wait_us`, then returns the group as a
    `_Batch`. Requests whose deadline lapses while queued are failed
    with DeadlineExceededError; submissions past `queue_capacity`
    pending rows are rejected immediately with QueueFullError.
    """

    def __init__(self, ladder: BucketLadder, max_batch_size: int,
                 max_wait_us: int, queue_capacity: int,
                 default_timeout_ms: Optional[float] = None):
        if max_batch_size > ladder.max_batch:
            raise ValueError(
                f"max_batch_size {max_batch_size} exceeds the largest "
                f"batch bucket {ladder.max_batch}")
        self.ladder = ladder
        self.max_batch_size = int(max_batch_size)
        self.max_wait_s = max_wait_us / 1e6
        self.queue_capacity = int(queue_capacity)
        self.default_timeout_ms = default_timeout_ms
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # signature -> FIFO of _Request; signature is the per-example
        # shape/dtype key after seq-bucketing (batch dim excluded)
        self._pending: Dict[tuple, List[_Request]] = {}
        self._rows = 0
        self._closed = False
        self._draining = False

    # -- producer side --------------------------------------------------
    def submit(self, feed: Dict[str, np.ndarray],
               timeout_ms: Optional[float] = None) -> _Response:
        """Enqueue one request. `feed` maps input name -> ndarray whose
        axis 0 is this request's batch of rows (all inputs must agree).
        Returns a response handle; `.result()` blocks for the outputs.
        """
        if not feed:
            raise ValueError("empty feed")
        arrays = {}
        rows = None
        for name, val in feed.items():
            arr = np.asarray(val)
            if arr.ndim == 0:
                raise ValueError(f"feed {name!r} must have a batch dim")
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                raise ValueError(
                    f"feed {name!r} batch dim {arr.shape[0]} != {rows}")
            arrays[name] = self.ladder.pad_seq(arr)
        if rows == 0:
            raise ValueError("feed has zero rows")
        if rows > self.max_batch_size:
            raise ValueError(
                f"request rows {rows} exceed max_batch_size "
                f"{self.max_batch_size}; split the request")
        sig = tuple(sorted((n, a.shape[1:], str(a.dtype))
                           for n, a in arrays.items()))
        timeout_ms = timeout_ms if timeout_ms is not None \
            else self.default_timeout_ms
        deadline = time.perf_counter() + timeout_ms / 1e3 \
            if timeout_ms else None
        req = _Request(arrays, rows, deadline)
        if trace.enabled():
            # Child of the caller's span (http.request) when one is
            # current, else a new root trace.
            req.span = trace.start_span("serving.request",
                                        attrs={"rows": rows})
            req.response.span = req.span
            req.qspan = trace.start_span("queue", parent=req.span)
        try:
            with self._cond:
                if self._closed:
                    raise EngineClosedError("batcher is shut down")
                if self._rows + rows > self.queue_capacity:
                    STAT_ADD("serving.rejected")
                    raise QueueFullError(
                        f"queue at capacity ({self._rows}/"
                        f"{self.queue_capacity} rows pending)")
                self._pending.setdefault(sig, []).append(req)
                self._rows += rows
                STAT_ADD("serving.requests")
                STAT_SET("serving.queue_depth", self._rows)
                self._cond.notify_all()
        except ServingError as e:
            # Rejected before it was visible to any worker: the raise IS
            # the completion, so finish the trace here (errored -> the
            # tail rules keep it).
            trace.end_span(req.qspan, error=type(e).__name__)
            trace.complete_request(req.span,
                                   error=f"{type(e).__name__}: {e}")
            raise
        return req.response

    # -- consumer side --------------------------------------------------
    def _expire_locked(self, now: float) -> List[_Request]:
        dead = []
        for sig in list(self._pending):
            reqs = self._pending[sig]
            alive = []
            for r in reqs:
                if r.deadline is not None and now >= r.deadline:
                    dead.append(r)
                    self._rows -= r.rows
                else:
                    alive.append(r)
            if len(alive) != len(reqs):
                if alive:
                    self._pending[sig] = alive
                else:
                    del self._pending[sig]
        return dead

    def _pick_locked(self, now: float, force: bool):
        """The flushable group, or (None, wait_s) with the time until
        the earliest group matures. force flushes any non-empty group
        (drain path)."""
        best_sig, best_age = None, -1.0
        wait = None
        for sig, reqs in self._pending.items():
            rows = sum(r.rows for r in reqs)
            age = now - reqs[0].t_enqueue
            if force or rows >= self.max_batch_size \
                    or age >= self.max_wait_s:
                if age > best_age:
                    best_sig, best_age = sig, age
            else:
                remaining = self.max_wait_s - age
                if r_dl := [r.deadline for r in reqs
                            if r.deadline is not None]:
                    remaining = min(remaining, max(min(r_dl) - now, 0.0))
                wait = remaining if wait is None else min(wait, remaining)
        if best_sig is None:
            return None, wait
        reqs = self._pending[best_sig]
        take, rows = [], 0
        while reqs and rows + reqs[0].rows <= self.max_batch_size:
            r = reqs.pop(0)
            take.append(r)
            rows += r.rows
        if not reqs:
            del self._pending[best_sig]
        self._rows -= rows
        return _Batch(take, best_sig), None

    def next_batch(self, timeout: Optional[float] = None):
        """Block until a batch is ready (or `timeout` elapses -> None;
        closed + empty -> None). Expired requests are failed inline."""
        deadline = time.perf_counter() + timeout \
            if timeout is not None else None
        expired: List[_Request] = []
        batch = None
        with self._cond:
            while True:
                now = time.perf_counter()
                expired.extend(self._expire_locked(now))
                batch, wait = self._pick_locked(
                    now, force=self._draining)
                if batch is not None or (self._closed
                                         and not self._pending):
                    break
                if deadline is not None:
                    remaining = deadline - now
                    if remaining <= 0:
                        break
                    wait = remaining if wait is None \
                        else min(wait, remaining)
                # no pending work and no timeout: sleep until notified
                self._cond.wait(wait)
            if batch is not None:
                STAT_SET("serving.queue_depth", self._rows)
        for r in expired:
            STAT_ADD("serving.timeouts")
            trace.end_span(r.qspan, error="DeadlineExceededError")
            r.response._complete(error=DeadlineExceededError(
                f"request waited past its "
                f"{'deadline' if r.deadline else 'timeout'}"))
        if batch is not None:
            for r in batch.requests:
                trace.end_span(r.qspan)
                if _monitor_on():
                    STAT_OBSERVE("serving.queue_wait_ms",
                                 (batch.t_dispatch - r.t_enqueue) * 1e3,
                                 buckets=MS_BUCKETS)
        return batch

    # -- lifecycle ------------------------------------------------------
    def pending_rows(self) -> int:
        with self._lock:
            return self._rows

    def close(self, drain: bool = True):
        """Stop accepting submissions. drain=True leaves queued requests
        for the worker to finish (and flushes immature groups at once);
        drain=False fails them with EngineClosedError."""
        failed: List[_Request] = []
        with self._cond:
            self._closed = True
            self._draining = drain
            if not drain:
                for reqs in self._pending.values():
                    failed.extend(reqs)
                self._pending.clear()
                self._rows = 0
            STAT_SET("serving.queue_depth", self._rows)
            self._cond.notify_all()
        for r in failed:
            r.response._complete(error=EngineClosedError(
                "batcher shut down before the request ran"))
