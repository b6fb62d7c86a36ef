"""Deadline-aware retry with jittered exponential backoff.

The JAX package's `resilience/retry.py`, with the same taxonomy. In this
package a CUDA error surfaces as a RuntimeError, which the taxonomy
leaves unretried.

The taxonomy half of the resilience subsystem: a failure is either
*transient* (flaky transport, injected chaos, non-finite outputs from a
recoverable glitch — retrying the same work is expected to succeed) or
*poison* (malformed request, shape mismatch, verification failure —
retrying burns the attempt budget and fails anyway). RetryPolicy retries
the first kind invisibly and surfaces the second immediately, so a
poison batch fails only its own requests while transients never reach a
client.

Usage::

    policy = RetryPolicy()               # flags-defaulted knobs
    out = policy.call(lambda: run(feed)) # retries transients

The backoff for attempt n is ``base * 2^(n-1)`` milliseconds, capped at
``max_delay_ms``, jittered to a uniform draw in [half, full] of that
value (full jitter halves synchronized retry herds without starving the
deadline). A ``deadline_ms`` bounds the whole call including sleeps; on
expiry the last error is raised wrapped in RetryExhausted.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

from ..core.flags import FLAGS
from ..monitor import STAT_ADD, STAT_OBSERVE
from .faults import TransientFault

__all__ = ["RetryPolicy", "RetryExhausted", "TransientFault",
           "is_transient"]

# ms buckets mirror serving/batcher.MS_BUCKETS (import would be
# circular: batcher -> engine -> retry)
_MS_BUCKETS = (1, 2, 5, 10, 20, 50, 100, 200, 500,
               1000, 2000, 5000, 10000)


class RetryExhausted(RuntimeError):
    """All attempts failed with transient errors. Carries the last
    underlying error as __cause__. Itself classified transient: an
    outer layer (circuit breaker) may still count it against health,
    but it is not poison."""


#: Error types that retrying is expected to cure. OSError covers the
#: flaky-transport class (connection resets); TimeoutError the
#: stuck-RPC class. ConnectionError is an OSError subclass.
_TRANSIENT_TYPES: Tuple[Type[BaseException], ...] = (
    TransientFault, RetryExhausted, OSError, TimeoutError)

#: Poison: retrying cannot help, fail fast. Checked BEFORE the
#: transient list so a poison subclass of a transient type stays
#: poison. FloatingPointError is the _nan_inf_guard signal — the
#: trainer guard handles it by rollback, not by replay.
_POISON_TYPES: Tuple[Type[BaseException], ...] = (
    ValueError, TypeError, KeyError, IndexError, AssertionError,
    FloatingPointError, NotImplementedError)


def is_transient(exc: BaseException) -> bool:
    """The retryable-error taxonomy. Unknown RuntimeErrors default to
    NOT retryable — replaying work with unknown failure semantics is
    how wrong answers get served."""
    if isinstance(exc, _POISON_TYPES):
        return False
    return isinstance(exc, _TRANSIENT_TYPES)


class RetryPolicy:
    """Bounded retry of transient failures with jittered exponential
    backoff. Thread-safe and reusable; one policy per subsystem."""

    def __init__(self, max_attempts: Optional[int] = None,
                 base_delay_ms: Optional[float] = None,
                 max_delay_ms: Optional[float] = None,
                 deadline_ms: Optional[float] = None,
                 is_retryable: Callable[[BaseException], bool]
                 = is_transient,
                 sleep: Callable[[float], None] = time.sleep):
        self.max_attempts = int(max_attempts
                                if max_attempts is not None
                                else FLAGS.retry_max_attempts)
        self.base_delay_ms = float(base_delay_ms
                                   if base_delay_ms is not None
                                   else FLAGS.retry_base_ms)
        self.max_delay_ms = float(max_delay_ms
                                  if max_delay_ms is not None
                                  else FLAGS.retry_max_ms)
        self.deadline_ms = deadline_ms
        self.is_retryable = is_retryable
        self._sleep = sleep  # injectable for tests
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def backoff_ms(self, attempt: int,
                   rng: Optional[random.Random] = None) -> float:
        """Backoff after failed attempt `attempt` (1-based): jittered
        exponential, in [half, full] of base * 2^(attempt-1), capped."""
        full = min(self.base_delay_ms * (2 ** (attempt - 1)),
                   self.max_delay_ms)
        draw = (rng.random() if rng is not None
                else random.random())
        return full * (0.5 + 0.5 * draw)

    def call(self, fn: Callable, *args, **kwargs):
        """Run fn, retrying transient failures. Raises the original
        error untouched when it is poison or the first attempt's budget
        is 1; raises RetryExhausted (last error as __cause__) when the
        attempt/deadline budget runs out."""
        deadline = (time.monotonic() + self.deadline_ms / 1000.0
                    if self.deadline_ms else None)
        last: Optional[BaseException] = None
        try:
            for attempt in range(1, self.max_attempts + 1):
                try:
                    return fn(*args, **kwargs)
                except BaseException as e:  # noqa: B036 — taxonomy decides
                    if not self.is_retryable(e):
                        raise
                    last = e
                if attempt == self.max_attempts:
                    break
                delay_ms = self.backoff_ms(attempt)
                if deadline is not None and \
                        time.monotonic() + delay_ms / 1000.0 > deadline:
                    STAT_ADD("resilience.retry_giveups")
                    raise RetryExhausted(
                        f"deadline exhausted after {attempt} attempt(s): "
                        f"{last!r}") from last
                STAT_ADD("resilience.retries")
                STAT_OBSERVE("resilience.retry_backoff_ms", delay_ms,
                             buckets=_MS_BUCKETS)
                # goodput ledger: backoff sleep is attributed here at the
                # source; the executor subtracts the delta from its
                # dispatch span so the categories stay exclusive
                from .. import goodput as _goodput
                _goodput.attribute("retry_backoff", delay_ms / 1000.0)
                self._sleep(delay_ms / 1000.0)
            STAT_ADD("resilience.retry_giveups")
            raise RetryExhausted(
                f"gave up after {self.max_attempts} attempt(s): "
                f"{last!r}") from last
        finally:
            # a caught error's traceback holds this frame, whose `last`
            # holds the error: drop it, so what fn's closure held (a
            # step's state tensors) is freed now, not at the next cyclic
            # garbage collection
            last = None
