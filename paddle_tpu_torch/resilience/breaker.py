"""Circuit breaker: the serving-side load-shedding state machine.

The JAX package's `resilience/breaker.py`, with the same states and
stats.

States::

    CLOSED ──(threshold consecutive failures)──> OPEN
    OPEN ──(cooldown elapsed)──> HALF_OPEN
    HALF_OPEN ──(probe succeeds)──> CLOSED
    HALF_OPEN ──(probe fails)──> OPEN (fresh cooldown)

While OPEN every ``allow()`` answers False and the caller sheds the
request (serving maps this to OverloadedError → HTTP 503 with
Retry-After) instead of queueing work the backend cannot do. HALF_OPEN
admits a bounded number of probe requests; the first success closes the
breaker, a failure re-opens it.

Only *transient* failures (TransientFault, RetryExhausted — the
taxonomy of retry.py) should be recorded: a poison request failing is
client error, not backend sickness, and must not trip the breaker.
That classification is the caller's job; this class just counts.

Publishes ``resilience.breaker_state`` (gauge: 0 CLOSED, 1 HALF_OPEN,
2 OPEN), ``resilience.breaker_opens`` and ``resilience.breaker_shed``.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from ..core.flags import FLAGS
from ..monitor import STAT_ADD, STAT_SET, flight_record

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Thread-safe three-state breaker. ``failure_threshold=0``
    disables it: allow() is always True, state stays CLOSED."""

    def __init__(self, failure_threshold: Optional[int] = None,
                 cooldown_ms: Optional[float] = None,
                 half_open_probes: int = 1,
                 name: str = "serving",
                 clock=time.monotonic):
        self.failure_threshold = int(
            failure_threshold if failure_threshold is not None
            else FLAGS.serving_breaker_threshold)
        self.cooldown_ms = float(
            cooldown_ms if cooldown_ms is not None
            else FLAGS.serving_breaker_cooldown_ms)
        self.half_open_probes = max(1, int(half_open_probes))
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0

    # -- state ----------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self):
        # lock held
        if self._state == OPEN and (self._clock() - self._opened_at) \
                * 1000.0 >= self.cooldown_ms:
            self._transition(HALF_OPEN)
            self._probes_in_flight = 0

    def _transition(self, new: str):
        # lock held
        if new == self._state:
            return
        old, self._state = self._state, new
        STAT_SET("resilience.breaker_state", _STATE_GAUGE[new])
        flight_record("breaker_transition", breaker=self.name,
                      old=old, new=new)
        if new == OPEN:
            self._opened_at = self._clock()
            STAT_ADD("resilience.breaker_opens")

    # -- caller surface -------------------------------------------------

    def allow(self) -> bool:
        """May this request proceed? False = shed it now. HALF_OPEN
        admits up to half_open_probes concurrent probes."""
        if self.failure_threshold <= 0:
            return True
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN:
                if self._probes_in_flight < self.half_open_probes:
                    self._probes_in_flight += 1
                    return True
            STAT_ADD("resilience.breaker_shed")
            return False

    def would_allow(self) -> bool:
        """Side-effect-free preview of `allow()`: True if a request
        issued now would be admitted. Unlike `allow()` this never
        consumes a HALF_OPEN probe slot and never bumps the shed stat,
        so it is safe to call from health checks, gauges, and routing
        filters. The dispatch path must still call `allow()` (paired
        with record_success/record_failure) on the one request it
        actually sends."""
        if self.failure_threshold <= 0:
            return True
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            return (self._state == HALF_OPEN
                    and self._probes_in_flight < self.half_open_probes)

    def release_probe(self):
        """Return a HALF_OPEN probe slot without recording a verdict —
        for an admitted request that ended in a way that says nothing
        about backend health (e.g. the client sent a malformed
        request). No-op in every other state."""
        if self.failure_threshold <= 0:
            return
        with self._lock:
            if self._state == HALF_OPEN:
                self._probes_in_flight = max(
                    0, self._probes_in_flight - 1)

    def record_success(self):
        if self.failure_threshold <= 0:
            return
        with self._lock:
            self._consecutive_failures = 0
            if self._state == HALF_OPEN:
                self._probes_in_flight = max(
                    0, self._probes_in_flight - 1)
                self._transition(CLOSED)

    def record_failure(self):
        if self.failure_threshold <= 0:
            return
        with self._lock:
            if self._state == HALF_OPEN:
                # the probe failed: straight back to OPEN for a fresh
                # cooldown
                self._probes_in_flight = max(
                    0, self._probes_in_flight - 1)
                self._consecutive_failures = self.failure_threshold
                self._transition(OPEN)
                return
            self._consecutive_failures += 1
            if self._state == CLOSED and \
                    self._consecutive_failures >= self.failure_threshold:
                self._transition(OPEN)

    def retry_after_s(self) -> float:
        """Seconds until an OPEN breaker will admit probes (the
        Retry-After header value); 0 when not OPEN."""
        with self._lock:
            if self._state != OPEN:
                return 0.0
            remaining = self.cooldown_ms / 1000.0 - (
                self._clock() - self._opened_at)
            return max(0.0, remaining)
