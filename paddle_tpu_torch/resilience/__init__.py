"""Resilience: fault injection, retry/backoff, circuit breaking and
the resilient training loop (TrainerGuard).

The JAX package's `resilience` modules, kept in this package so that
nothing here imports `paddle_tpu`:

- faults.py        deterministic seedable fault injection, gated by
                   FLAGS_fault_spec (off by default, zero overhead)
- retry.py         deadline-aware jittered-exponential RetryPolicy with
                   a transient-vs-poison error taxonomy
- breaker.py       CLOSED -> OPEN -> HALF_OPEN -> CLOSED circuit breaker
                   for the serving/generation dispatch path
- trainer_guard.py NaN-step rollback, SIGTERM checkpoint-and-exit,
                   stuck-step watchdog for training loops
"""
from .breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from .faults import (FaultInjector, FaultSpecError, TransientFault,
                     injector, parse_fault_spec, reset_injector)
from .retry import RetryExhausted, RetryPolicy, is_transient
from .trainer_guard import NanStepError, PreemptedError, TrainerGuard

__all__ = [
    "CLOSED", "HALF_OPEN", "OPEN", "CircuitBreaker",
    "FaultInjector", "FaultSpecError", "TransientFault",
    "injector", "parse_fault_spec", "reset_injector",
    "RetryExhausted", "RetryPolicy", "is_transient",
    "NanStepError", "PreemptedError", "TrainerGuard",
]
