"""Deterministic, seedable fault injection (FLAGS_fault_spec).

The JAX package's `resilience/faults.py`: the same grammar, sites and
decisions, so one spec and seed fire at the same invocations in both
packages.

The chaos layer of the resilience subsystem: a process-wide registry of
armed faults that the executor, reader, and serving/generation dispatch
loops consult at fixed hook points. With FLAGS_fault_spec empty (the
default) every hook is a cached None-check — zero overhead on the hot
path.

Spec grammar (comma-separated ``kind:param=value[:param=value]``)::

    step_nan:p=0.01            corrupt the host-side fetch copies of a
                               step with NaN (the device state is NOT
                               touched — models the classic "bad batch
                               poisons the loss" failure)
    slow_step:ms=500:p=0.1     sleep before dispatch (stuck-step /
                               straggler model; p defaults to 1)
    transient_fail:p=0.02      raise TransientFault BEFORE device
                               dispatch (flaky-transport / infeed model;
                               retry-safe by construction)
    preempt_at:step=40         deliver SIGTERM to this process when the
                               hook sees global step 40 (one-shot;
                               models a scheduler preemption notice)

Each kind also accepts ``at=N`` (fire exactly on the Nth invocation of
the hook site, 1-based — the deterministic form tests use instead of
``p=``) and ``site=NAME`` (restrict to one hook site: ``executor``,
``reader``, ``serving``, ``generation``, ``gen_prefill``).

Determinism: the fire/skip decision for invocation *n* of a site is a
pure function of (FLAGS_fault_seed, site, kind, n) — timing and thread
interleaving cannot change which steps fault, so a chaos run is
replayable.

Hook points call :func:`injector` (returns None when no spec is armed)
then ``inj.pre_step(site, step=...)`` before dispatch and
``inj.corrupt_fetches(site, arrays)`` on the host-side fetch copies.
"""
from __future__ import annotations

import hashlib
import signal
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.flags import FLAGS
from ..monitor import STAT_ADD, flight_record

__all__ = ["TransientFault", "FaultSpecError", "FaultInjector",
           "injector", "parse_fault_spec", "reset_injector"]

_KINDS = ("step_nan", "slow_step", "transient_fail", "preempt_at")
_SITES = ("executor", "reader", "serving", "generation", "gen_prefill")


class TransientFault(RuntimeError):
    """A failure that is expected to succeed on retry (flaky transport,
    injected chaos, non-finite outputs from a recoverable glitch).
    The retryable side of the retry.py taxonomy."""


class FaultSpecError(ValueError):
    """FLAGS_fault_spec does not parse."""


class _Spec:
    __slots__ = ("kind", "p", "at", "ms", "step", "site")

    def __init__(self, kind: str, p: float = 0.0, at: int = 0,
                 ms: float = 0.0, step: int = -1,
                 site: Optional[str] = None):
        self.kind = kind
        self.p = p        # fire probability per invocation
        self.at = at      # fire exactly on the at-th invocation (1-based)
        self.ms = ms      # slow_step sleep duration
        self.step = step  # preempt_at global step
        self.site = site  # restrict to one hook site (None = any)

    def __repr__(self):
        parts = [self.kind]
        if self.p:
            parts.append(f"p={self.p}")
        if self.at:
            parts.append(f"at={self.at}")
        if self.ms:
            parts.append(f"ms={self.ms}")
        if self.step >= 0:
            parts.append(f"step={self.step}")
        if self.site:
            parts.append(f"site={self.site}")
        return ":".join(parts)


def parse_fault_spec(spec: str) -> List[_Spec]:
    """Parse the FLAGS_fault_spec grammar; raises FaultSpecError with
    the offending fragment on malformed input."""
    out: List[_Spec] = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        fields = entry.split(":")
        kind = fields[0].strip()
        if kind not in _KINDS:
            raise FaultSpecError(
                f"unknown fault kind {kind!r} in {entry!r} "
                f"(known: {', '.join(_KINDS)})")
        s = _Spec(kind)
        for field in fields[1:]:
            if "=" not in field:
                raise FaultSpecError(
                    f"malformed param {field!r} in {entry!r} "
                    f"(expected name=value)")
            name, _, raw = field.partition("=")
            name = name.strip()
            raw = raw.strip()
            try:
                if name == "p":
                    s.p = float(raw)
                    if not 0.0 <= s.p <= 1.0:
                        raise ValueError
                elif name == "at":
                    s.at = int(raw)
                    if s.at < 1:
                        raise ValueError
                elif name == "ms":
                    s.ms = float(raw)
                    if s.ms < 0:
                        raise ValueError
                elif name == "step":
                    s.step = int(raw)
                    if s.step < 0:
                        raise ValueError
                elif name == "site":
                    if raw not in _SITES:
                        raise ValueError
                    s.site = raw
                else:
                    raise FaultSpecError(
                        f"unknown param {name!r} in {entry!r}")
            except (ValueError, TypeError):
                raise FaultSpecError(
                    f"bad value {raw!r} for {name!r} in {entry!r}") \
                    from None
        if s.kind == "preempt_at" and s.step < 0:
            raise FaultSpecError(
                f"preempt_at needs step=N (got {entry!r})")
        if s.kind == "slow_step" and s.ms <= 0:
            raise FaultSpecError(
                f"slow_step needs ms=D (got {entry!r})")
        if s.kind in ("step_nan", "transient_fail") \
                and not s.p and not s.at:
            raise FaultSpecError(
                f"{s.kind} needs p= or at= (got {entry!r})")
        out.append(s)
    return out


def _decide(seed: int, site: str, kind: str, n: int) -> float:
    """Uniform [0,1) draw that is a pure function of its arguments.
    md5 rather than hash() so the decision survives PYTHONHASHSEED."""
    h = hashlib.md5(f"{seed}:{site}:{kind}:{n}".encode()).digest()
    return int.from_bytes(h[:8], "big") / float(1 << 64)


class FaultInjector:
    """Armed faults + per-(site, kind) invocation counters. Thread-safe:
    serving workers and the training loop share one injector."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = seed
        self.specs = parse_fault_spec(spec)
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, str], int] = {}
        self._preempt_fired = False

    def _tick(self, site: str, kind: str) -> int:
        with self._lock:
            n = self._counters.get((site, kind), 0) + 1
            self._counters[(site, kind)] = n
            return n

    def _fires(self, s: _Spec, site: str) -> bool:
        if s.site is not None and s.site != site:
            return False
        n = self._tick(site, s.kind)
        if s.at:
            return n == s.at
        return _decide(self.seed, site, s.kind, n) < s.p

    # literal per-kind stat names (the observability doc lint requires
    # every documented name to exist as a string literal in code)
    _KIND_STATS = {"slow": "resilience.fault_slow",
                   "transient": "resilience.fault_transient",
                   "preempt": "resilience.fault_preempt",
                   "nan": "resilience.fault_nan"}

    def _record(self, kind: str, site: str, **fields):
        STAT_ADD("resilience.faults_injected")
        STAT_ADD(self._KIND_STATS[kind])
        flight_record("fault_injected", fault=kind, site=site, **fields)

    # -- hook points ----------------------------------------------------

    def pre_step(self, site: str, step: Optional[int] = None):
        """Called before device dispatch. May sleep (slow_step), raise
        TransientFault (transient_fail), or deliver SIGTERM to the
        process (preempt_at, one-shot)."""
        for s in self.specs:
            if s.kind == "slow_step":
                if s.site is not None and s.site != site:
                    continue
                # p=/at= gate the sleep; ungated slow_step fires every
                # invocation at matching sites
                if (s.p or s.at) and not self._fires(s, site):
                    continue
                self._record("slow", site, ms=s.ms)
                time.sleep(s.ms / 1000.0)
            elif s.kind == "transient_fail":
                if self._fires(s, site):
                    self._record("transient", site)
                    raise TransientFault(
                        f"injected transient fault at {site}")
            elif s.kind == "preempt_at" and step is not None:
                if s.site is not None and s.site != site:
                    continue
                if not self._preempt_fired and step == s.step:
                    self._preempt_fired = True
                    self._record("preempt", site, step=step)
                    signal.raise_signal(signal.SIGTERM)

    def corrupt_fetches(self, site: str,
                        arrays: List[np.ndarray]) -> bool:
        """Called on the HOST-side fetch copies after a step (a mutable
        list). step_nan pokes NaN into every float array — the
        device-side state is untouched, so a retry of the same step is
        clean. Returns True when a corruption was injected."""
        hit = False
        for s in self.specs:
            if s.kind != "step_nan":
                continue
            if self._fires(s, site):
                hit = True
        if hit:
            self._record("nan", site)
            for i, a in enumerate(arrays):
                if isinstance(a, np.ndarray) \
                        and np.issubdtype(a.dtype, np.floating) \
                        and a.size:
                    if not a.flags.writeable:
                        a = a.copy()
                        arrays[i] = a
                    a.reshape(-1)[0] = np.nan
        return hit


# Cached singleton keyed on the (spec, seed) pair so tests flipping
# FLAGS via set_flags get a fresh injector (with fresh counters) while
# steady-state callers pay one string compare.
_CACHE_LOCK = threading.Lock()
_CACHED: Tuple[Optional[str], int, Optional[FaultInjector]] = \
    (None, 0, None)


def injector() -> Optional[FaultInjector]:
    """The process-wide injector for the current FLAGS_fault_spec, or
    None when the spec is empty (the zero-overhead fast path)."""
    global _CACHED
    spec = FLAGS.fault_spec
    if not spec:
        if _CACHED[2] is not None:
            with _CACHE_LOCK:
                _CACHED = (None, 0, None)
        return None
    seed = FLAGS.fault_seed
    cached_spec, cached_seed, inj = _CACHED
    if inj is not None and cached_spec == spec and cached_seed == seed:
        return inj
    with _CACHE_LOCK:
        cached_spec, cached_seed, inj = _CACHED
        if inj is None or cached_spec != spec or cached_seed != seed:
            inj = FaultInjector(spec, seed)
            _CACHED = (spec, seed, inj)
        return inj


def reset_injector():
    """Drop the cached injector (tests: restart invocation counters
    without changing the spec)."""
    global _CACHED
    with _CACHE_LOCK:
        _CACHED = (None, 0, None)
