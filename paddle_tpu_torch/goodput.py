"""Run-level goodput accounting: an exclusive wall-clock ledger.

The JAX package's `goodput.py`, kept in this package so that nothing
here imports `paddle_tpu`: the same categories, stat names, invariant
and serving/generation busy-idle counters. Every second between
``start_run()`` and ``end_run()`` is attributed to exactly one category:

  device_compute    dispatched step execution after the first run
  compile           the first run of each prepared program
  input_wait        consumer blocked on the reader
  feed_stage        host->device staging of feeds
  fetch_sync        host blocking on fetch results (the wait for the card)
  checkpoint_save   durable checkpoint writes
  checkpoint_restore resume/restore
  retry_backoff     RetryPolicy backoff sleeps
  nan_rollback      in-memory rollback after a bad step
  preempt_drain     checkpoint-and-raise drain on a preemption signal
  probe_wait        backend probe wait
  other             residual (python glue, logging, snapshot copies)

In this package the executor enqueues a step's kernels eagerly, so its
"dispatch" (device_compute) is the host's enqueue and the wait for the
card lands in "fetch" (fetch_sync) when the fetches are copied to the
host.

``other`` is the residual ``wall - sum(attributed)`` at snapshot time,
clamped at zero: under-attribution lands in ``other`` by construction,
while double counting makes the category sum exceed wall-clock, which
``check_invariant`` catches. The goodput fraction is
``device_compute / wall``.

Everything is gated on ``FLAGS_enable_goodput`` via a cached flag handle;
stats ride the monitor registry, so ``FLAGS_enable_monitor`` also gates
the ``goodput.*`` stat surface.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, Optional

from .monitor import STAT_ADD, STAT_OBSERVE, STAT_SET

__all__ = [
    "CATEGORIES",
    "GoodputLedger",
    "start_run",
    "end_run",
    "active",
    "attribute",
    "note_input_wait",
    "snapshot",
    "check_invariant",
    "serving_busy",
    "serving_idle",
    "serving_pad_waste",
    "gen_busy",
    "gen_idle",
    "reset",
    "enabled",
]

CATEGORIES = (
    "device_compute",
    "compile",
    "input_wait",
    "feed_stage",
    "fetch_sync",
    "checkpoint_save",
    "checkpoint_restore",
    "retry_backoff",
    "nan_rollback",
    "preempt_drain",
    "probe_wait",
    "other",
)

# Literal stat names per category (the doc lint requires every documented
# stat name to exist as a string literal somewhere in the code corpus).
_CATEGORY_STATS = {
    "device_compute": "goodput.device_compute_seconds",
    "compile": "goodput.compile_seconds",
    "input_wait": "goodput.input_wait_seconds",
    "feed_stage": "goodput.feed_stage_seconds",
    "fetch_sync": "goodput.fetch_sync_seconds",
    "checkpoint_save": "goodput.checkpoint_save_seconds",
    "checkpoint_restore": "goodput.checkpoint_restore_seconds",
    "retry_backoff": "goodput.retry_backoff_seconds",
    "nan_rollback": "goodput.nan_rollback_seconds",
    "preempt_drain": "goodput.preempt_drain_seconds",
    "probe_wait": "goodput.probe_wait_seconds",
    "other": "goodput.other_seconds",
}

# Millisecond-oriented buckets for per-batch input wait: sub-ms queue pops
# up through multi-second stalls.
INPUT_WAIT_MS_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
)

# Cap on retained per-step waterfall records; the report only needs the
# worst-N, so a bounded deque keeps long runs O(1) in memory.
MAX_STEP_RECORDS = 4096

_flag = None


def enabled() -> bool:
    """Cheap cached check of FLAGS_enable_goodput (monitor.enabled idiom)."""
    global _flag
    f = _flag
    if f is None:
        from .core.flags import flag_handle

        f = _flag = flag_handle("enable_goodput")
    return f.value


def default_starvation_rule() -> str:
    """The default input-starvation burn-rate rule for FLAGS_alert_rules."""
    from .core.flags import FLAGS

    thresh = float(FLAGS.goodput_starved_ms)
    windows = FLAGS.goodput_alert_windows
    return ("input_starvation:burn:goodput.input_wait_ms:p50 > "
            "%g:windows=%s" % (thresh, windows))


def install_starvation_alert() -> str:
    """Append the default input_starvation rule to FLAGS_alert_rules.

    No-op when a rule named input_starvation is already configured, so
    operators can override the threshold/windows without fighting the
    default.  Returns the resulting rule string.
    """
    from .core.flags import FLAGS

    rules = FLAGS.alert_rules or ""
    if "input_starvation" in rules:
        return rules
    rule = default_starvation_rule()
    FLAGS.alert_rules = (rules + ";" + rule) if rules else rule
    return FLAGS.alert_rules


class GoodputLedger:
    """Thread-safe exclusive wall-clock ledger for one run."""

    def __init__(self, label: str = "run"):
        self.label = label
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._started_ts = time.time()
        self._end: Optional[float] = None
        self._cats: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        self._steps: collections.deque = collections.deque(
            maxlen=MAX_STEP_RECORDS)
        self._pending_input_wait = 0.0
        self._n_steps = 0
        self._n_compile_steps = 0
        self._n_input_batches = 0
        self._n_starved = 0

    # -- attribution --------------------------------------------------

    def add(self, category: str, seconds: float) -> None:
        if seconds <= 0.0:
            return
        if category not in self._cats:
            category = "other"
        with self._lock:
            self._cats[category] += seconds

    def category_seconds(self, category: str) -> float:
        with self._lock:
            return self._cats.get(category, 0.0)

    def input_wait(self, seconds: float) -> None:
        """Reader hook: one consumer-side batch wait (incl. fault stalls).

        Accumulates into the input_wait category, folds into the *next*
        step's waterfall record (training loops pull a batch, then run),
        and drives the starvation detector.
        """
        from .core.flags import FLAGS

        if seconds < 0.0:
            seconds = 0.0
        wait_ms = seconds * 1000.0
        with self._lock:
            self._cats["input_wait"] += seconds
            self._pending_input_wait += seconds
            self._n_input_batches += 1
            starved = wait_ms > float(FLAGS.goodput_starved_ms)
            if starved:
                self._n_starved += 1
        STAT_OBSERVE("goodput.input_wait_ms", wait_ms,
                     buckets=INPUT_WAIT_MS_BUCKETS)
        STAT_ADD("goodput.input_batches")
        if starved:
            STAT_ADD("goodput.input_starved_steps")

    def note_step(self, *, feed_s: float, dispatch_s: float, fetch_s: float,
                  total_s: float, build_s: float = 0.0,
                  first_run: bool = False, backoff_s: float = 0.0) -> None:
        """Executor hook: attribute one run() call's sub-step timings.

        ``backoff_s`` is retry-backoff sleep that happened inside the
        dispatch span; RetryPolicy attributes it directly, so it is
        subtracted here to keep the categories exclusive.
        """
        compute_s = max(0.0, dispatch_s - backoff_s)
        compile_s = max(0.0, build_s)
        if first_run:
            # The first run of a prepared program is warmup; count the
            # whole of it as compile rather than productive compute.
            compile_s += compute_s
            compute_s = 0.0
        glue_s = max(0.0, total_s - feed_s - dispatch_s - fetch_s - build_s)
        with self._lock:
            pend = self._pending_input_wait
            self._pending_input_wait = 0.0
            self._cats["feed_stage"] += max(0.0, feed_s)
            self._cats["fetch_sync"] += max(0.0, fetch_s)
            self._cats["device_compute"] += compute_s
            self._cats["compile"] += compile_s
            self._cats["other"] += glue_s
            step = self._n_steps
            self._n_steps += 1
            if first_run:
                self._n_compile_steps += 1
            self._steps.append({
                "step": step,
                "input_wait_s": round(pend, 6),
                "feed_s": round(max(0.0, feed_s), 6),
                "compile_s": round(compile_s, 6),
                "compute_s": round(compute_s, 6),
                "fetch_s": round(max(0.0, fetch_s), 6),
                "other_s": round(glue_s, 6),
                "total_s": round(max(0.0, total_s) + pend, 6),
                "first_run": bool(first_run),
            })

    # -- reporting ----------------------------------------------------

    def end(self) -> None:
        with self._lock:
            if self._end is None:
                self._end = time.perf_counter()

    def wall_seconds(self) -> float:
        with self._lock:
            end = self._end if self._end is not None else time.perf_counter()
            return max(0.0, end - self._t0)

    def snapshot(self) -> Dict[str, Any]:
        """Exclusive category table + invariant check + waterfall records.

        ``other`` picks up the non-negative residual so the categories sum
        to wall-clock when attribution is consistent; double counting makes
        the sum exceed wall and shows up in ``sum_frac_err``.
        """
        wall = self.wall_seconds()
        with self._lock:
            cats = dict(self._cats)
            steps = list(self._steps)
            n_steps = self._n_steps
            n_compile = self._n_compile_steps
            n_batches = self._n_input_batches
            n_starved = self._n_starved
        attributed = sum(cats.values())
        cats["other"] += max(0.0, wall - attributed)
        total = sum(cats.values())
        frac = (cats["device_compute"] / wall) if wall > 0 else 0.0
        err = abs(total - wall) / wall if wall > 0 else 0.0
        snap = {
            "kind": "goodput_snapshot",
            "ts": time.time(),
            "label": self.label,
            "wall_s": round(wall, 6),
            "goodput_frac": round(frac, 6),
            "sum_frac_err": round(err, 6),
            "categories": {c: round(cats[c], 6) for c in CATEGORIES},
            "steps": n_steps,
            "compile_steps": n_compile,
            "post_warmup_compiles": max(0, n_compile - 1),
            "input_batches": n_batches,
            "starved_steps": n_starved,
            "step_records": steps,
        }
        self._publish(snap)
        return snap

    def _publish(self, snap: Dict[str, Any]) -> None:
        for cat, name in _CATEGORY_STATS.items():
            STAT_SET(name, snap["categories"][cat])
        STAT_SET("goodput.wall_seconds", snap["wall_s"])
        STAT_SET("goodput.fraction", snap["goodput_frac"])


# -- process-global active ledger -------------------------------------

_ACTIVE: Optional[GoodputLedger] = None
_ACTIVE_LOCK = threading.Lock()


def start_run(label: str = "run") -> Optional[GoodputLedger]:
    """Install a fresh ledger when FLAGS_enable_goodput is on.

    Also appends the default input_starvation alert rule to
    FLAGS_alert_rules so the detector has a firing path.  Returns None
    (and installs nothing) when goodput is disabled, so callers can
    invoke this unconditionally.
    """
    global _ACTIVE
    if not enabled():
        return None
    install_starvation_alert()
    led = GoodputLedger(label=label)
    with _ACTIVE_LOCK:
        _ACTIVE = led
    return led


def end_run() -> Optional[Dict[str, Any]]:
    """Freeze the active ledger's wall-clock and return its snapshot."""
    led = _ACTIVE
    if led is None:
        return None
    led.end()
    return led.snapshot()


def reset() -> None:
    """Drop the active ledger (tests)."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = None


def active() -> Optional[GoodputLedger]:
    """The active ledger, or None when goodput is off / no run started."""
    if not enabled():
        return None
    return _ACTIVE


def attribute(category: str, seconds: float) -> None:
    """Attribute seconds to a category on the active ledger (no-op off)."""
    led = _ACTIVE
    if led is None or not enabled():
        return
    led.add(category, seconds)


def note_input_wait(seconds: float) -> None:
    """Reader-side hook: one batch wait, with starvation detection."""
    led = _ACTIVE
    if led is None or not enabled():
        return
    led.input_wait(seconds)


def snapshot() -> Optional[Dict[str, Any]]:
    led = _ACTIVE
    if led is None:
        return None
    return led.snapshot()


def check_invariant(snap: Dict[str, Any], tol: float = 0.05) -> bool:
    """True when category seconds sum to wall-clock within tolerance."""
    wall = float(snap.get("wall_s") or 0.0)
    if wall <= 0.0:
        return False
    total = sum(float(v) for v in (snap.get("categories") or {}).values())
    return abs(total - wall) / wall <= tol


# -- serving-side busy/idle goodput ------------------------------------
#
# Serving loops have no step ledger: goodput there is busy vs idle time
# plus pad waste (the slack baked into ladder-padded batches).  These are
# monotonic float-second counters on the monitor registry.


def serving_busy(seconds: float) -> None:
    if not enabled() or seconds <= 0.0:
        return
    STAT_ADD("goodput.serving_busy_seconds", seconds)


def serving_idle(seconds: float) -> None:
    if not enabled() or seconds <= 0.0:
        return
    STAT_ADD("goodput.serving_idle_seconds", seconds)


def serving_pad_waste(seconds: float) -> None:
    if not enabled() or seconds <= 0.0:
        return
    STAT_ADD("goodput.serving_pad_waste_seconds", seconds)


def gen_busy(seconds: float) -> None:
    if not enabled() or seconds <= 0.0:
        return
    STAT_ADD("goodput.gen_busy_seconds", seconds)


def gen_idle(seconds: float) -> None:
    if not enabled() or seconds <= 0.0:
        return
    STAT_ADD("goodput.gen_idle_seconds", seconds)
