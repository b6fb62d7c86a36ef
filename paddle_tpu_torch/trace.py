"""Per-request tracing: spans from the batcher to the executor.

The JAX package's `trace.py`, kept in this package so that nothing here
imports `paddle_tpu`: the same span names, sampling rules, ring,
traceparent format and exports.

The monitor stack (monitor.py) answers "how is the fleet doing" —
counters, histograms, the flight recorder. This module answers "where
did THIS request spend its time": Dapper-style spans with W3C
traceparent propagation, carried across the serving stack's thread
hand-offs (DynamicBatcher submit -> worker flush, GenerationEngine
submit -> iteration loop) and dumped as JSONL or chrome://tracing JSON
that merges with the monitor's host-phase events.

Sampling is head + tail. The head decision (FLAGS_trace_sample) is made
once when a root span is created; spans are buffered per-trace either
way, and the tail rules get the final word at finish_trace(): errored
requests and requests slower than the rolling latency threshold
(FLAGS_trace_tail_slow_ms, or a rolling p95 when 0) are ALWAYS kept.
Kept traces land in a bounded in-process ring
(FLAGS_trace_ring_capacity); everything else is dropped and only
counted. This is the standard tail-based design: you cannot know a
request was slow until it finished, so you buffer cheaply and decide at
the end.

Propagation: contextvars carry the current span within a thread;
threads are crossed by stashing the Span object on the queue entry
(`_Request.span`, `_Queued.span`) and re-entering it with use_span()
on the worker side — contextvars do NOT follow objects across threads,
so every hand-off site does this explicitly.

Near-zero cost when disabled: every entry point checks
FLAGS_enable_trace through a cached flag handle (same discipline as
monitor.enabled()) and returns None; all APIs tolerate None spans, so
instrumented hot paths cost ~a function call when tracing is off.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import random
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import monitor
from .monitor import STAT_ADD, STAT_SET

__all__ = ["Span", "enabled", "start_span", "end_span", "record_span",
           "finish_trace", "is_root", "complete_request",
           "use_span", "span", "current_span",
           "current_trace_id", "parse_traceparent", "format_traceparent",
           "new_trace_id", "new_span_id", "ring_spans", "drain_spans",
           "export_jsonl", "export_chrome_tracing", "slow_threshold_ms",
           "reset"]

_flag = None


def enabled() -> bool:
    """FLAGS_enable_trace through a cached flag handle (one None-check +
    one attribute read on the disabled fast path)."""
    global _flag
    f = _flag
    if f is None:
        from .core.flags import flag_handle
        f = _flag = flag_handle("enable_trace")
    return f.value


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


# ---------------------------------------------------------------------------
# Span
# ---------------------------------------------------------------------------

class Span:
    """One timed operation in a trace. Times are wall-clock seconds at
    start plus a perf_counter duration (monotonic — a span is immune to
    clock steps mid-request). Mutated by one thread at a time by
    construction (the hand-off sites pass ownership with the object)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t_start",
                 "dur_ms", "attrs", "events", "links", "status", "tid",
                 "_perf0", "_done")

    def __init__(self, trace_id, span_id, parent_id, name,
                 t_start=None, perf0=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t_start = time.time() if t_start is None else t_start
        self._perf0 = time.perf_counter() if perf0 is None else perf0
        self.dur_ms = None
        self.attrs: Dict[str, object] = {}
        self.events: List[dict] = []
        self.links: List[dict] = []
        self.status = "ok"
        self.tid = threading.get_ident()
        self._done = False

    def set_attr(self, key, value):
        self.attrs[key] = value
        return self

    def add_event(self, name, **attrs):
        ev = {"name": name, "ts": time.time()}
        if attrs:
            ev.update(attrs)
        self.events.append(ev)
        return self

    def add_link(self, other: "Span"):
        """Cross-trace association (a batch span links every member
        request span without claiming parenthood over them)."""
        if other is not None:
            self.links.append({"trace_id": other.trace_id,
                               "span_id": other.span_id})
        return self

    def to_dict(self) -> dict:
        return {"kind": "span", "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "name": self.name, "t_start": self.t_start,
                "dur_ms": self.dur_ms, "status": self.status,
                "attrs": dict(self.attrs), "events": list(self.events),
                "links": list(self.links), "tid": self.tid}


class _Trace:
    """Per-trace buffer: every span of an in-flight trace, plus the head
    sampling decision, held until finish_trace() rules keep/drop."""

    __slots__ = ("trace_id", "root", "spans", "head_sampled")

    def __init__(self, trace_id, root, head_sampled):
        self.trace_id = trace_id
        self.root = root
        self.spans = [root]
        self.head_sampled = head_sampled


_LOCK = threading.Lock()
_ACTIVE: Dict[str, _Trace] = {}
_RING: "deque" = deque()
# Rolling e2e window for the tail "slower than usual" rule.
_LAT_WINDOW: "deque" = deque(maxlen=256)
_LAT_MIN_SAMPLES = 20

_CURRENT: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("paddle_tpu_torch_trace_span", default=None)


def current_span() -> Optional[Span]:
    return _CURRENT.get()


def current_trace_id() -> Optional[str]:
    """trace_id of the current span, or None — safe to call with tracing
    disabled (histogram-exemplar call sites use this unconditionally)."""
    s = _CURRENT.get()
    return s.trace_id if s is not None else None


# ---------------------------------------------------------------------------
# Creation / completion
# ---------------------------------------------------------------------------

def start_span(name: str, parent: Optional[Span] = None,
               attrs: Optional[dict] = None,
               remote: Optional[Tuple[str, str]] = None,
               t_start: Optional[float] = None) -> Optional[Span]:
    """Start a span. With no explicit parent, the contextvar current
    span is the parent; with neither, this starts a ROOT span (new
    trace) — the head-sampling decision is made here. `remote` is a
    (trace_id, parent_span_id) pair from an incoming traceparent header:
    the new span is a root locally (it owns finish_trace) but continues
    the caller's trace id. Returns None when tracing is disabled."""
    if not enabled():
        return None
    from .core.flags import FLAGS
    if parent is None and remote is None:
        parent = _CURRENT.get()
    if parent is not None:
        sp = Span(parent.trace_id, new_span_id(), parent.span_id, name,
                  t_start=t_start)
        with _LOCK:
            tr = _ACTIVE.get(parent.trace_id)
            if tr is not None:
                tr.spans.append(sp)
    else:
        if remote is not None:
            trace_id, parent_id = remote
        else:
            trace_id, parent_id = new_trace_id(), None
        sp = Span(trace_id, new_span_id(), parent_id, name,
                  t_start=t_start)
        head = random.random() < FLAGS.trace_sample
        with _LOCK:
            tr = _ACTIVE.get(trace_id)
            if remote is not None and tr is not None:
                # The "remote" parent lives in THIS process (in-process
                # router tier -> replica tier): the trace is already
                # active here, so joining must not steal its root —
                # record the hop as an ordinary child span and leave the
                # keep/drop decision with the owning root.
                tr.spans.append(sp)
            else:
                _ACTIVE[trace_id] = _Trace(trace_id, sp, head)
    if attrs:
        sp.attrs.update(attrs)
    STAT_ADD("trace.spans_started")
    return sp


def end_span(span: Optional[Span], error: Optional[str] = None,
             t_end: Optional[float] = None):
    """Close a span (idempotent; None-tolerant). `t_end` is a wall-clock
    override for retroactive closes; the default path uses the monotonic
    perf delta."""
    if span is None or span._done:
        return
    span._done = True
    if t_end is not None:
        span.dur_ms = max(0.0, (t_end - span.t_start) * 1e3)
    else:
        span.dur_ms = (time.perf_counter() - span._perf0) * 1e3
    if error:
        span.status = "error"
        span.attrs.setdefault("error", str(error)[:200])


def record_span(name: str, t_start: float, t_end: float,
                parent: Optional[Span],
                attrs: Optional[dict] = None) -> Optional[Span]:
    """Retroactively record an already-elapsed interval as a closed
    child span (wall-clock endpoints). This is how hot loops attribute
    sub-steps without contextvar churn: measure with plain perf
    counters, record once after the fact."""
    if not enabled() or parent is None:
        return None
    sp = start_span(name, parent=parent, attrs=attrs, t_start=t_start)
    end_span(sp, t_end=t_end)
    return sp


def finish_trace(root: Optional[Span], error: Optional[str] = None,
                 e2e_ms: Optional[float] = None,
                 record_latency: bool = True) -> bool:
    """Close the root span and apply the tail keep rules. Keep when the
    request errored, OR was slower than slow_threshold_ms(), OR won the
    head-sampling coin flip; kept traces move to the bounded ring,
    dropped ones are only counted. Returns the keep decision (False for
    None/unknown roots). Unclosed child spans are force-closed at the
    root's end so an exporter never sees dur_ms=None.
    `record_latency=False` keeps this trace's duration out of the
    rolling tail window (batch-scoped traces must not drag the
    request-latency threshold down)."""
    if root is None:
        return False
    end_span(root, error=error)
    if e2e_ms is None:
        e2e_ms = root.dur_ms
    root.attrs.setdefault("e2e_ms", round(e2e_ms, 3))
    from .core.flags import FLAGS
    with _LOCK:
        tr = _ACTIVE.get(root.trace_id)
        if tr is not None and tr.root is not root:
            # A same-process traceparent join (see start_span): this
            # span is a child of a trace whose root is still open —
            # closing it must not pop the owner's bookkeeping.
            return False
        _ACTIVE.pop(root.trace_id, None)
        thresh = _slow_threshold_locked(FLAGS)
        if record_latency:
            _LAT_WINDOW.append(e2e_ms)
    if tr is None:
        return False
    t_end = root.t_start + (root.dur_ms or 0.0) / 1e3
    for sp in tr.spans:
        if not sp._done:
            end_span(sp, t_end=t_end)
    slow = record_latency and thresh is not None and e2e_ms > thresh
    keep = bool(error) or slow or tr.head_sampled
    if keep:
        if error:
            root.attrs["keep"] = "error"
        elif slow:
            root.attrs["keep"] = "slow"
        else:
            root.attrs["keep"] = "head"
        with _LOCK:
            cap = FLAGS.trace_ring_capacity
            for sp in tr.spans:
                while cap > 0 and len(_RING) >= cap:
                    _RING.popleft()
                _RING.append(sp.to_dict())
            n = len(_RING)
        STAT_ADD("trace.spans_kept", len(tr.spans))
        STAT_SET("trace.ring_spans", n)
    else:
        STAT_ADD("trace.spans_dropped", len(tr.spans))
    return keep


def is_root(span: Optional[Span]) -> bool:
    """True when `span` is the registered root of an in-flight trace
    (i.e. the span whose completion must run the tail keep/drop rules)."""
    if span is None:
        return False
    with _LOCK:
        tr = _ACTIVE.get(span.trace_id)
        return tr is not None and tr.root is span


def complete_request(span: Optional[Span], error: Optional[str] = None,
                     e2e_ms: Optional[float] = None):
    """Request-completion choke point (called from `_Response._complete`
    — the one funnel every success AND failure path of the batcher and
    generation engine flows through). Ends the request span; when the
    span is its trace's root (no HTTP parent wrapping it) this also
    runs finish_trace so the tail sampling decision happens exactly
    once, at the outermost owner."""
    if span is None:
        return
    if is_root(span):
        finish_trace(span, error=error, e2e_ms=e2e_ms)
    else:
        end_span(span, error=error)


def _slow_threshold_locked(FLAGS) -> Optional[float]:
    if FLAGS.trace_tail_slow_ms > 0:
        return FLAGS.trace_tail_slow_ms
    if len(_LAT_WINDOW) < _LAT_MIN_SAMPLES:
        return None
    ordered = sorted(_LAT_WINDOW)
    return ordered[min(len(ordered) - 1, int(0.95 * len(ordered)))]


def slow_threshold_ms() -> Optional[float]:
    """Current tail 'slow' threshold: FLAGS_trace_tail_slow_ms when set,
    else a rolling p95 of recent e2e latencies (None until
    _LAT_MIN_SAMPLES requests have finished)."""
    from .core.flags import FLAGS
    with _LOCK:
        return _slow_threshold_locked(FLAGS)


# ---------------------------------------------------------------------------
# Context propagation
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def use_span(span: Optional[Span]):
    """Make `span` the contextvar-current span for the scope. This is
    the thread hand-off primitive: the submitting thread stashes the
    Span on the queue entry, the worker re-enters it here. No-op for
    None, so call sites need no enabled() guard."""
    if span is None:
        yield None
        return
    tok = _CURRENT.set(span)
    try:
        yield span
    finally:
        _CURRENT.reset(tok)


@contextlib.contextmanager
def span(name: str, attrs: Optional[dict] = None):
    """start_span + use_span + end_span in one scope; errors mark the
    span and re-raise."""
    sp = start_span(name, attrs=attrs)
    if sp is None:
        yield None
        return
    tok = _CURRENT.set(sp)
    try:
        yield sp
    except BaseException as e:  # noqa: BLE001 — status only; re-raised
        end_span(sp, error=f"{type(e).__name__}: {e}")
        raise
    finally:
        _CURRENT.reset(tok)
        end_span(sp)


# ---------------------------------------------------------------------------
# W3C traceparent (00-<trace_id>-<span_id>-<flags>)
# ---------------------------------------------------------------------------

def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) from a W3C traceparent header, or None for
    anything malformed (bad version, wrong field widths, non-hex,
    all-zero ids — per the spec these must be ignored, not propagated)."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    ver, trace_id, span_id, _flags = parts
    if len(ver) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    if ver == "ff":
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
        int(_flags, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(span: Span, sampled: bool = True) -> str:
    return f"00-{span.trace_id}-{span.span_id}-{'01' if sampled else '00'}"


# ---------------------------------------------------------------------------
# Ring access + export
# ---------------------------------------------------------------------------

def ring_spans() -> List[dict]:
    """Point-in-time copy of the kept-span ring (oldest first)."""
    with _LOCK:
        return list(_RING)


def spans_for_trace_ids(trace_ids) -> List[dict]:
    """Kept-ring spans belonging to any of `trace_ids`, ring order
    (oldest first). This is the exemplar -> incident-bundle linkage:
    a histogram exemplar in a breaching bucket is a trace_id, and the
    alert engine (monitor_alerts.py) pulls the full trace behind it
    into the bundle with this."""
    want = set(trace_ids)
    if not want:
        return []
    with _LOCK:
        return [s for s in _RING if s.get("trace_id") in want]


def drain_spans() -> List[dict]:
    """Copy-and-clear the ring (exporters call this so a periodic dump
    never writes a span twice)."""
    with _LOCK:
        out = list(_RING)
        _RING.clear()
    STAT_SET("trace.ring_spans", 0)
    return out


def export_jsonl(path: str, spans: Optional[List[dict]] = None) -> int:
    """Append kept spans as JSONL (one `kind="span"` record per line,
    same append-mode crash-safety contract as snapshot_to_jsonl).
    Defaults to drain_spans(). Returns #spans written."""
    if spans is None:
        spans = drain_spans()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        for sp in spans:
            f.write(json.dumps(sp) + "\n")
        f.flush()
        os.fsync(f.fileno())
    return len(spans)


def export_chrome_tracing(path: str,
                          spans: Optional[List[dict]] = None,
                          include_phases: bool = True) -> int:
    """Dump spans as chrome://tracing complete events, merged with the
    monitor's host-phase events (one timeline: request spans on their
    trace rows, host phases on their thread rows). Returns #events."""
    if spans is None:
        spans = ring_spans()
    pid = os.getpid()
    events = []
    for sp in spans:
        events.append({
            "name": sp["name"], "ph": "X",
            "ts": sp["t_start"] * 1e6,
            "dur": (sp["dur_ms"] or 0.0) * 1e3,
            "pid": pid, "tid": f"trace:{sp['trace_id'][:8]}",
            "args": {"trace_id": sp["trace_id"],
                     "span_id": sp["span_id"],
                     "parent_id": sp["parent_id"],
                     "status": sp["status"], **sp["attrs"]}})
    if include_phases:
        for nm, ts_us, dur_us, tid in monitor.phase_events():
            events.append({"name": nm, "ph": "X", "ts": ts_us,
                           "dur": dur_us, "pid": pid, "tid": tid})
    trace = {"displayTimeUnit": "ms", "traceEvents": events}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(events)


def reset():
    """Drop every in-flight trace, the kept ring, and the rolling
    latency window (tests)."""
    with _LOCK:
        _ACTIVE.clear()
        _RING.clear()
        _LAT_WINDOW.clear()
