"""Process-global runtime stats registry: counters, gauges, histograms.

The JAX package's `monitor.py`, kept in this package so that nothing
here imports `paddle_tpu`: the same STAT_* surface, stat names,
histogram buckets, host phases, flight recorder, snapshots, exporters
(append-mode JSONL, Prometheus text, chrome-trace events) and the same
FLAGS_enable_monitor gate. The executor, the serving engine, the batcher
and the generation engine record into it.

Near-zero cost when disabled: every STAT_* entry point checks
FLAGS_enable_monitor through a cached flag handle (one attribute read)
before doing any work.

Stat names are dotted lowercase (`executor.step_seconds`); their
descriptions come from the inventory in docs/observability.md. The
Prometheus text ends with the SLO alert engine's ALERTS series
(`monitor_alerts.py`).
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Optional

__all__ = ["STAT_ADD", "STAT_SET", "STAT_OBSERVE", "STAT_RESET",
           "enabled", "reset_stats", "reset_phases", "get_stats_snapshot",
           "get_phase_stats", "phase_events", "phase", "push_phase",
           "pop_phase",
           "snapshot_to_jsonl", "prometheus_text", "export_prometheus",
           "export_chrome_tracing", "start_exporter", "stop_exporter",
           "flight_enabled", "flight_record", "flight_step",
           "flight_records", "reset_flight_recorder",
           "dump_flight_recorder", "install_flight_recorder",
           "serve_prometheus", "stop_prometheus",
           "DEFAULT_TIME_BUCKETS"]

# Fixed histogram buckets (upper bounds, seconds): 100us..120s covers a
# feed copy on one end and a first step on the other. The overflow
# bucket is implicit (+inf).
DEFAULT_TIME_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

_LOCK = threading.Lock()
_COUNTERS: Dict[str, float] = {}
_GAUGES: Dict[str, float] = {}
_HISTS: Dict[str, "_Histogram"] = {}
# Host-phase aggregates (record_event scopes). Separate namespace from
# the STAT registry: phase names are user-provided annotations, not
# inventory-controlled stat names.
_PHASES: Dict[str, Dict[str, float]] = {}
# Recent phase events for chrome-trace export (bounded ring).
_EVENTS: "deque" = deque(maxlen=20000)
_TLS = threading.local()

_flag = None


def enabled() -> bool:
    """FLAGS_enable_monitor, read through a cached flag handle (the
    disabled fast path: one None-check + one attribute read)."""
    global _flag
    f = _flag
    if f is None:
        from .core.flags import flag_handle
        f = _flag = flag_handle("enable_monitor")
    return f.value


class _Histogram:
    __slots__ = ("buckets", "counts", "count", "sum", "min", "max",
                 "exemplars")

    def __init__(self, buckets):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +1 overflow
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        # bucket index -> last exemplar (a trace_id): a slow-bucket hit
        # in the snapshot points straight at a kept trace to pull up.
        self.exemplars: Dict[int, str] = {}

    def observe(self, v, exemplar=None):
        v = float(v)
        i = 0
        for b in self.buckets:
            if v <= b:
                break
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if exemplar is not None:
            self.exemplars[i] = exemplar

    def percentile(self, q):
        """Estimate from bucket counts: linear interpolation inside the
        target bucket; the overflow bucket clamps to the observed max."""
        if self.count == 0:
            return None
        target = q * self.count
        cum = 0
        lo = 0.0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c > 0:
                hi = self.buckets[i] if i < len(self.buckets) else self.max
                frac = (target - cum) / c
                return min(lo + (hi - lo) * frac, self.max)
            cum += c
            lo = self.buckets[i] if i < len(self.buckets) else self.max
        return self.max

    def to_dict(self):
        b = {}
        for i, c in enumerate(self.counts):
            le = repr(self.buckets[i]) if i < len(self.buckets) else "+inf"
            b[le] = c
        d = {"count": self.count, "sum": self.sum,
             "min": self.min if self.count else None,
             "max": self.max if self.count else None,
             "p50": self.percentile(0.50),
             "p95": self.percentile(0.95),
             "buckets": b}
        if self.exemplars:
            d["exemplars"] = {
                (repr(self.buckets[i]) if i < len(self.buckets)
                 else "+inf"): ex
                for i, ex in sorted(self.exemplars.items())}
        return d


# ---------------------------------------------------------------------------
# Recording API (the STAT_ADD/STAT_RESET surface of platform/monitor.h)
# ---------------------------------------------------------------------------

def STAT_ADD(name: str, value=1):
    """Add to a monotonically-increasing counter (creates on first use)."""
    if not enabled():
        return
    with _LOCK:
        if name in _GAUGES or name in _HISTS:
            raise ValueError(f"stat {name!r} is not a counter")
        _COUNTERS[name] = _COUNTERS.get(name, 0) + value


def STAT_SET(name: str, value):
    """Set a gauge to the latest sampled value."""
    if not enabled():
        return
    with _LOCK:
        if name in _COUNTERS or name in _HISTS:
            raise ValueError(f"stat {name!r} is not a gauge")
        _GAUGES[name] = float(value)


def STAT_OBSERVE(name: str, value, buckets=None, exemplar=None):
    """Record one observation into a fixed-bucket histogram. `buckets`
    (upper bounds, ascending) only applies at first creation; default is
    DEFAULT_TIME_BUCKETS (seconds-oriented). `exemplar` (typically a
    trace_id) is remembered as the last exemplar of the bucket the
    value lands in and surfaces in get_stats_snapshot()."""
    if not enabled():
        return
    with _LOCK:
        if name in _COUNTERS or name in _GAUGES:
            raise ValueError(f"stat {name!r} is not a histogram")
        h = _HISTS.get(name)
        if h is None:
            h = _HISTS[name] = _Histogram(buckets or DEFAULT_TIME_BUCKETS)
        h.observe(value, exemplar=exemplar)


def STAT_RESET(name: Optional[str] = None):
    """Reset one stat (or every stat when name is None). Reference:
    monitor.h STAT_RESET."""
    with _LOCK:
        if name is None:
            _COUNTERS.clear()
            _GAUGES.clear()
            _HISTS.clear()
        else:
            _COUNTERS.pop(name, None)
            _GAUGES.pop(name, None)
            _HISTS.pop(name, None)


def reset_stats(name: Optional[str] = None):
    STAT_RESET(name)


# ---------------------------------------------------------------------------
# Host-phase accounting (profiler.record_event feeds this)
# ---------------------------------------------------------------------------

def push_phase(name: str):
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    # [name, wall-clock start (us), perf start, child time accumulator]
    stack.append([name, time.time() * 1e6, time.perf_counter(), 0.0])


def pop_phase(name: Optional[str] = None):
    stack = getattr(_TLS, "stack", None)
    if not stack:
        return  # unbalanced pop (e.g. reset mid-scope): ignore
    nm, wall_us, start, child = stack.pop()
    total = time.perf_counter() - start
    exclusive = total - child
    if stack:
        stack[-1][3] += total
    with _LOCK:
        agg = _PHASES.setdefault(
            nm, {"count": 0, "total_s": 0.0, "exclusive_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += total
        agg["exclusive_s"] += exclusive
        _EVENTS.append((nm, wall_us, total * 1e6,
                        threading.get_ident()))


@contextlib.contextmanager
def phase(name: str):
    """Scoped host-phase timer. Nested scopes accumulate EXCLUSIVE time
    per phase (a parent's aggregate excludes time spent in children),
    as a profiler's self-time columns."""
    push_phase(name)
    try:
        yield
    finally:
        pop_phase(name)


def get_phase_stats() -> Dict[str, Dict[str, float]]:
    with _LOCK:
        return {k: dict(v) for k, v in _PHASES.items()}


def phase_events() -> list:
    """Point-in-time copy of the recent phase-event ring as
    (name, ts_us, dur_us, tid) tuples — trace.export_chrome_tracing
    merges these with request spans onto one timeline."""
    with _LOCK:
        return list(_EVENTS)


def reset_phases():
    with _LOCK:
        _PHASES.clear()
        _EVENTS.clear()


# ---------------------------------------------------------------------------
# Flight recorder: a bounded ring of per-step records (step index, cache
# hit/miss, timings, stat deltas, NaN provenance) kept in memory and
# dumped as JSONL when the process dies — the crash "black box" the
# aggregate snapshots cannot provide (a counter says HOW MANY NaN trips;
# the flight recorder says WHICH op on WHICH step). Gated by
# FLAGS_flight_recorder (default on: one dict append per step), separate
# from FLAGS_enable_monitor so post-mortems work on unmonitored runs.
# ---------------------------------------------------------------------------

_FLIGHT: "deque" = deque()
_FLIGHT_LOCK = threading.Lock()
_FLIGHT_PREV_COUNTERS: Dict[str, float] = {}
_flight_flag = None


def flight_enabled() -> bool:
    """FLAGS_flight_recorder through a cached flag handle (same
    disabled-fast-path discipline as enabled())."""
    global _flight_flag
    f = _flight_flag
    if f is None:
        from .core.flags import flag_handle
        f = _flight_flag = flag_handle("flight_recorder")
    return f.value


def flight_record(kind: str, **fields):
    """Append one record to the flight-recorder ring (oldest dropped
    past FLAGS_flight_recorder_capacity). Also counts
    `executor.flight_records` when the monitor is enabled."""
    if not flight_enabled():
        return
    from .core.flags import FLAGS
    rec = {"kind": kind, "ts": time.time(), **fields}
    with _FLIGHT_LOCK:
        cap = FLAGS.flight_recorder_capacity
        while cap > 0 and len(_FLIGHT) >= cap:
            _FLIGHT.popleft()
        _FLIGHT.append(rec)
    STAT_ADD("executor.flight_records")


def flight_step(**fields):
    """Record one executor step (Executor.run calls this). When the
    monitor is enabled the record also carries the delta of every
    counter since the previous step record, so a post-mortem shows what
    each step did (bytes fed, cache misses, NaN trips) not just that it
    ran."""
    if not flight_enabled():
        return
    if enabled():
        with _LOCK:
            cur = dict(_COUNTERS)
        with _FLIGHT_LOCK:
            prev = dict(_FLIGHT_PREV_COUNTERS)
            _FLIGHT_PREV_COUNTERS.clear()
            _FLIGHT_PREV_COUNTERS.update(cur)
        delta = {k: v - prev.get(k, 0) for k, v in cur.items()
                 if v != prev.get(k, 0)}
        if delta:
            fields["stats_delta"] = delta
    flight_record("step", **fields)


def flight_records() -> list:
    """Point-in-time copy of the ring (oldest first)."""
    with _FLIGHT_LOCK:
        return list(_FLIGHT)


def reset_flight_recorder():
    with _FLIGHT_LOCK:
        _FLIGHT.clear()
        _FLIGHT_PREV_COUNTERS.clear()


def _default_flight_path() -> str:
    from .core.flags import FLAGS
    return FLAGS.flight_recorder_path or "flight_recorder.jsonl"


def dump_flight_recorder(path: Optional[str] = None,
                         reason: str = "explicit") -> str:
    """Write the ring as JSONL: one `flight_dump` header record, then
    every ring record oldest-first (so the LAST line is the most recent
    completed step). Atomic (tmp + rename): a dump interrupted mid-write
    never leaves a half-written artifact over a previous good one.
    Returns the path written."""
    path = path or _default_flight_path()
    records = flight_records()
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(json.dumps({"kind": "flight_dump", "ts": time.time(),
                            "pid": os.getpid(), "reason": reason,
                            "n_records": len(records)}) + "\n")
        for rec in records:
            f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def install_flight_recorder(path: Optional[str] = None,
                            on_sigterm: bool = True):
    """Dump the flight recorder on unhandled exception (sys.excepthook,
    chained to the previous hook) and, by default, on SIGTERM (chained
    to any existing handler; installs an exiting default when none is
    set). Idempotent: a repeat install REPLACES the hook this module
    installed earlier (unwrapping to the original previous handler)
    instead of chaining to itself, so the dump is emitted exactly once
    per event no matter how many subsystems call this."""
    import sys

    prev_hook = sys.excepthook
    if getattr(prev_hook, "_ptt_flight_hook", False):
        prev_hook = prev_hook._ptt_prev

    def hook(tp, val, tb):
        try:
            dump_flight_recorder(path, reason=f"unhandled {tp.__name__}")
        except Exception:  # noqa: BLE001 — the dump must never mask
            pass           # the original crash
        prev_hook(tp, val, tb)

    hook._ptt_flight_hook = True
    hook._ptt_prev = prev_hook
    sys.excepthook = hook

    if on_sigterm:
        import signal
        prev_term = signal.getsignal(signal.SIGTERM)
        if getattr(prev_term, "_ptt_flight_hook", False):
            prev_term = prev_term._ptt_prev

        def on_term(signum, frame):
            try:
                dump_flight_recorder(path, reason=f"signal {signum}")
            except Exception:  # noqa: BLE001
                pass
            if callable(prev_term):
                prev_term(signum, frame)
            else:
                os._exit(128 + signum)

        on_term._ptt_flight_hook = True
        on_term._ptt_prev = prev_term

        try:
            signal.signal(signal.SIGTERM, on_term)
        except (ValueError, OSError):
            pass  # non-main thread / exotic platform


# ---------------------------------------------------------------------------
# Snapshots + exporters
# ---------------------------------------------------------------------------

def get_stats_snapshot() -> dict:
    """Point-in-time copy of every stat + phase aggregate (plain dict,
    JSON-serializable)."""
    with _LOCK:
        return {
            "ts": time.time(),
            "pid": os.getpid(),
            "counters": dict(_COUNTERS),
            "gauges": dict(_GAUGES),
            "histograms": {k: h.to_dict() for k, h in _HISTS.items()},
            "phases": {k: dict(v) for k, v in _PHASES.items()},
        }


def snapshot_to_jsonl(path: Optional[str] = None) -> str:
    """Append one snapshot line to a JSONL log (crash-safe: each line is
    flushed + fsynced, so a timed-out run still yields every snapshot
    written before the kill). Path defaults to FLAGS_monitor_export_path.
    Returns the path written."""
    if path is None:
        from .core.flags import FLAGS
        path = FLAGS.monitor_export_path
    if not path:
        raise ValueError(
            "no export path: pass one or set FLAGS_monitor_export_path")
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    rec = {"kind": "stats_snapshot", **get_stats_snapshot()}
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())
    return path


_HELP_CACHE: Optional[Dict[str, str]] = None


def _stat_help() -> Dict[str, str]:
    """Stat name -> one-line description, parsed (once) from the
    docs/observability.md inventory table — the docs are the single
    source of truth for descriptions, and the bidirectional lint already
    guarantees every recorded stat has a row there. Missing docs (e.g.
    an installed wheel without the docs tree) degrade to no HELP lines,
    never an error on the scrape path."""
    global _HELP_CACHE
    if _HELP_CACHE is not None:
        return _HELP_CACHE
    help_: Dict[str, str] = {}
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "docs", "observability.md")
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line.startswith("| `"):
                    continue
                cells = [c.strip() for c in line.strip("|").split("|")]
                if len(cells) < 3:
                    continue
                name = cells[0].strip("`")
                desc = cells[2].replace("`", "").replace("\\", "")
                if name and desc:
                    help_[name] = " ".join(desc.split())
    except OSError:
        pass
    _HELP_CACHE = help_
    return help_


def prometheus_text() -> str:
    """Prometheus text exposition format. Dotted stat names become
    underscore-joined metric names under the paddle_tpu_ prefix; HELP
    text comes from the docs/observability.md inventory."""
    def mname(name):
        return "paddle_tpu_" + name.replace(".", "_")

    help_ = _stat_help()
    out = []

    def header(name, m, mtype):
        desc = help_.get(name)
        if desc:
            out.append(f"# HELP {m} {desc}")
        out.append(f"# TYPE {m} {mtype}")

    snap = get_stats_snapshot()
    for name, v in sorted(snap["counters"].items()):
        m = mname(name)
        header(name, m, "counter")
        out.append(f"{m} {v}")
    for name, v in sorted(snap["gauges"].items()):
        m = mname(name)
        header(name, m, "gauge")
        out.append(f"{m} {v}")
    for name, h in sorted(snap["histograms"].items()):
        m = mname(name)
        header(name, m, "histogram")
        cum = 0
        for le, c in h["buckets"].items():
            cum += c
            # Exposition format requires +Inf (capital I) — the internal
            # snapshot key stays "+inf" for JSON stability.
            le_s = "+Inf" if le == "+inf" else repr(float(le))
            out.append(f'{m}_bucket{{le="{le_s}"}} {cum}')
        out.append(f"{m}_sum {h['sum']}")
        out.append(f"{m}_count {h['count']}")
    # Prometheus ALERTS series from the SLO engine (monitor_alerts.py),
    # so one scrape carries both the stats and the alert states. Lazy
    # import: monitor_alerts imports this module at its top level.
    try:
        from .monitor_alerts import prometheus_alerts_text
        alerts = prometheus_alerts_text()
    except Exception:  # noqa: BLE001 — the scrape path never fails
        alerts = ""
    if alerts:
        out.append(alerts.rstrip("\n"))
    return "\n".join(out) + "\n"


def export_prometheus(path: str) -> str:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(prometheus_text())
    os.replace(tmp, path)
    return path


_http_server = None
_http_lock = threading.Lock()


def serve_prometheus(port: Optional[int] = None):
    """Tiny stdlib scrape endpoint: GET anything on 127.0.0.1:<port>
    returns prometheus_text(). port=None reads FLAGS_monitor_http_port
    (0 = disabled, returns None); an explicit port always serves (0
    binds an ephemeral port — read it back from server_address).
    Runs on a daemon thread; counts `monitor.http_scrapes`. Returns the
    HTTPServer (already-running instance on repeat calls)."""
    global _http_server
    if port is None:
        from .core.flags import FLAGS
        port = FLAGS.monitor_http_port
        if not port:
            return None
    import http.server

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            STAT_ADD("monitor.http_scrapes")
            body = prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass  # scrapes must not spam stderr

    with _http_lock:
        if _http_server is not None:
            return _http_server
        srv = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                              _Handler)
        threading.Thread(target=srv.serve_forever,
                         name="ptt-monitor-http", daemon=True).start()
        _http_server = srv
        return srv


def stop_prometheus():
    global _http_server
    with _http_lock:
        if _http_server is not None:
            _http_server.shutdown()
            _http_server.server_close()
            _http_server = None


def export_chrome_tracing(path: str) -> int:
    """Dump recorded phase events as chrome://tracing JSON. Returns
    #events."""
    with _LOCK:
        events = list(_EVENTS)
    pid = os.getpid()
    trace = {"displayTimeUnit": "ms", "traceEvents": [
        {"name": nm, "ph": "X", "ts": ts_us, "dur": dur_us,
         "pid": pid, "tid": tid}
        for nm, ts_us, dur_us, tid in events]}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(events)


# ---------------------------------------------------------------------------
# Background exporter: periodic JSONL snapshots so even a run killed by
# a timeout leaves a usable log behind.
# ---------------------------------------------------------------------------

_exporter = None
_exporter_lock = threading.Lock()


class _Exporter(threading.Thread):
    def __init__(self, path, interval):
        super().__init__(name="ptt-monitor-exporter", daemon=True)
        self.path = path
        self.interval = interval
        self._stop = threading.Event()
        self._flush_lock = threading.Lock()
        self._flushed = False

    def run(self):
        while not self._stop.wait(self.interval):
            try:
                snapshot_to_jsonl(self.path)
            except OSError:
                pass  # transient FS trouble must not kill the thread

    def stop(self, flush=True):
        self._stop.set()
        if flush:
            # Exactly-once final flush: an explicit stop_exporter() plus
            # the atexit hook (or any racing double stop) must not write
            # the terminal snapshot twice.
            with self._flush_lock:
                if self._flushed:
                    return
                self._flushed = True
            try:
                snapshot_to_jsonl(self.path)
            except OSError:
                pass


def start_exporter(path: Optional[str] = None,
                   interval: Optional[float] = None):
    """Start (or return the running) background JSONL snapshot thread.
    Defaults: FLAGS_monitor_export_path / FLAGS_monitor_flush_interval_s.
    """
    global _exporter
    from .core.flags import FLAGS
    path = path or FLAGS.monitor_export_path
    if not path:
        raise ValueError(
            "no export path: pass one or set FLAGS_monitor_export_path")
    interval = interval or FLAGS.monitor_flush_interval_s
    try:
        serve_prometheus()  # FLAGS_monitor_http_port-gated (0 = no-op)
    except OSError:
        pass  # port in use must not kill the run being monitored
    with _exporter_lock:
        if _exporter is not None and _exporter.is_alive():
            return _exporter
        _exporter = _Exporter(path, interval)
        _exporter.start()
        import atexit
        atexit.register(stop_exporter)
        return _exporter


def stop_exporter(flush=True):
    global _exporter
    with _exporter_lock:
        if _exporter is not None:
            _exporter.stop(flush=flush)
            _exporter = None
