"""SLO alerting over the monitor registry (the Monarch/Prometheus
alerting layer on top of monitor.py's point-in-time stats).

The JAX package's `monitor_alerts.py`, kept in this package so that
nothing here imports `paddle_tpu`: the same rule grammar, states, stat
names, incident bundle and ALERTS exposition.

Rules are declared in ``FLAGS_alert_rules`` (semicolon-separated) and
evaluated against ``monitor.get_stats_snapshot()`` — either by the
background evaluator thread (``maybe_start()``, period
``FLAGS_alert_eval_interval_s``) or explicitly via
``AlertEngine.evaluate_once(now=...)``, which tests drive with a fake
clock. Three rule kinds:

- ``name:threshold:STAT OP VALUE[:for=DUR]`` — a counter/gauge compared
  against a constant; with ``for=`` the breach must hold continuously
  (pending state) before the rule fires.
- ``name:ratio:NUM/DEN OP VALUE[:for=DUR]`` — the ratio of two counters
  (error rate = ``serving.rejected/serving.requests``); a zero
  denominator never breaches.
- ``name:burn:HIST:pQQ OP VALUE:windows=W1,W2[,...]`` — multi-window
  burn rate over a histogram percentile. Each tick appends the
  histogram's cumulative bucket counts to a per-rule history ring; the
  windowed percentile is computed over the COUNT DELTA between now and
  the newest sample at least W old. The rule breaches only when EVERY
  window breaches — a one-tick latency spike trips the short window but
  is diluted out of the long one, so only a sustained breach fires
  (classic multi-window burn-rate alerting). A window without full
  history coverage never breaches (cold-start guard).

State machine per rule: inactive -> pending (breach seen, ``for=`` not
yet satisfied) -> firing -> inactive (resolved). On the transition INTO
firing the engine writes exactly one **incident bundle** (when
``FLAGS_alert_bundle_dir`` is set): a single atomic JSON file
correlating the rule, the full stats snapshot, trace exemplars from the
breaching histogram buckets (breaching buckets first), the kept-trace
ring, and the flight-recorder ring — everything a post-mortem needs in
one artifact, written tmp+fsync+rename like dump_flight_recorder.

Exposure: ``alertz_dict()`` backs the serving front end's ``/alertz``
endpoint, ``prometheus_alerts_text()`` appends Prometheus
``ALERTS{alertname=...,alertstate=...}`` series to
``monitor.prometheus_text()``, ``firing_count()`` rides along in
``/healthz`` detail (alerts inform — they never flip health state).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .monitor import (STAT_ADD, STAT_SET, flight_records,
                      get_stats_snapshot)

__all__ = [
    "AlertEngine", "AlertRule", "parse_rules", "parse_duration",
    "maybe_start", "stop_alerts", "get_engine", "active_engine",
    "firing_count", "alertz_dict", "prometheus_alerts_text",
]

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


def parse_duration(s: str) -> float:
    """'30s' / '5m' / '1h' / bare seconds -> seconds (float)."""
    s = s.strip()
    if not s:
        raise ValueError("empty duration")
    mult = 1.0
    if s[-1] in "smh":
        mult = {"s": 1.0, "m": 60.0, "h": 3600.0}[s[-1]]
        s = s[:-1]
    return float(s) * mult


def _parse_cmp(expr: str):
    """'LHS OP VALUE' -> (lhs, op, value). Longest-op-first so '>='
    never parses as '>'."""
    for op in (">=", "<=", ">", "<"):
        if op in expr:
            lhs, rhs = expr.split(op, 1)
            return lhs.strip(), op, float(rhs.strip())
    raise ValueError(f"no comparison operator in {expr!r}")


class AlertRule:
    """One parsed rule. kind is 'threshold' | 'ratio' | 'burn'."""
    __slots__ = ("name", "kind", "stat", "num", "den", "pct", "op",
                 "value", "for_s", "windows_s", "expr")

    def __init__(self, name, kind, op, value, expr, stat=None, num=None,
                 den=None, pct=None, for_s=0.0, windows_s=()):
        self.name = name
        self.kind = kind
        self.op = op
        self.value = value
        self.expr = expr
        self.stat = stat
        self.num = num
        self.den = den
        self.pct = pct
        self.for_s = for_s
        self.windows_s = tuple(windows_s)

    def to_dict(self) -> dict:
        d = {"name": self.name, "kind": self.kind, "expr": self.expr,
             "op": self.op, "threshold": self.value}
        if self.kind == "burn":
            d["histogram"] = self.stat
            d["percentile"] = self.pct
            d["windows_s"] = list(self.windows_s)
        elif self.kind == "ratio":
            d["numerator"] = self.num
            d["denominator"] = self.den
        else:
            d["stat"] = self.stat
        if self.for_s:
            d["for_s"] = self.for_s
        return d


def parse_rules(spec: str) -> List["AlertRule"]:
    """Parse the FLAGS_alert_rules grammar. Raises ValueError with the
    offending rule text on any malformed entry."""
    rules: List[AlertRule] = []
    seen = set()
    for raw in (spec or "").split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = [p.strip() for p in raw.split(":")]
        if len(parts) < 3:
            raise ValueError(f"bad alert rule {raw!r}: expected "
                             "name:kind:expr[...]")
        name, kind = parts[0], parts[1]
        if not name or name in seen:
            raise ValueError(f"bad alert rule {raw!r}: empty or "
                             "duplicate rule name")
        seen.add(name)
        try:
            if kind == "threshold":
                lhs, op, value = _parse_cmp(parts[2])
                for_s = _parse_opts(parts[3:], raw, allow_for=True)
                rules.append(AlertRule(
                    name, kind, op, value, parts[2], stat=lhs,
                    for_s=for_s))
            elif kind == "ratio":
                lhs, op, value = _parse_cmp(parts[2])
                if "/" not in lhs:
                    raise ValueError("ratio needs NUM/DEN")
                num, den = (s.strip() for s in lhs.split("/", 1))
                for_s = _parse_opts(parts[3:], raw, allow_for=True)
                rules.append(AlertRule(
                    name, kind, op, value, parts[2], num=num, den=den,
                    for_s=for_s))
            elif kind == "burn":
                if len(parts) < 5:
                    raise ValueError(
                        "burn needs name:burn:HIST:pQQ OP V:windows=...")
                hist = parts[2]
                lhs, op, value = _parse_cmp(parts[3])
                if not lhs.startswith("p"):
                    raise ValueError(f"bad percentile {lhs!r}")
                pct = float(lhs[1:]) / 100.0
                if not 0.0 < pct <= 1.0:
                    raise ValueError(f"percentile out of range: {lhs}")
                windows = ()
                for opt in parts[4:]:
                    if opt.startswith("windows="):
                        windows = tuple(
                            parse_duration(w)
                            for w in opt[len("windows="):].split(","))
                    else:
                        raise ValueError(f"unknown option {opt!r}")
                if len(windows) < 1:
                    raise ValueError("burn rule needs windows=W1[,W2]")
                rules.append(AlertRule(
                    name, kind, op, value, raw, stat=hist, pct=pct,
                    windows_s=windows))
            else:
                raise ValueError(f"unknown rule kind {kind!r}")
        except ValueError as e:
            raise ValueError(f"bad alert rule {raw!r}: {e}") from None
    return rules


def _parse_opts(opts, raw, allow_for=False) -> float:
    for_s = 0.0
    for opt in opts:
        if allow_for and opt.startswith("for="):
            for_s = parse_duration(opt[len("for="):])
        else:
            raise ValueError(f"unknown option {opt!r}")
    return for_s


def _delta_percentile(bounds, counts_delta, q, max_hint):
    """monitor._Histogram.percentile over a windowed count delta.
    `bounds` excludes the overflow bucket; `max_hint` (the histogram's
    all-time max) stands in for the unknown window max when the target
    lands in overflow."""
    total = sum(counts_delta)
    if total <= 0:
        return None
    target = q * total
    cum = 0
    lo = 0.0
    for i, c in enumerate(counts_delta):
        hi = bounds[i] if i < len(bounds) else max_hint
        if cum + c >= target and c > 0:
            frac = (target - cum) / c
            return min(lo + (hi - lo) * frac, max_hint)
        cum += c
        lo = hi
    return max_hint


class _RuleState:
    __slots__ = ("state", "since", "fired_at", "resolved_at", "value",
                 "last_eval", "bundle_path", "windows")

    def __init__(self):
        self.state = "inactive"
        self.since = None        # first breach ts of the current episode
        self.fired_at = None
        self.resolved_at = None
        self.value = None        # last computed rule value
        self.last_eval = None
        self.bundle_path = None  # bundle of the current/last firing
        self.windows = None      # burn rules: per-window detail dict


class AlertEngine:
    """Evaluates a rule list against the live monitor registry. One
    engine per process (module singleton below); tests construct their
    own with a fake `clock`."""

    def __init__(self, rules: Optional[List[AlertRule]] = None,
                 clock=time.time):
        if rules is None:
            from .core.flags import FLAGS
            rules = parse_rules(FLAGS.alert_rules)
        self.rules = rules
        self._clock = clock
        self._lock = threading.Lock()
        self._state: Dict[str, _RuleState] = {
            r.name: _RuleState() for r in rules}
        # burn rules: rule name -> deque[(ts, counts_list, max_hint)]
        self._hist_history: Dict[str, deque] = {
            r.name: deque() for r in rules if r.kind == "burn"}

    # -- evaluation ------------------------------------------------------

    def evaluate_once(self, now: Optional[float] = None) -> dict:
        """One evaluation tick over a single registry snapshot. Returns
        the alertz dict (also what /alertz serves)."""
        now = self._clock() if now is None else now
        snap = get_stats_snapshot()
        with self._lock:
            for rule in self.rules:
                value, breach = self._eval_rule(rule, snap, now)
                st = self._state[rule.name]
                st.value = value
                st.last_eval = now
                if breach:
                    if st.state == "inactive":
                        st.since = now
                        if rule.for_s > 0:
                            st.state = "pending"
                        else:
                            self._fire(rule, st, snap, now)
                    elif st.state == "pending" and \
                            now - st.since >= rule.for_s:
                        self._fire(rule, st, snap, now)
                else:
                    if st.state == "firing":
                        st.resolved_at = now
                        STAT_ADD("alerts.resolved")
                    st.state = "inactive"
                    st.since = None
            firing = sum(1 for s in self._state.values()
                         if s.state == "firing")
            pending = sum(1 for s in self._state.values()
                          if s.state == "pending")
            out = self._to_dict_locked(now)
        STAT_ADD("alerts.evals")
        STAT_SET("alerts.firing", firing)
        STAT_SET("alerts.pending", pending)
        return out

    def _eval_rule(self, rule, snap, now):
        if rule.kind == "threshold":
            v = snap["gauges"].get(rule.stat)
            if v is None:
                v = snap["counters"].get(rule.stat)
            if v is None:
                return None, False
            return v, _OPS[rule.op](v, rule.value)
        if rule.kind == "ratio":
            num = snap["counters"].get(rule.num, 0)
            den = snap["counters"].get(rule.den, 0)
            if den <= 0:
                return None, False
            v = num / den
            return v, _OPS[rule.op](v, rule.value)
        return self._eval_burn(rule, snap, now)

    def _eval_burn(self, rule, snap, now):
        hist = snap["histograms"].get(rule.stat)
        history = self._hist_history[rule.name]
        if hist is None:
            history.clear()  # histogram was reset: old counts are stale
            self._state[rule.name].windows = None
            return None, False
        # buckets dict is insertion-ordered (bucket order, +inf last)
        counts = list(hist["buckets"].values())
        bounds = [float(k) for k in hist["buckets"] if k != "+inf"]
        max_hint = hist["max"] if hist["max"] is not None else 0.0
        if history and sum(counts) < sum(history[-1][1]):
            history.clear()  # STAT_RESET under us
        history.append((now, counts, max_hint))
        horizon = now - max(rule.windows_s) - 1.0
        while len(history) > 1 and history[1][0] <= horizon:
            history.popleft()
        windows = {}
        breach_all = True
        value = None
        for w in sorted(rule.windows_s):
            base = None
            for ts, c, _m in reversed(history):
                if ts <= now - w:
                    base = c
                    break
            if base is None:
                # no sample old enough: window lacks full coverage
                windows[f"{w:g}s"] = {"p": None, "covered": False}
                breach_all = False
                continue
            delta = [a - b for a, b in zip(counts, base)]
            p = _delta_percentile(bounds, delta, rule.pct, max_hint)
            breach = p is not None and _OPS[rule.op](p, rule.value)
            windows[f"{w:g}s"] = {"p": p, "covered": True,
                                  "breach": breach}
            if value is None:
                value = p  # report the shortest window's percentile
            if not breach:
                breach_all = False
        self._state[rule.name].windows = windows
        return value, breach_all and len(windows) > 0

    # -- firing + incident bundles ---------------------------------------

    def _fire(self, rule, st, snap, now):
        st.state = "firing"
        st.fired_at = now
        st.resolved_at = None
        STAT_ADD("alerts.fired")
        st.bundle_path = self._write_bundle(rule, st, snap, now)

    def _write_bundle(self, rule, st, snap, now) -> Optional[str]:
        """Exactly one atomic incident bundle per pending->firing
        transition. Returns the path, or None when bundling is off or
        the write failed (a bundle failure must never unwind the
        evaluator)."""
        from .core.flags import FLAGS
        d = FLAGS.alert_bundle_dir
        if not d:
            return None
        try:
            from . import trace
            exemplar_ids = self._breaching_exemplars(rule, snap)
            ring = trace.ring_spans()
            linked = trace.spans_for_trace_ids(exemplar_ids)
            linked_keys = {(s.get("trace_id"), s.get("span_id"))
                           for s in linked}
            cap = max(0, FLAGS.alert_bundle_max_spans)
            spans = list(linked)[:cap]
            # newest kept spans fill the remainder of the budget
            for sp in reversed(ring):
                if len(spans) >= cap:
                    break
                if (sp.get("trace_id"), sp.get("span_id")) \
                        not in linked_keys:
                    spans.append(sp)
            bundle = {
                "kind": "incident_bundle",
                "ts": now,
                "pid": os.getpid(),
                "rule": rule.to_dict(),
                "state": "firing",
                "value": st.value,
                "windows": st.windows,
                "snapshot": snap,
                "exemplar_trace_ids": exemplar_ids,
                "spans": spans,
                "n_spans_dropped": max(0, len(ring) - len(spans)),
                "flight_records": flight_records(),
            }
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"incident_{rule.name}_{int(now * 1000)}.json")
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(bundle, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            STAT_ADD("alerts.bundles_written")
            return path
        except Exception:  # noqa: BLE001 — alerting must not crash the
            STAT_ADD("alerts.bundle_errors")  # process it watches
            return None

    def _breaching_exemplars(self, rule, snap) -> List[str]:
        """Trace exemplars pulled from the rule's histogram, breaching
        buckets first (bounds above the threshold, worst first), then
        the rest — so the first ids in the bundle are requests that
        actually breached the SLO."""
        if rule.kind != "burn":
            return []
        hist = snap["histograms"].get(rule.stat)
        if not hist or "exemplars" not in hist:
            return []
        breaching, rest = [], []
        for key, ex in hist["exemplars"].items():
            bound = float("inf") if key == "+inf" else float(key)
            (breaching if bound > rule.value else rest).append(
                (bound, ex))
        out, seen = [], set()
        for _b, ex in (sorted(breaching, reverse=True) + sorted(rest)):
            if ex not in seen:
                seen.add(ex)
                out.append(ex)
        return out

    # -- exposure --------------------------------------------------------

    def _to_dict_locked(self, now) -> dict:
        rules = []
        for rule in self.rules:
            st = self._state[rule.name]
            r = rule.to_dict()
            r.update({"state": st.state, "value": st.value,
                      "since": st.since, "fired_at": st.fired_at,
                      "resolved_at": st.resolved_at,
                      "last_eval": st.last_eval})
            if st.windows is not None:
                r["window_detail"] = st.windows
            if st.bundle_path:
                r["bundle"] = st.bundle_path
            rules.append(r)
        return {"ts": now,
                "firing": sum(1 for s in self._state.values()
                              if s.state == "firing"),
                "pending": sum(1 for s in self._state.values()
                               if s.state == "pending"),
                "rules": rules}

    def to_dict(self) -> dict:
        with self._lock:
            return self._to_dict_locked(self._clock())

    def firing(self) -> List[str]:
        with self._lock:
            return [r.name for r in self.rules
                    if self._state[r.name].state == "firing"]

    def firing_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._state.values()
                       if s.state == "firing")

    def prometheus_text(self) -> str:
        """Prometheus ALERTS exposition: one series per non-inactive
        rule, matching what a Prometheus server derives from alerting
        rules — so dashboards built on ALERTS{} work unchanged."""
        out = []
        with self._lock:
            for rule in self.rules:
                st = self._state[rule.name]
                if st.state == "inactive":
                    continue
                out.append(
                    f'ALERTS{{alertname="{rule.name}",'
                    f'alertstate="{st.state}"}} 1')
        if not out:
            return ""
        return "\n".join(["# TYPE ALERTS gauge"] + out) + "\n"


# ---------------------------------------------------------------------------
# Module singleton + background evaluator
# ---------------------------------------------------------------------------

_ENGINE: Optional[AlertEngine] = None
_ENGINE_LOCK = threading.Lock()
_THREAD: Optional[threading.Thread] = None
_STOP = threading.Event()


def active_engine() -> Optional[AlertEngine]:
    """The running singleton, or None — never creates one (cheap enough
    for /healthz and scrape paths)."""
    return _ENGINE


def get_engine() -> Optional[AlertEngine]:
    """Singleton from FLAGS_alert_rules (None when no rules are set).
    Does not start the background thread — maybe_start() does."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is not None:
            return _ENGINE
        from .core.flags import FLAGS
        if not FLAGS.alert_rules:
            return None
        _ENGINE = AlertEngine()
        return _ENGINE


def maybe_start() -> Optional[AlertEngine]:
    """Idempotently start the background evaluator. No-op (returns
    None) when FLAGS_alert_rules is empty; with
    FLAGS_alert_eval_interval_s <= 0 the engine exists but only
    evaluates when evaluate_once() is called explicitly."""
    global _THREAD
    eng = get_engine()
    if eng is None:
        return None
    from .core.flags import FLAGS
    interval = FLAGS.alert_eval_interval_s
    with _ENGINE_LOCK:
        if interval > 0 and (_THREAD is None or not _THREAD.is_alive()):
            _STOP.clear()

            def loop():
                while not _STOP.wait(interval):
                    try:
                        eng.evaluate_once()
                    except Exception:  # noqa: BLE001 — keep evaluating
                        pass
            _THREAD = threading.Thread(
                target=loop, name="ptt-alert-eval", daemon=True)
            _THREAD.start()
    return eng


def stop_alerts():
    """Stop the evaluator thread and drop the singleton (tests call
    this between cases; flag changes take effect on the next start)."""
    global _ENGINE, _THREAD
    _STOP.set()
    t = _THREAD
    if t is not None and t.is_alive():
        t.join(timeout=5.0)
    with _ENGINE_LOCK:
        _ENGINE = None
        _THREAD = None


def firing_count() -> int:
    eng = _ENGINE
    return eng.firing_count() if eng is not None else 0


def alertz_dict() -> dict:
    """What /alertz serves. An engine-less process still answers with
    an empty rule list so probes need no special-casing."""
    eng = _ENGINE
    if eng is None:
        return {"ts": time.time(), "firing": 0, "pending": 0,
                "rules": []}
    return eng.to_dict()


def prometheus_alerts_text() -> str:
    eng = _ENGINE
    return eng.prometheus_text() if eng is not None else ""
