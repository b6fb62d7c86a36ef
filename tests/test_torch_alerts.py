"""The port's SLO alert engine (paddle_tpu_torch/monitor_alerts.py)
against the JAX package's (paddle_tpu/monitor_alerts.py).

Each scenario runs once through each package's monitor, alert engine,
trace ring and flags, on an injected clock (no sleep in an evaluation
path), and records what a caller sees: rule states and values tick by
tick, the alerts.* stats, the ALERTS exposition, /alertz's dict, and
the incident bundles' keys. The two records must be equal. Covered:
the rule grammar (every kind, every malformed case), threshold with
for= (inactive -> pending -> firing -> resolved -> a new episode),
ratio with a zero denominator, the multi-window burn rate (a spike does
not fire, a sustained breach does, recovery resolves, a stat reset
clears history), exactly one bundle per episode with breaching
exemplars first, a bundle failure that does not unwind the evaluation,
goodput.start_run installing the input_starvation rule, and the flags
these modules read, with the JAX package's defaults.
"""
import contextlib
import json
import types

import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu import goodput as jgood
from paddle_tpu import monitor as jmon
from paddle_tpu import monitor_alerts as jal
from paddle_tpu import trace as jtrace
from paddle_tpu.core import flags as jflags
from paddle_tpu_torch import goodput as tgood
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch import monitor_alerts as tal
from paddle_tpu_torch import trace as ttrace
from paddle_tpu_torch.core import flags as tflags

PKGS = {
    "jax": types.SimpleNamespace(monitor=jmon, alerts=jal, trace=jtrace,
                                 goodput=jgood, flags=jflags,
                                 FLAGS=fj.FLAGS, set_flags=fj.set_flags),
    "torch": types.SimpleNamespace(monitor=tmon, alerts=tal, trace=ttrace,
                                   goodput=tgood, flags=tflags,
                                   FLAGS=ft.FLAGS, set_flags=ft.set_flags),
}
# the flags monitor_alerts.py, goodput's alert hook, serving/http.py and
# profiler.py read, new in the port with this slice
NEW_FLAGS = ("serving_http_port", "profiler_trace_dir", "op_trace_scopes",
             "goodput_alert_windows", "alert_rules", "alert_eval_interval_s",
             "alert_bundle_dir", "alert_bundle_max_spans")
MS_BUCKETS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0)


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@contextlib.contextmanager
def _monitor_on(p, **flag_over):
    names = list(flag_over) + ["enable_monitor", "alert_rules"]
    prev = {k: getattr(p.FLAGS, k) for k in names}
    p.set_flags({"FLAGS_enable_monitor": True,
                 **{f"FLAGS_{k}": v for k, v in flag_over.items()}})
    p.monitor.reset_stats()
    p.monitor.reset_flight_recorder()
    try:
        yield p.monitor
    finally:
        p.alerts.stop_alerts()
        p.monitor.reset_stats()
        p.monitor.reset_flight_recorder()
        p.set_flags({f"FLAGS_{k}": v for k, v in prev.items()})


def _both(scenario, *args):
    """Run `scenario(pkg, *args)` for each package; the records must be
    equal. Returns the port's record."""
    got = {name: scenario(p, *args) for name, p in PKGS.items()}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _alert_counters(p):
    c = p.monitor.get_stats_snapshot()["counters"]
    g = p.monitor.get_stats_snapshot()["gauges"]
    return ({k: v for k, v in c.items() if k.startswith("alerts.")},
            {k: v for k, v in g.items() if k.startswith("alerts.")})


def _tick(eng):
    out = eng.evaluate_once()
    return [(r["name"], r["state"], r["value"], r.get("window_detail"))
            for r in out["rules"]] + [out["firing"], out["pending"]]


@pytest.mark.parametrize("name", NEW_FLAGS)
def test_flag_default_and_type_match_jax(name):
    j, t = jflags._REGISTRY[name], tflags._REGISTRY[name]
    assert t.default == j.default
    assert type(t.default) is type(j.default)


def test_parse_duration_and_rules_match():
    for s in ("30s", "5m", "1h", "2.5"):
        assert tal.parse_duration(s) == jal.parse_duration(s)
    spec = ("deep:threshold:serving.queue_depth > 100:for=30s;"
            "shed:ratio:serving.rejected/serving.requests >= 0.05;"
            "burny:burn:serving.e2e_ms:p99 > 250:windows=1m,10m")
    assert [r.to_dict() for r in tal.parse_rules(spec)] == \
        [r.to_dict() for r in jal.parse_rules(spec)]
    assert tal.parse_rules("") == [] and tal.parse_rules(None) == []


@pytest.mark.parametrize("bad", [
    "noexpr:threshold", "x:threshold:serving.queue_depth 100",
    "x:ratio:serving.rejected > 0.05", "x:burn:h:p99 > 1",
    "x:burn:h:q99 > 1:windows=1m", "x:burn:h:p150 > 1:windows=1m",
    "x:frobnicate:a > 1", "x:threshold:a > 1:unknown=2",
    "a:threshold:x > 1;a:threshold:y > 2", "",
])
def test_parse_rules_rejects_what_jax_rejects(bad):
    def outcome(mod):
        try:
            return [r.to_dict() for r in mod.parse_rules(bad)]
        except ValueError as e:
            return f"ValueError: {e}"
    assert outcome(tal) == outcome(jal)


def _threshold(p):
    rec = []
    with _monitor_on(p):
        clock = _Clock()
        eng = p.alerts.AlertEngine(p.alerts.parse_rules(
            "deep:threshold:t.depth > 10:for=30s"), clock=clock)
        rec.append(_tick(eng))                 # missing stat
        p.monitor.STAT_SET("t.depth", 50)
        rec.append(_tick(eng))                 # pending
        clock.t += 29
        rec.append(_tick(eng))
        clock.t += 1
        rec.append(_tick(eng))                 # firing
        rec.append((eng.firing(), eng.firing_count(),
                    eng.prometheus_text(), _alert_counters(p)))
        p.monitor.STAT_SET("t.depth", 3)
        rec.append(_tick(eng))                 # resolved
        rec.append((eng.prometheus_text(), _alert_counters(p)))
        p.monitor.STAT_SET("t.depth", 50)
        rec.append(_tick(eng))                 # a new episode: pending
        rec.append(eng.to_dict())
    return rec


def test_threshold_for_pending_firing_resolved():
    rec = _both(_threshold)
    assert [r[0][1] for r in rec[:4]] == ["inactive", "pending", "pending",
                                          "firing"]
    assert rec[4][2] == ('# TYPE ALERTS gauge\n'
                         'ALERTS{alertname="deep",alertstate="firing"} 1\n')


def _ratio(p):
    rec = []
    with _monitor_on(p):
        eng = p.alerts.AlertEngine(p.alerts.parse_rules(
            "shed:ratio:t.rej/t.req > 0.05"), clock=_Clock())
        rec.append(_tick(eng))                 # no traffic: den 0
        p.monitor.STAT_ADD("t.req", 100)
        p.monitor.STAT_ADD("t.rej", 3)
        rec.append(_tick(eng))
        p.monitor.STAT_ADD("t.rej", 7)
        rec.append(_tick(eng))                 # fires at once
        rec.append(_alert_counters(p))
    return rec


def test_ratio_and_zero_denominator():
    rec = _both(_ratio)
    assert [r[0][1] for r in rec[:3]] == ["inactive", "inactive", "firing"]


def _observe(p, n, ms, exemplar=None):
    for _ in range(n):
        p.monitor.STAT_OBSERVE("t.req_ms", ms, buckets=MS_BUCKETS,
                               exemplar=exemplar)


def _burn(p):
    rec = []
    rule = "slo:burn:t.req_ms:p99 > 100:windows=10s,60s"
    with _monitor_on(p):
        clock = _Clock()
        eng = p.alerts.AlertEngine(p.alerts.parse_rules(rule), clock=clock)
        _observe(p, 50, 400.0)
        rec.append(_tick(eng))                 # cold start: uncovered
        p.monitor.STAT_RESET("t.req_ms")
        eng = p.alerts.AlertEngine(p.alerts.parse_rules(rule), clock=clock)
        for _ in range(14):                    # 70 s of healthy traffic
            _observe(p, 50, 4.0)
            rec.append(_tick(eng))
            clock.t += 5
        _observe(p, 50, 4.0)                   # a one-tick spike
        _observe(p, 5, 400.0)
        clock.t += 5
        rec.append(_tick(eng))
        for _ in range(2):                     # sustained breach
            _observe(p, 50, 400.0)
            clock.t += 5
            rec.append(_tick(eng))
        for _ in range(14):                    # recovery
            _observe(p, 50, 4.0)
            clock.t += 5
            rec.append(_tick(eng))
        rec.append(_alert_counters(p))
        p.monitor.STAT_RESET("t.req_ms")       # counts go backwards
        _observe(p, 5, 400.0)
        clock.t += 5
        rec.append(_tick(eng))
    return rec


def test_burn_rate_spike_sustained_recovery_and_reset():
    rec = _both(_burn)
    states = [r[0][1] for r in rec[:-2]]
    assert states[15] == "inactive"            # the spike
    assert states[17] == "firing"              # sustained
    assert states[-1] == "inactive"            # recovered
    assert rec[-2][0]["alerts.fired"] == 1
    assert rec[-1][0][1] == "inactive"         # after the reset


def _bundles(p, tmp_path):
    rec = []
    d = tmp_path / p.alerts.__name__.split(".")[0]
    with _monitor_on(p, alert_bundle_dir=str(d)):
        clock = _Clock()
        eng = p.alerts.AlertEngine(p.alerts.parse_rules(
            "deep:threshold:t.depth > 10;"
            "slo:burn:t.req_ms:p50 > 100:windows=10s"), clock=clock)
        _observe(p, 3, 4.0, exemplar="good")
        eng.evaluate_once()
        clock.t += 10
        _observe(p, 20, 400.0, exemplar="slow-1")
        _observe(p, 20, 700.0, exemplar="slow-2")
        p.monitor.STAT_SET("t.depth", 50)
        eng.evaluate_once()
        for _ in range(3):                     # still firing: no rewrite
            clock.t += 5
            eng.evaluate_once()
        rec.append(len(list(d.glob("incident_deep_*.json"))))
        p.monitor.STAT_SET("t.depth", 0)       # resolve, then re-fire
        clock.t += 5
        eng.evaluate_once()
        p.monitor.STAT_SET("t.depth", 99)
        clock.t += 5
        eng.evaluate_once()
        rec.append(len(list(d.glob("incident_deep_*.json"))))
        rec.append(not list(d.glob("*.tmp.*")))
        for f in sorted(d.glob("incident_*.json")):
            b = json.loads(f.read_text())
            rec.append((f.name, sorted(b), b["kind"], b["rule"],
                        b["state"], b["value"], b["windows"],
                        b["exemplar_trace_ids"], b["ts"],
                        sorted(b["snapshot"])))
        rec.append(_alert_counters(p))
        rec.append(sorted(r.get("bundle", "").rsplit("/", 1)[-1]
                          for r in eng.to_dict()["rules"]))
    return rec


def test_bundle_once_per_episode_with_breaching_exemplars(tmp_path):
    rec = _both(_bundles, tmp_path)
    assert rec[0] == 1 and rec[1] == 2 and rec[2]
    burn = [r for r in rec[3:-2] if r[3]["name"] == "slo"]
    assert len(burn) == 1
    # breaching buckets first, the worst first
    assert burn[0][7] == ["slow-2", "slow-1", "good"]


def _bundle_failure(p, tmp_path):
    blocked = tmp_path / f"file_{p.alerts.__name__.split('.')[0]}"
    blocked.write_text("a file where the bundle dir should be")
    with _monitor_on(p, alert_bundle_dir=str(blocked / "sub")):
        eng = p.alerts.AlertEngine(p.alerts.parse_rules(
            "deep:threshold:t.depth > 10"), clock=_Clock())
        p.monitor.STAT_SET("t.depth", 50)
        return [_tick(eng), _alert_counters(p)]


def test_bundle_failure_never_unwinds_evaluation(tmp_path):
    rec = _both(_bundle_failure, tmp_path)
    assert rec[0][0][1] == "firing"
    assert rec[1][0]["alerts.bundle_errors"] == 1


def _singleton(p):
    rec = []
    with _monitor_on(p, alert_rules="deep:threshold:t.depth > 10",
                     alert_eval_interval_s=0.0):
        rec.append(sorted(p.alerts.alertz_dict()))   # no engine yet
        rec.append(p.alerts.firing_count())
        eng = p.alerts.maybe_start()
        rec.append(p.alerts.active_engine() is eng)
        p.monitor.STAT_SET("t.depth", 50)
        eng.evaluate_once(now=1000.0)
        rec.append(p.alerts.firing_count())
        rec.append(p.alerts.prometheus_alerts_text())
        text = p.monitor.prometheus_text()
        rec.append([ln for ln in text.splitlines() if "ALERTS" in ln])
        p.alerts.stop_alerts()
        rec.append(p.alerts.active_engine() is None)
        rec.append(p.alerts.prometheus_alerts_text())
    return rec


def test_singleton_and_prometheus_exposure():
    """monitor.prometheus_text carries the engine's ALERTS series (the
    JAX package's lazy import), and an engine-less process answers an
    empty /alertz."""
    rec = _both(_singleton)
    assert rec[5] == ['# TYPE ALERTS gauge',
                      'ALERTS{alertname="deep",alertstate="firing"} 1']


def _starvation(p):
    prev = {k: getattr(p.FLAGS, k)
            for k in ("enable_goodput", "alert_rules")}
    try:
        p.set_flags({"FLAGS_enable_goodput": True,
                     "FLAGS_alert_rules": ""})
        p.goodput.start_run("a")
        first = p.FLAGS.alert_rules
        p.goodput.start_run("b")                # no duplicate
        p.set_flags({"FLAGS_alert_rules":
                     "input_starvation:threshold:x > 1"})
        p.goodput.start_run("c")                # an operator's override
        return [first, p.goodput.default_starvation_rule(),
                p.FLAGS.alert_rules,
                p.alerts.parse_rules(first)[0].to_dict()]
    finally:
        p.goodput.end_run()
        p.goodput.reset()
        p.set_flags({f"FLAGS_{k}": v for k, v in prev.items()})


def test_goodput_start_run_installs_starvation_rule():
    rec = _both(_starvation)
    assert rec[0] == ("input_starvation:burn:goodput.input_wait_ms:p50 > "
                      "50:windows=15s,60s")
    assert rec[2] == "input_starvation:threshold:x > 1"
