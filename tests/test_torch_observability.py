"""The port's observability and resilience layer against the JAX
package's: flags, the monitor registry, tracing, goodput and the
resilience modules (faults, retry, breaker), plus the executor's hooks.

Each case runs the same operations through both packages where the
result has no clock in it (flags, stat kinds and histograms, the
Prometheus text, fault decisions, the retry taxonomy), and through the
port alone where it copies a case of tests/test_trace.py,
test_goodput.py or test_resilience.py. Wall-clock shares are taken on an
injected clock (`FakeClock`: every read of time.perf_counter/time.time
in the patched port modules advances it by a fixed step), so they are
exact and do not depend on how loaded the machine is.
"""
import contextlib
import json
import threading
import types

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu import goodput as jgood
from paddle_tpu import monitor as jmon
from paddle_tpu import resilience as jres
from paddle_tpu import trace as jtrace
from paddle_tpu.core import flags as jflags
from paddle_tpu_torch import executor as texec
from paddle_tpu_torch import goodput as tgood
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch import trace as ttrace
from paddle_tpu_torch.core import flags as tflags


# every flag the port defines; each must carry the JAX package's
# default and type
PORT_FLAGS = sorted(tflags._REGISTRY)
SLICE_FLAGS = (
    "enable_monitor", "enable_trace", "enable_goodput", "trace_sample",
    "trace_ring_capacity", "trace_tail_slow_ms", "monitor_export_path",
    "monitor_flush_interval_s", "monitor_http_port",
    "flight_recorder_capacity", "flight_recorder_path",
    "goodput_starved_ms",
    "fault_spec", "fault_seed", "retry_base_ms", "retry_max_ms",
    "retry_max_attempts", "serving_breaker_threshold",
    "serving_breaker_cooldown_ms", "serving_nan_guard",
    "gen_paged_kv", "gen_kv_block_size",
    "gen_kv_pool_blocks", "gen_kv_pool_bytes", "gen_spec_decode",
    "spec_decode_k", "spec_decode_ngram", "spec_decode_adaptive",
    "spec_adapt_low", "spec_adapt_high")

# the flags of the alert engine, the HTTP front end and the profiler
# (goodput.start_run appends a rule to FLAGS_alert_rules)
ENGINE_FLAGS = ("alert_rules", "alert_eval_interval_s", "alert_bundle_dir",
                "alert_bundle_max_spans", "goodput_alert_windows",
                "serving_http_port", "profiler_trace_dir",
                "op_trace_scopes")

PKGS = {
    "jax": types.SimpleNamespace(
        monitor=jmon, trace=jtrace, goodput=jgood, res=jres,
        flags=jflags, set_flags=fj.set_flags),
    "torch": types.SimpleNamespace(
        monitor=tmon, trace=ttrace, goodput=tgood, res=tres,
        flags=tflags, set_flags=ft.set_flags),
}


def reset_globals():
    """Flags of this slice to their defaults, and every process-global
    registry (stats, phases, flight ring, span ring, goodput ledger,
    fault injector) emptied, in both packages."""
    for p in PKGS.values():
        for name in SLICE_FLAGS + ENGINE_FLAGS + ("flight_recorder",):
            h = p.flags.flag_handle(name)
            h.value = h.default
        p.monitor.reset_stats()
        p.monitor.reset_phases()
        p.monitor.reset_flight_recorder()
        p.trace.reset()
        p.goodput.reset()
        p.res.reset_injector()


@pytest.fixture(autouse=True)
def _hygiene():
    reset_globals()
    yield
    reset_globals()


class FakeClock:
    """A clock that advances `step` seconds on every read, for
    time.perf_counter, time.monotonic and time.time alike (time = 1e9 +
    the same counter), and whose sleep advances it by the time slept.
    `view(step)` reads the same counter with a step of its own."""

    def __init__(self, step=1e-3, shared=None):
        self.step = step
        self._shared = shared if shared is not None else \
            {"t": 0.0, "lock": threading.Lock()}

    def view(self, step):
        return FakeClock(step, self._shared)

    def perf_counter(self):
        with self._shared["lock"]:
            self._shared["t"] += self.step
            return self._shared["t"]

    monotonic = perf_counter

    def time(self):
        return 1e9 + self.perf_counter()

    def sleep(self, s):
        with self._shared["lock"]:
            self._shared["t"] += s


@contextlib.contextmanager
def fake_clock(monkeypatch, *modules, step=1e-3):
    """Patch each module's `time` with one FakeClock; a (module, step)
    pair gets a view with that step."""
    clock = FakeClock(step)
    for m in modules:
        m, view = (m[0], clock.view(m[1])) if isinstance(m, tuple) \
            else (m, clock)
        monkeypatch.setattr(m, "time", view)
    yield clock


# --- flags ------------------------------------------------------------------

@pytest.mark.parametrize("name", PORT_FLAGS)
def test_flag_default_and_type_match_jax(name):
    t, j = tflags.flag_handle(name), jflags.flag_handle(name)
    assert t.ftype is j.ftype
    assert t.default == j.default
    assert type(t.default) is type(j.default)
    assert t.help


def test_slice_flags_are_all_defined():
    missing = [n for n in SLICE_FLAGS if n not in tflags._REGISTRY]
    assert not missing


def test_flags_read_the_same_environment(monkeypatch):
    env = {"FLAGS_enable_monitor": "1", "FLAGS_trace_sample": "0.25",
           "FLAGS_fault_spec": "transient_fail:at=2:site=executor",
           "FLAGS_fault_seed": "17", "FLAGS_gen_paged_kv": "false",
           "FLAGS_spec_decode_k": "6", "FLAGS_gen_kv_pool_bytes": "4096"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for p in PKGS.values():
        p.flags.reload_from_env()
    names = list(env)
    assert tflags.get_flags(names) == jflags.get_flags(names)
    assert tflags.FLAGS.trace_sample == 0.25
    assert tflags.FLAGS.gen_paged_kv is False


def test_flag_handle_is_live_and_unknown_names_raise():
    h = tflags.flag_handle("enable_trace")
    ft.set_flags({"FLAGS_enable_trace": True})
    assert h.value is True and ttrace.enabled()
    tflags.FLAGS.enable_trace = "0"
    assert h.value is False and not ttrace.enabled()
    with pytest.raises(KeyError):
        tflags.flag_handle("no_such_flag")
    with pytest.raises(ValueError):
        ft.set_flags({"FLAGS_no_such_flag": 1})


# --- monitor ----------------------------------------------------------------

def _record(p):
    p.monitor.STAT_ADD("executor.compile_cache_hit")
    p.monitor.STAT_ADD("executor.compile_cache_hit", 2)
    p.monitor.STAT_SET("serving.queue_depth", 7)
    for v in (0.00005, 0.003, 0.003, 0.2, 3.0, 500.0):
        p.monitor.STAT_OBSERVE("executor.step_seconds", v, exemplar="t1")
    for v in (0.5, 3.0, 70.0, 40000.0):
        p.monitor.STAT_OBSERVE("serving.e2e_ms", v,
                               buckets=(1.0, 10.0, 100.0))
    return p.monitor.get_stats_snapshot()


def test_monitor_disabled_records_nothing():
    for p in PKGS.values():
        assert not p.monitor.enabled()
        snap = _record(p)
        assert not snap["counters"] and not snap["gauges"] \
            and not snap["histograms"]


def test_monitor_snapshot_matches_jax():
    snaps = {}
    for name, p in PKGS.items():
        p.set_flags({"FLAGS_enable_monitor": True})
        snaps[name] = _record(p)
    for key in ("counters", "gauges", "histograms"):
        assert snaps["torch"][key] == snaps["jax"][key]
    h = snaps["torch"]["histograms"]["executor.step_seconds"]
    assert h["count"] == 6 and h["buckets"]["+inf"] == 1
    assert h["exemplars"]


@pytest.mark.parametrize("first,second", [
    ("STAT_ADD", "STAT_SET"), ("STAT_SET", "STAT_OBSERVE"),
    ("STAT_OBSERVE", "STAT_ADD")])
def test_monitor_one_kind_per_name(first, second):
    for p in PKGS.values():
        p.set_flags({"FLAGS_enable_monitor": True})
        getattr(p.monitor, first)("serving.batches", 1)
        with pytest.raises(ValueError):
            getattr(p.monitor, second)("serving.batches", 1)


def test_prometheus_text_matches_jax():
    texts = {}
    for name, p in PKGS.items():
        p.set_flags({"FLAGS_enable_monitor": True})
        _record(p)
        texts[name] = p.monitor.prometheus_text()
    assert texts["torch"] == texts["jax"]
    assert 'paddle_tpu_serving_e2e_ms_bucket{le="+Inf"} 4' in \
        texts["torch"]
    assert "# HELP paddle_tpu_executor_step_seconds" in texts["torch"]
    assert "ALERTS" not in texts["torch"]


def test_phases_are_exclusive_on_an_injected_clock(monkeypatch):
    with fake_clock(monkeypatch, tmon):
        with tmon.phase("outer"):
            for _ in range(3):
                tmon.push_phase("inner")
                tmon.pop_phase()
    ph = tmon.get_phase_stats()
    # every clock read ticks 1 ms: a push reads time() and
    # perf_counter(), a pop perf_counter(); an inner phase spans one
    # tick, the outer one its 3 inner phases' 9 reads and its own pop
    assert ph["inner"]["count"] == 3
    assert ph["inner"]["total_s"] == pytest.approx(3e-3)
    assert ph["outer"]["total_s"] == pytest.approx(10e-3)
    assert ph["outer"]["exclusive_s"] == pytest.approx(7e-3)
    assert len(tmon.phase_events()) == 4


def test_flight_recorder_ring_deltas_and_dump(tmp_path):
    ft.set_flags({"FLAGS_enable_monitor": True,
                  "FLAGS_flight_recorder_capacity": 3})
    for i in range(5):
        tmon.STAT_ADD("executor.feed_bytes", 8)
        tmon.flight_step(step=i, program="p")
    recs = tmon.flight_records()
    assert [r["step"] for r in recs] == [2, 3, 4]
    assert recs[-1]["stats_delta"]["executor.feed_bytes"] == 8
    path = tmon.dump_flight_recorder(str(tmp_path / "fr.jsonl"),
                                     reason="test")
    lines = [json.loads(x) for x in open(path)]
    assert lines[0]["kind"] == "flight_dump" and \
        lines[0]["n_records"] == 3
    assert lines[-1]["step"] == 4
    ft.set_flags({"FLAGS_flight_recorder": False})
    tmon.flight_step(step=9)
    assert len(tmon.flight_records()) == 3


def test_snapshot_jsonl_appends(tmp_path):
    ft.set_flags({"FLAGS_enable_monitor": True})
    tmon.STAT_ADD("serving.requests")
    path = str(tmp_path / "m.jsonl")
    tmon.snapshot_to_jsonl(path)
    tmon.snapshot_to_jsonl(path)
    recs = [json.loads(x) for x in open(path)]
    assert len(recs) == 2 and recs[0]["kind"] == "stats_snapshot"
    assert recs[1]["counters"]["serving.requests"] == 1
    with pytest.raises(ValueError):
        tmon.snapshot_to_jsonl()


# --- trace ------------------------------------------------------------------

def _trace_on(sample=1.0, tail_slow_ms=0.0, ring=8192, monitor=False):
    ft.set_flags({"FLAGS_enable_trace": True,
                  "FLAGS_trace_sample": sample,
                  "FLAGS_trace_tail_slow_ms": tail_slow_ms,
                  "FLAGS_trace_ring_capacity": ring,
                  "FLAGS_enable_monitor": monitor})


def test_disabled_tracing_is_inert():
    tr = ttrace
    assert tr.start_span("op") is None
    assert tr.current_span() is None and tr.current_trace_id() is None
    assert not tr.finish_trace(None)
    tr.complete_request(None)
    tr.end_span(None)
    with tr.use_span(None) as s:
        assert s is None
    with tr.span("op") as s:
        assert s is None
    assert tr.record_span("op", 0.0, 1.0, None) is None


TID, SID = "0af7651916cd43dd8448eb211c80319c", "b7ad6b7169203331"
TRACEPARENTS = [
    f"00-{TID}-{SID}-01", f"00-{TID.upper()}-{SID}-01", None, "",
    "garbage", f"00-{TID}-{SID}", f"00-{TID}-{SID}-01-extra",
    f"ff-{TID}-{SID}-01", f"00-{TID[:-2]}-{SID}-01",
    f"00-{TID}-{SID[:-1]}-01", f"00-{'z' * 32}-{SID}-01",
    f"00-{'0' * 32}-{SID}-01", f"00-{TID}-{'0' * 16}-01"]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_parse_traceparent_matches_jax(header):
    assert ttrace.parse_traceparent(header) == \
        jtrace.parse_traceparent(header)


def test_traceparent_roundtrip():
    _trace_on()
    root = ttrace.start_span("op")
    hdr = ttrace.format_traceparent(root)
    assert hdr == f"00-{root.trace_id}-{root.span_id}-01"
    assert ttrace.parse_traceparent(hdr) == (root.trace_id, root.span_id)
    ttrace.finish_trace(root)


def test_span_tree_context_and_events():
    _trace_on()
    tr = ttrace
    root = tr.start_span("root", attrs={"k": 1})
    assert root.parent_id is None and tr.is_root(root)
    with tr.use_span(root):
        assert tr.current_span() is root
        with tr.span("child", attrs={"j": 2}) as c:
            assert c.parent_id == root.span_id
            c.add_event("tick", n=3)
            with tr.span("grandchild") as g:
                assert g.parent_id == c.span_id
    assert c.events[0]["name"] == "tick" and c.events[0]["n"] == 3
    with pytest.raises(ValueError):
        with tr.use_span(root):
            with tr.span("boom"):
                raise ValueError("nope")
    assert tr.finish_trace(root)
    by_name = {s["name"]: s for s in tr.drain_spans()}
    assert set(by_name) == {"root", "child", "grandchild", "boom"}
    assert by_name["boom"]["status"] == "error"
    assert by_name["root"]["attrs"]["keep"] == "head"


def test_thread_handoff_propagation():
    _trace_on()
    root = ttrace.start_span("root")
    seen = {}

    def worker():
        seen["ambient"] = ttrace.current_span()
        with ttrace.use_span(root):
            child = ttrace.start_span("worker_op")
            ttrace.end_span(child)
            seen["child"] = child

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert seen["ambient"] is None
    assert seen["child"].parent_id == root.span_id
    ttrace.finish_trace(root)


def test_record_span_retroactive():
    _trace_on()
    root = ttrace.start_span("root")
    sp = ttrace.record_span("sub", 100.0, 100.25, root, attrs={"b": 8})
    assert sp.parent_id == root.span_id and sp.t_start == 100.0
    assert sp.dur_ms == pytest.approx(250.0)
    ttrace.finish_trace(root)


def test_tail_keep_rules_fixed_threshold():
    _trace_on(sample=0.0, tail_slow_ms=5.0)
    tr = ttrace
    assert not tr.finish_trace(tr.start_span("req"), e2e_ms=1.0)
    r = tr.start_span("req")
    assert tr.finish_trace(r, e2e_ms=50.0) and r.attrs["keep"] == "slow"
    r = tr.start_span("req")
    assert tr.finish_trace(r, error="boom", e2e_ms=0.1)
    assert r.attrs["keep"] == "error" and r.status == "error"
    assert [s["attrs"]["keep"] for s in tr.drain_spans()] == \
        ["slow", "error"]


def test_tail_rolling_p95_threshold():
    _trace_on(sample=0.0, tail_slow_ms=0.0)
    tr = ttrace
    assert tr.slow_threshold_ms() is None
    for _ in range(30):
        assert not tr.finish_trace(tr.start_span("req"), e2e_ms=10.0)
    assert tr.slow_threshold_ms() == pytest.approx(10.0)
    r = tr.start_span("req")
    assert tr.finish_trace(r, e2e_ms=100.0) and r.attrs["keep"] == "slow"
    assert not tr.finish_trace(tr.start_span("batch"), e2e_ms=0.01,
                               record_latency=False)
    assert tr.slow_threshold_ms() == pytest.approx(10.0)


def test_ring_capacity_bound_and_drain():
    _trace_on(ring=6)
    ids = []
    for _ in range(10):
        r = ttrace.start_span("req")
        ids.append(r.trace_id)
        ttrace.finish_trace(r)
    ring = ttrace.ring_spans()
    assert [s["trace_id"] for s in ring] == ids[4:]
    assert ttrace.drain_spans() == ring and ttrace.ring_spans() == []


def test_complete_request_root_vs_child():
    _trace_on()
    root = ttrace.start_span("outer")
    child = ttrace.start_span("gen.request", parent=root)
    ttrace.complete_request(child)
    assert child.dur_ms is not None and ttrace.is_root(root)
    assert ttrace.ring_spans() == []
    ttrace.complete_request(root, e2e_ms=3.0)
    spans = ttrace.drain_spans()
    assert {s["name"] for s in spans} == {"outer", "gen.request"}
    assert spans[0]["attrs"]["e2e_ms"] == 3.0


def test_trace_stats_counters():
    _trace_on(sample=0.0, tail_slow_ms=5.0, monitor=True)
    r = ttrace.start_span("req")
    ttrace.start_span("child", parent=r)
    ttrace.finish_trace(r, e2e_ms=50.0)
    ttrace.finish_trace(ttrace.start_span("req"), e2e_ms=0.1)
    snap = tmon.get_stats_snapshot()
    assert snap["counters"]["trace.spans_started"] == 3
    assert snap["counters"]["trace.spans_kept"] == 2
    assert snap["counters"]["trace.spans_dropped"] == 1
    assert snap["gauges"]["trace.ring_spans"] == 2.0


def test_exporters_jsonl_and_chrome(tmp_path):
    _trace_on()
    root = ttrace.start_span("req")
    with ttrace.use_span(root):
        with ttrace.span("work"):
            pass
    ttrace.finish_trace(root)
    jl = str(tmp_path / "spans.jsonl")
    assert ttrace.export_jsonl(jl, ttrace.ring_spans()) == 2
    assert all(json.loads(x)["kind"] == "span" for x in open(jl))
    ct = str(tmp_path / "trace.json")
    assert ttrace.export_chrome_tracing(ct, include_phases=False) == 2
    ev = json.load(open(ct))["traceEvents"][0]
    assert ev["ph"] == "X" and ev["args"]["trace_id"] == root.trace_id


# --- goodput ----------------------------------------------------------------

def _goodput_on(**flags):
    ft.set_flags({"FLAGS_enable_monitor": True,
                  "FLAGS_enable_goodput": True,
                  **{f"FLAGS_{k}": v for k, v in flags.items()}})


def test_goodput_disabled_is_total_noop():
    assert tgood.start_run("off") is None and tgood.active() is None
    tgood.attribute("device_compute", 1.0)
    tgood.note_input_wait(1.0)
    tgood.serving_busy(1.0)
    assert tgood.snapshot() is None and tgood.end_run() is None


def test_goodput_invariant_residual_vs_double_count(monkeypatch):
    _goodput_on()
    with fake_clock(monkeypatch, tgood):
        tgood.start_run("inv")
        snap = tgood.end_run()
    assert set(snap["categories"]) == set(tgood.CATEGORIES)
    assert snap["categories"]["other"] == pytest.approx(snap["wall_s"])
    assert tgood.check_invariant(snap)
    tgood.attribute("device_compute", 10.0 * snap["wall_s"])
    bad = tgood.snapshot()
    assert bad["sum_frac_err"] > 1.0 and not tgood.check_invariant(bad)


def test_goodput_starved_step_thresholds():
    _goodput_on(goodput_starved_ms=20.0)
    tgood.start_run("thresh")
    tgood.note_input_wait(0.001)
    tgood.note_input_wait(0.050)
    snap = tgood.end_run()
    assert (snap["input_batches"], snap["starved_steps"]) == (2, 1)
    c = tmon.get_stats_snapshot()["counters"]
    assert c["goodput.input_batches"] == 2
    assert c["goodput.input_starved_steps"] == 1


def test_goodput_serving_counters_feed_the_registry():
    _goodput_on()
    tgood.start_run("serve")
    for fn, v in (("serving_busy", 0.4), ("serving_idle", 0.6),
                  ("serving_pad_waste", 0.1), ("gen_busy", 0.2),
                  ("gen_idle", 0.3)):
        getattr(tgood, fn)(v)
        assert tmon.get_stats_snapshot()["counters"][
            f"goodput.{fn}_seconds"] == pytest.approx(v)


def test_goodput_start_run_replaces_ledger_and_end_run_freezes(monkeypatch):
    _goodput_on()
    with fake_clock(monkeypatch, tgood) as clock:
        first = tgood.start_run("a")
        second = tgood.start_run("b")
        assert tgood.active() is second and second is not first
        clock.sleep(2.0)
        snap = tgood.end_run()
        clock.sleep(5.0)
        assert snap["label"] == "b" and 2.0 < snap["wall_s"] < 2.1
        assert tgood.snapshot()["wall_s"] == snap["wall_s"]


def test_goodput_retry_backoff_attribution():
    _goodput_on()
    tgood.start_run("retry")
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise tres.TransientFault("transient")
        return "ok"

    pol = tres.RetryPolicy(max_attempts=5, base_delay_ms=40.0,
                           max_delay_ms=40.0, sleep=lambda s: None)
    assert pol.call(flaky) == "ok"
    assert tgood.end_run()["categories"]["retry_backoff"] >= 0.04


def _affine_program():
    main, startup = ft.Program(), ft.Program()
    startup.random_seed = 3
    with ft.program_guard(main, startup), ft.unique_name.guard():
        x = ft.layers.data("x", shape=[-1, 3], dtype="float32",
                           append_batch_size=False)
        out = ft.layers.mean(ft.layers.fc(x, size=2))
    return main, startup, out


def _executor_run(monkeypatch, steps, input_wait_s=0.0):
    """Steps of a tiny program on the port executor under goodput, with
    the executor's and the ledger's clock injected; a nonzero
    `input_wait_s` puts a reader wait of that length before each
    step."""
    main, startup, out = _affine_program()
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    _goodput_on()
    with fake_clock(monkeypatch, tgood, texec) as clock:
        tgood.start_run("smoke")
        for _ in range(steps):
            if input_wait_s:
                clock.sleep(input_wait_s)
                tgood.note_input_wait(input_wait_s)
            exe.run(main, feed={"x": x}, fetch_list=[out], scope=scope)
        return tgood.end_run()


def test_goodput_clean_run_sums_to_wall_clock(monkeypatch):
    snap = _executor_run(monkeypatch, steps=8)
    assert snap["steps"] == 8 and tgood.check_invariant(snap, tol=0.05)
    assert snap["compile_steps"] == 1 and snap["post_warmup_compiles"] == 0
    assert snap["categories"]["compile"] > 0
    assert snap["categories"]["device_compute"] > 0
    assert 0.0 < snap["goodput_frac"] <= 1.0


def test_goodput_starved_run_input_wait_dominates(monkeypatch):
    # waits over FLAGS_goodput_starved_ms (50 ms) count as starved
    snap = _executor_run(monkeypatch, steps=8, input_wait_s=0.06)
    assert tgood.check_invariant(snap, tol=0.05)
    cats = snap["categories"]
    assert max(cats, key=cats.get) == "input_wait"
    assert cats["input_wait"] >= 0.5 * snap["wall_s"]
    assert snap["starved_steps"] == 8
    assert max(r["input_wait_s"] for r in snap["step_records"]) == \
        pytest.approx(0.06)


# --- resilience -------------------------------------------------------------

GOOD_SPECS = ["step_nan:p=0.01,slow_step:ms=500,transient_fail:p=0.02,"
              "preempt_at:step=40", "transient_fail:at=3:site=executor",
              "transient_fail:p=0.3:site=gen_prefill", ""]
BAD_SPECS = ["bogus_kind:p=0.1", "transient_fail", "slow_step:p=0.5",
             "preempt_at:p=0.5", "step_nan:p=1.5", "step_nan:at=0",
             "transient_fail:p=0.1:site=gpu", "transient_fail:frobnicate"]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_fault_spec_matches_jax(spec):
    got = [repr(s) for s in tres.parse_fault_spec(spec)]
    assert got == [repr(s) for s in jres.parse_fault_spec(spec)]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_fault_spec_raises_in_both(spec):
    with pytest.raises(jres.FaultSpecError):
        jres.parse_fault_spec(spec)
    with pytest.raises(tres.FaultSpecError):
        tres.parse_fault_spec(spec)


def _fire_pattern(res, spec, seed, site, n=60):
    inj = res.FaultInjector(spec, seed=seed)
    out = []
    for _ in range(n):
        try:
            inj.pre_step(site)
            out.append(False)
        except res.TransientFault:
            out.append(True)
    return out


@pytest.mark.parametrize("spec,seed,site", [
    ("transient_fail:p=0.3", 123, "serving"),
    ("transient_fail:p=0.3", 124, "serving"),
    ("transient_fail:p=0.2", 7, "generation"),
    ("transient_fail:p=0.2:site=gen_prefill", 7, "gen_prefill"),
    ("transient_fail:p=0.5", 0, "executor"),
    ("transient_fail:at=4", 0, "executor")])
def test_fault_decisions_match_jax(spec, seed, site):
    got = _fire_pattern(tres, spec, seed, site)
    assert got == _fire_pattern(jres, spec, seed, site)
    assert any(got)


def test_fault_site_restriction_and_at():
    d = _fire_pattern(tres, "transient_fail:at=4", 0, "executor", n=10)
    assert d == [False] * 3 + [True] + [False] * 6
    e = tres.FaultInjector("transient_fail:p=1.0:site=serving")
    for _ in range(5):
        e.pre_step("executor")
    with pytest.raises(tres.TransientFault):
        e.pre_step("serving")


def test_step_nan_corrupts_the_same_invocations_as_jax():
    hits = {}
    for name, res in (("jax", jres), ("torch", tres)):
        inj = res.FaultInjector("step_nan:p=0.25", seed=5)
        pattern = []
        for _ in range(40):
            arrs = [np.ones(3, np.float32), np.arange(2)]
            pattern.append(inj.corrupt_fetches("serving", arrs))
            if pattern[-1]:
                assert np.isnan(arrs[0][0]) and arrs[1][0] == 0
        hits[name] = pattern
    assert hits["torch"] == hits["jax"] and any(hits["torch"])


ERRORS = [tres.TransientFault("x"), tres.RetryExhausted("x"),
          OSError("reset"), TimeoutError("stuck"), ValueError("bad"),
          TypeError("t"), KeyError("k"), AssertionError("no"),
          FloatingPointError("nan"), NotImplementedError("op"),
          RuntimeError("CUDA error: an illegal memory access")]


@pytest.mark.parametrize("err", ERRORS, ids=lambda e: type(e).__name__)
def test_is_transient_matches_jax(err):
    twin = {tres.TransientFault: jres.TransientFault,
            tres.RetryExhausted: jres.RetryExhausted}.get(type(err),
                                                          type(err))
    assert tres.is_transient(err) == jres.is_transient(twin("x"))


def test_a_cuda_error_is_not_transient():
    assert not tres.is_transient(RuntimeError("CUDA error: device-side "
                                              "assert triggered"))


def test_retry_policy_poison_fails_fast():
    calls = []

    def poison():
        calls.append(1)
        raise ValueError("malformed")

    with pytest.raises(ValueError):
        tres.RetryPolicy(max_attempts=5, sleep=lambda s: None).call(poison)
    assert len(calls) == 1


def test_retry_policy_transient_then_success():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise tres.TransientFault("glitch")
        return "ok"

    pol = tres.RetryPolicy(max_attempts=5, base_delay_ms=4.0,
                           sleep=slept.append)
    assert pol.call(flaky) == "ok"
    assert len(calls) == 3 and len(slept) == 2
    assert 0.002 <= slept[1] <= 0.008


def test_retry_policy_exhaustion_and_deadline():
    def always():
        raise tres.TransientFault("still down")

    with pytest.raises(tres.RetryExhausted) as ei:
        tres.RetryPolicy(max_attempts=3, sleep=lambda s: None).call(always)
    assert isinstance(ei.value.__cause__, tres.TransientFault)
    slept = []
    with pytest.raises(tres.RetryExhausted):
        tres.RetryPolicy(max_attempts=10, base_delay_ms=500.0,
                         deadline_ms=1.0, sleep=slept.append).call(always)
    assert slept == []


def test_retry_backoff_matches_jax_for_the_same_draws():
    import random
    t = tres.RetryPolicy(base_delay_ms=10.0, max_delay_ms=70.0)
    j = jres.RetryPolicy(base_delay_ms=10.0, max_delay_ms=70.0)
    for attempt in range(1, 7):
        assert t.backoff_ms(attempt, random.Random(attempt)) == \
            j.backoff_ms(attempt, random.Random(attempt))


def test_breaker_state_cycle_fake_clock():
    t = [0.0]
    b = tres.CircuitBreaker(failure_threshold=2, cooldown_ms=1000.0,
                            clock=lambda: t[0])
    assert b.state == tres.CLOSED and b.allow()
    b.record_failure()
    b.record_success()
    b.record_failure()
    assert b.state == tres.CLOSED
    b.record_failure()
    b.record_failure()
    assert b.state == tres.OPEN and not b.allow()
    assert b.retry_after_s() == pytest.approx(1.0)
    t[0] = 1.1
    assert b.state == tres.HALF_OPEN
    assert not b.would_allow() or b.allow()
    assert not b.allow()
    b.record_failure()
    assert b.state == tres.OPEN
    t[0] = 2.3
    assert b.allow()
    b.record_success()
    assert b.state == tres.CLOSED and b.allow()
    off = tres.CircuitBreaker(failure_threshold=0)
    for _ in range(10):
        off.record_failure()
    assert off.allow() and off.state == tres.CLOSED


def test_breaker_stats():
    ft.set_flags({"FLAGS_enable_monitor": True})
    b = tres.CircuitBreaker(failure_threshold=1, cooldown_ms=1e6)
    b.record_failure()
    assert not b.allow()
    snap = tmon.get_stats_snapshot()
    assert snap["counters"]["resilience.breaker_opens"] == 1
    assert snap["counters"]["resilience.breaker_shed"] == 1
    assert snap["gauges"]["resilience.breaker_state"] == 2.0
    assert tmon.flight_records()[-1]["kind"] == "breaker_transition"


# --- the executor's hooks ---------------------------------------------------

def _scale_program():
    main, startup = ft.Program(), ft.Program()
    with ft.program_guard(main, startup), ft.unique_name.guard():
        x = ft.layers.data("x", shape=[-1, 3], dtype="float32",
                           append_batch_size=False)
        out = ft.layers.scale(x, scale=2.0)
    return main, startup, out


def _arm(spec, seed=0):
    ft.set_flags({"FLAGS_fault_spec": spec, "FLAGS_fault_seed": seed})
    tres.reset_injector()


def test_executor_transient_fault_retried_invisibly():
    main, _, out = _scale_program()
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    ft.set_flags({"FLAGS_enable_monitor": True})
    exe = ft.Executor(ft.CPUPlace())
    _arm("transient_fail:at=1:site=executor")
    res = exe.run(main, feed={"x": arr}, fetch_list=[out],
                  scope=ft.Scope())
    np.testing.assert_allclose(res[0], arr * 2)
    c = tmon.get_stats_snapshot()["counters"]
    assert c["resilience.fault_transient"] == 1
    assert c["resilience.retries"] >= 1


def test_executor_step_nan_corrupts_fetches_then_clean_rerun():
    main, _, out = _scale_program()
    arr = np.ones((2, 3), np.float32)
    ft.set_flags({"FLAGS_enable_monitor": True})
    exe = ft.Executor(ft.CPUPlace())
    _arm("step_nan:at=1:site=executor")
    res = exe.run(main, feed={"x": arr}, fetch_list=[out],
                  scope=ft.Scope())
    assert np.isnan(res[0]).any()
    assert tmon.get_stats_snapshot()["counters"]["resilience.fault_nan"] \
        == 1
    _arm("")
    res = exe.run(main, feed={"x": arr}, fetch_list=[out],
                  scope=ft.Scope())
    np.testing.assert_allclose(res[0], arr * 2)


def test_executor_never_retries_a_real_dispatch_error(monkeypatch):
    """A RuntimeError from an op (what a CUDA launch or its sync raises)
    propagates from the first attempt, with a fault spec armed too."""
    main, _, out = _scale_program()
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(texec, "lower_block", boom)
    _arm("slow_step:ms=1:site=executor")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        ft.Executor(ft.CPUPlace()).run(
            main, feed={"x": np.ones((2, 3), np.float32)},
            fetch_list=[out], scope=ft.Scope())
    assert calls == [1]


def _executor_stats(pkg, place, feed_x):
    """Two runs of the same scale program on one executor of `pkg` with
    the monitor on: the stat names recorded, and the flight records."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), pkg.unique_name.guard():
        x = pkg.layers.data("x", shape=[-1, 3], dtype="float32",
                            append_batch_size=False)
        out = pkg.layers.scale(x, scale=2.0)
    pkg.set_flags({"FLAGS_enable_monitor": True})
    exe = pkg.Executor(place)
    scope = pkg.Scope()
    for _ in range(2):
        exe.run(main, feed={"x": feed_x}, fetch_list=[out], scope=scope)
    return exe


def test_executor_stat_names_match_jax():
    x = np.ones((2, 3), np.float32)
    _executor_stats(fj, fj.CPUPlace(), x)
    _executor_stats(ft, ft.CPUPlace(), x)
    want, got = jmon.get_stats_snapshot(), tmon.get_stats_snapshot()
    for kind in ("counters", "gauges", "histograms"):
        # not ported: the analysis gates' stats (ROADMAP A9)
        names_j = {n for n in want[kind] if not n.startswith("analysis.")}
        assert set(got[kind]) == names_j, kind
    for n in ("executor.compile_cache_hit", "executor.compile_cache_miss",
              "executor.flight_records"):
        assert got["counters"][n] == want["counters"][n]
    assert got["histograms"]["executor.step_seconds"]["count"] == 2
    rec = tmon.flight_records()[-1]
    assert rec["kind"] == "step" and rec["cache_hit"] and \
        not rec["first_run"]


def test_executor_sub_spans_and_step_timings():
    _trace_on()
    main, _, out = _scale_program()
    exe = ft.Executor(ft.CPUPlace())
    root = ttrace.start_span("step")
    with ttrace.use_span(root):
        exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
                fetch_list=[out], scope=ft.Scope())
    ttrace.finish_trace(root)
    spans = ttrace.drain_spans()
    kids = [s["name"] for s in spans if s["parent_id"] == root.span_id]
    assert kids == ["executor.feed", "executor.dispatch", "executor.fetch"]
    lt = exe.last_step_timings
    assert set(lt) == {"feed_s", "dispatch_s", "fetch_s", "total_s"}
    assert lt["total_s"] >= lt["dispatch_s"] + lt["fetch_s"]


# --- the new modules import neither JAX nor the JAX package -----------------

@pytest.mark.parametrize("module", [
    "paddle_tpu_torch.monitor", "paddle_tpu_torch.trace",
    "paddle_tpu_torch.goodput", "paddle_tpu_torch.resilience",
    "paddle_tpu_torch.serving.generation",
    "paddle_tpu_torch.serving.spec_decode"])
def test_module_imports_no_jax(module):
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', "
            "'paddle_tpu') or m.startswith(('jax.', 'paddle_tpu.', "
            "'jaxlib')))\n"
            "print(repr(bad))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = repo
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
