"""The serving slice end to end on the CPU: a tiny BERT (2 layers, d 32,
T 128, use_flash=True) saved by one package and served by the other.

Tolerance atol 1e-4 between the packages' float32 outputs (two layers of
products and layer norms summed in different orders).
"""
import os
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.models import transformer as tj
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention
from paddle_tpu_torch.serving import EngineConfig, ServingEngine

T = 128
ATOL = 1e-4


def _build(f, tmod):
    main, startup = f.Program(), f.Program()
    startup.random_seed = 7
    with f.program_guard(main, startup), f.unique_name.guard():
        cfg = tmod.bert_base(vocab_size=60, d_model=32, n_heads=2,
                             n_layers=2, d_ff=64, max_seq_len=T,
                             use_flash=True, dropout=0.1, attn_dropout=0.0)
        tok = f.layers.data("tokens", shape=[T], dtype="int64")
        hidden = tmod.encoder(tok, cfg)
    return main, startup, hidden


@pytest.fixture(scope="module")
def jax_model_dir():
    """A tiny encoder initialised and saved by paddle_tpu."""
    with tempfile.TemporaryDirectory() as d:
        main, startup, hidden = _build(fj, tj)
        scope = fj.Scope()
        with fj.scope_guard(scope):
            exe = fj.Executor(fj.CPUPlace())
            exe.run(startup)
            fj.io.save_inference_model(d, ["tokens"], [hidden], exe,
                                       main_program=main)
        params = {n: np.asarray(scope.get(n)) for n in scope.names()
                  if scope.find_var(n) is not None}
        yield d, main, params


def _tokens(rows, seed=0):
    return np.random.RandomState(seed).randint(0, 60, (rows, T)) \
        .astype(np.int64)


def _cpu_predictor(d):
    cfg = ft.inference.AnalysisConfig(d)
    cfg.disable_gpu()
    return ft.inference.create_paddle_predictor(cfg)


def test_jax_saved_model_serves_in_the_port(jax_model_dir):
    d, _, _ = jax_model_dir
    toks = _tokens(3)
    want = fj.inference.create_paddle_predictor(
        fj.inference.AnalysisConfig(d)).run_dict({"tokens": toks})[0]
    pred = _cpu_predictor(d)
    got = pred.run_dict({"tokens": toks})[0]
    assert got.shape == (3, T, 32)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    # the PaddleTensor path answers the same
    out = pred.run([ft.inference.PaddleTensor(toks, "tokens")])
    np.testing.assert_allclose(out[0].as_ndarray(), got, atol=0)


def test_scope_from_numpy_carries_the_weights(jax_model_dir):
    """The JAX package's parameters, as numpy, into a port scope under
    the same names: the port's own program then answers as the JAX
    predictor does."""
    d, _, params = jax_model_dir
    main, _, hidden = _build(ft, tt)
    infer = main.clone(for_test=True)
    scope = scope_from_numpy(params, ft.Scope(), ft.CPUPlace())
    exe = ft.Executor(ft.CPUPlace())
    toks = _tokens(2, seed=1)
    got = exe.run(infer, feed={"tokens": toks}, fetch_list=[hidden],
                  scope=scope)[0]
    want = fj.inference.create_paddle_predictor(
        fj.inference.AnalysisConfig(d)).run_dict({"tokens": toks})[0]
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_port_saved_model_serves_in_jax():
    """The other direction of the shared on-disk format."""
    main, startup, hidden = _build(ft, tt)
    with tempfile.TemporaryDirectory() as d:
        scope = ft.Scope()
        with ft.scope_guard(scope):
            exe = ft.Executor(ft.CPUPlace())
            exe.run(startup)
            ft.io.save_inference_model(d, ["tokens"], [hidden], exe,
                                       main_program=main)
        assert os.path.exists(os.path.join(d, "__model__.json"))
        toks = _tokens(2, seed=2)
        got = _cpu_predictor(d).run_dict({"tokens": toks})[0]
        want = fj.inference.create_paddle_predictor(
            fj.inference.AnalysisConfig(d)).run_dict({"tokens": toks})[0]
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_startup_is_reproducible_per_seed():
    def init(seed):
        _, startup, _ = _build(ft, tt)
        startup.random_seed = seed
        scope = ft.Scope()
        ft.Executor(ft.CPUPlace()).run(startup, scope=scope)
        return scope.get_numpy("layer_0.att.q.w")
    a, b, c = init(3), init(3), init(4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert abs(a.std() - 0.02) < 0.002  # Normal(0, 0.02)


def test_engine_answers_concurrent_requests(jax_model_dir):
    d, _, _ = jax_model_dir
    pred = _cpu_predictor(d)
    engine = ServingEngine(EngineConfig(max_batch_size=4,
                                        default_timeout_ms=30000),
                           predictor=pred)
    engine.start()
    warm = engine.cache_stats()
    assert warm["misses"] == len(engine.warmup_shapes()) == 3
    reqs = [_tokens(1 + i % 3, seed=10 + i) for i in range(8)]
    answers = [None] * len(reqs)

    def client(i):
        answers[i] = engine.predict({"tokens": reqs[i]})[0]

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    launches = flash_attention.launches
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    engine.stop()
    assert engine.batches >= 1
    assert engine.cache_stats()["misses"] == warm["misses"]
    assert flash_attention.launches == launches  # CPU: no kernel
    direct = pred.clone()
    for x, y in zip(reqs, answers):
        np.testing.assert_allclose(y, direct.run_dict({"tokens": x})[0],
                                   atol=1e-5)


def test_engine_rejects_after_stop(jax_model_dir):
    from paddle_tpu_torch.serving import EngineClosedError
    d, _, _ = jax_model_dir
    engine = ServingEngine(EngineConfig(max_batch_size=2),
                           predictor=_cpu_predictor(d)).start()
    engine.stop()
    with pytest.raises(EngineClosedError):
        engine.submit({"tokens": _tokens(1)})


def test_executor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default place resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.inference.create_paddle_predictor(
            ft.inference.AnalysisConfig("unused"))


def test_state_on_another_device_is_refused():
    main, startup, hidden = _build(ft, tt)
    scope = ft.Scope()
    ft.Executor(ft.CPUPlace()).run(startup, scope=scope)
    scope.set("word_emb", scope.get_numpy("word_emb"))  # host numpy
    with pytest.raises(RuntimeError, match="word_emb"):
        ft.Executor(ft.CPUPlace()).run(
            main.clone(for_test=True), feed={"tokens": _tokens(1)},
            fetch_list=[hidden], scope=scope)


def test_scope_from_numpy_reads_bfloat16_bit_for_bit():
    """A bfloat16 array as the JAX package hands it over (ml_dtypes)
    becomes a torch.bfloat16 tensor with the same bits."""
    vals = np.array([1.0, -2.5, 3.140625, 1e-3], np.float32)
    arr = np.asarray(jax.numpy.asarray(vals, jax.numpy.bfloat16))
    scope = scope_from_numpy({"w": arr}, ft.Scope(), ft.CPUPlace())
    t = scope.get("w")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  arr.astype(np.float32))
    assert scope.get_numpy("w").dtype == np.float32


# --- the engine's hooks: stats, spans, goodput, the breaker ------------------

def _hooked_serving(pkg, mon, tr, gp, d, cpu_predictor):
    """Three requests one after another through a ServingEngine of `pkg`
    with the monitor, every trace and goodput on: the stat names by
    kind, the span trees as sorted (name, parent name) lists, and the
    goodput snapshot."""
    pkg.set_flags({"FLAGS_enable_monitor": True, "FLAGS_enable_trace": True,
                   "FLAGS_trace_sample": 1.0, "FLAGS_enable_goodput": True})
    gp.start_run("serve")
    engine = pkg.serving.ServingEngine(
        pkg.serving.EngineConfig(max_batch_size=2,
                                 default_timeout_ms=30000),
        predictor=cpu_predictor(d))
    engine.start()
    assert engine.health()["state"] == "ready"
    try:
        for rows in (1, 2, 1):
            engine.predict({"tokens": _tokens(rows, seed=rows)})
    finally:
        engine.stop()
    assert engine.health()["state"] == "stopped"
    ledger = gp.end_run()
    snap = mon.get_stats_snapshot()
    # not ported: the analysis gates (ROADMAP A9) and the Pallas tile
    # autotuner's flash.* stats (A7; the Hopper kernels fix their tiles)
    names = {k: {n for n in snap[k]
                 if not n.startswith(("analysis.", "flash."))}
             for k in ("counters", "gauges", "histograms")}
    spans = tr.drain_spans()
    by_id = {s["span_id"]: s for s in spans}
    trees = {}
    for s in spans:
        parent = by_id.get(s["parent_id"])
        trees.setdefault(s["trace_id"], []).append(
            (s["name"], parent["name"] if parent else None))
    return names, sorted(sorted(t) for t in trees.values()), ledger


def _reset_hooks():
    from paddle_tpu import goodput as jgp, monitor as jmon, trace as jtr
    from paddle_tpu import monitor_alerts as jal, resilience as jres
    from paddle_tpu_torch import goodput as tgp, monitor as tmon
    from paddle_tpu_torch import monitor_alerts as tal
    from paddle_tpu_torch import resilience as tres, trace as ttr
    # an alert evaluator thread left running by an earlier test (an HTTP
    # server or router started it) records alerts.* stats whenever it
    # ticks; goodput's start_run leaves its rule in FLAGS_alert_rules
    for al in (jal, tal):
        al.stop_alerts()
    for pkg in (fj, ft):
        pkg.set_flags({"FLAGS_alert_rules": "",
                       "FLAGS_enable_monitor": False,
                       "FLAGS_enable_trace": False,
                       "FLAGS_trace_sample": 0.05,
                       "FLAGS_enable_goodput": False,
                       "FLAGS_fault_spec": "",
                       "FLAGS_serving_breaker_threshold": 5,
                       "FLAGS_serving_breaker_cooldown_ms": 1000.0,
                       "FLAGS_retry_max_attempts": 3})
    for m in (jmon, tmon):
        m.reset_stats()
    for m in (jtr, ttr, jgp, tgp):
        m.reset()
    jres.reset_injector()
    tres.reset_injector()


@pytest.fixture
def hooks_off():
    _reset_hooks()
    yield
    _reset_hooks()


def test_engine_stats_and_span_trees_match_jax(jax_model_dir, hooks_off):
    from paddle_tpu import goodput as jgp, monitor as jmon, trace as jtr
    from paddle_tpu_torch import goodput as tgp, monitor as tmon
    from paddle_tpu_torch import trace as ttr
    import paddle_tpu.serving  # noqa: F401
    import paddle_tpu_torch.serving  # noqa: F401
    d, _, _ = jax_model_dir

    def jax_predictor(path):
        return fj.inference.create_paddle_predictor(
            fj.inference.AnalysisConfig(path))

    names_j, trees_j, _ = _hooked_serving(fj, jmon, jtr, jgp, d,
                                          jax_predictor)
    names_t, trees_t, snap = _hooked_serving(ft, tmon, ttr, tgp, d,
                                             _cpu_predictor)
    assert names_t == names_j
    assert trees_t == trees_j
    # a request's tree, and a batch's with the executor's sub-spans
    assert sorted([("execute", "serving.request"),
                   ("queue", "serving.request"),
                   ("serving.request", None)]) in trees_t
    assert sorted([("executor.dispatch", "serving.batch"),
                   ("executor.feed", "serving.batch"),
                   ("executor.fetch", "serving.batch"),
                   ("serving.batch", None)]) in trees_t
    for n in ("serving.requests", "serving.batches", "serving.warmup_shapes",
              "goodput.serving_busy_seconds", "executor.compile_cache_hit"):
        assert n in names_t["counters"], n
    assert {"serving.e2e_ms", "serving.queue_wait_ms", "serving.batch_size",
            "serving.pad_waste_frac", "serving.warmup_seconds",
            "executor.step_seconds"} <= names_t["histograms"]
    assert tgp.check_invariant(snap)
    # chip_smoke.py's [serve_hooks] gate lists only what the JAX engine
    # records
    from test_torch_generate import _chip_smoke
    for kind, want in _chip_smoke().SERVE_STATS.items():
        assert set(want) <= names_j[kind], kind


def test_breaker_sheds_after_injected_faults_and_recovers(jax_model_dir,
                                                          hooks_off):
    import time
    from paddle_tpu_torch import monitor as tmon
    from paddle_tpu_torch import resilience as tres
    from paddle_tpu_torch.serving import OverloadedError
    d, _, _ = jax_model_dir
    ft.set_flags({"FLAGS_enable_monitor": True,
                  "FLAGS_serving_breaker_threshold": 2,
                  "FLAGS_serving_breaker_cooldown_ms": 300.0,
                  "FLAGS_retry_max_attempts": 1})
    engine = ServingEngine(EngineConfig(max_batch_size=2,
                                        default_timeout_ms=30000),
                           predictor=_cpu_predictor(d)).start()
    try:
        want = engine.predict({"tokens": _tokens(1)})[0]
        ft.set_flags({"FLAGS_fault_spec":
                      "transient_fail:p=1.0:site=serving"})
        tres.reset_injector()
        for _ in range(2):
            with pytest.raises(RuntimeError, match="batch execution"):
                engine.predict({"tokens": _tokens(1)})
        assert engine.breaker.state == tres.OPEN
        assert engine.health()["state"] == "open"
        with pytest.raises(OverloadedError) as ei:
            engine.predict({"tokens": _tokens(1)})
        assert ei.value.retry_after_s > 0
        snap = tmon.get_stats_snapshot()
        assert snap["counters"]["resilience.breaker_opens"] == 1
        assert snap["counters"]["resilience.breaker_shed"] >= 1
        assert snap["counters"]["resilience.fault_transient"] == 2
        assert snap["gauges"]["resilience.breaker_state"] == 2.0
        ft.set_flags({"FLAGS_fault_spec": ""})
        time.sleep(0.35)
        assert engine.health()["state"] == "degraded"
        got = engine.predict({"tokens": _tokens(1)})[0]   # the probe
        np.testing.assert_allclose(got, want, atol=0)
        assert engine.breaker.state == tres.CLOSED
    finally:
        engine.stop()


def test_nan_guard_retries_a_corrupted_batch(jax_model_dir, hooks_off):
    from paddle_tpu_torch import monitor as tmon
    from paddle_tpu_torch import resilience as tres
    d, _, _ = jax_model_dir
    ft.set_flags({"FLAGS_enable_monitor": True})
    engine = ServingEngine(EngineConfig(max_batch_size=2,
                                        default_timeout_ms=30000),
                           predictor=_cpu_predictor(d)).start()
    try:
        want = engine.predict({"tokens": _tokens(2)})[0]
        ft.set_flags({"FLAGS_fault_spec": "step_nan:at=1:site=serving"})
        tres.reset_injector()
        got = engine.predict({"tokens": _tokens(2)})[0]
        np.testing.assert_allclose(got, want, atol=0)
        c = tmon.get_stats_snapshot()["counters"]
        assert c["resilience.nan_batches_retried"] == 1
        assert c["resilience.fault_nan"] == 1
    finally:
        engine.stop()


def test_a_runtime_error_fails_the_batch_not_the_breaker(jax_model_dir,
                                                         hooks_off,
                                                         monkeypatch):
    """A RuntimeError from the run (what a CUDA error is) fails its
    batch once, unretried, and leaves the breaker closed."""
    d, _, _ = jax_model_dir
    ft.set_flags({"FLAGS_serving_breaker_threshold": 1})
    engine = ServingEngine(EngineConfig(max_batch_size=2,
                                        default_timeout_ms=30000),
                           predictor=_cpu_predictor(d)).start()
    calls = []

    def cuda_error(feed):
        calls.append(1)
        raise RuntimeError("CUDA error: an illegal memory access")

    try:
        monkeypatch.setattr(engine.predictor, "run_dict", cuda_error)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            engine.predict({"tokens": _tokens(1)})
        assert calls == [1]
        assert engine.health()["state"] == "ready"
    finally:
        engine.stop()
