"""The port's GenerationEngine against the JAX package's on the CPU.

Two tiny GPTs (d 32, 4 heads, 2 layers, as in test_generation.py): the
cyclic-successor model of test_generation.py (vocab 16, max_seq 12),
trained by the JAX package, and a model with random weights from a
seeded JAX startup (vocab 64, max_seq 32), whose greedy and sampled
streams are not a fixed cycle. The port's scope gets the JAX scope's
weights through convert.scope_from_numpy.

- Slab and paged engines give the JAX engines' token streams, greedy and
  sampled (temperature 0.8, top_k 5, fixed seeds), exactly, and the
  serial kv_generate streams; both report post_warmup_compiles() == 0.
- Prompts that share a prefix hit the prefix cache the same way.
- Deadlines, queue-full, drain, join mid-flight, eos.
- With the monitor and tracing on, both engines record the same stat
  names and the same span trees (by name and parent).
- The failure envelope: an injected transient fault is retried and the
  streams do not change; a step that raises a RuntimeError (what a CUDA
  error is) fails its requests, releases their slots, counts
  resilience.gen_step_failures and leaves the breaker closed.
- The request's span tree on an injected clock: queue + prefill +
  decode account for the measured e2e.
"""
import collections
import threading

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu import monitor as jmon
from paddle_tpu import trace as jtrace
from paddle_tpu.models import gpt as gj
from paddle_tpu.serving import GenerationEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu_torch import executor as texec
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch import trace as ttrace
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.models import gpt as gt
from paddle_tpu_torch.resilience import CLOSED
from paddle_tpu_torch.serving import (DeadlineExceededError,
                                      EngineClosedError, QueueFullError)
from paddle_tpu_torch.serving import GenerationEngine as TEngine
from paddle_tpu_torch.serving import GenerationRequest as TRequest
from paddle_tpu_torch.serving import SlotManager
from paddle_tpu_torch.serving import generation as tgen

from test_torch_observability import fake_clock, reset_globals


MODELS = {"cyclic": (16, 12), "random": (64, 32)}   # vocab, max_seq


def _cfg(g, name):
    vocab, seq = MODELS[name]
    return g.gpt_small(vocab_size=vocab, d_model=32, n_heads=4, n_layers=2,
                       d_ff=64, max_seq_len=seq, dropout=0.0,
                       use_flash=False)


def _jax_scope(name):
    """The model's JAX scope: the cyclic one trained for 40 AdamW steps
    on the cyclic-successor task, the random one straight from its
    seeded startup."""
    cfg = _cfg(gj, name)
    vocab, seq = MODELS[name]
    main, startup = fj.Program(), fj.Program()
    startup.random_seed = 11
    scope = fj.Scope()
    with fj.program_guard(main, startup), fj.scope_guard(scope):
        loss, _, _ = gj.build_train(cfg, batch=8, seq_len=seq, lr=5e-3)
        exe = fj.Executor(fj.CPUPlace())
        exe.run(startup)
        if name == "cyclic":
            base = np.arange(seq) % vocab
            toks = np.stack([(base + i) % vocab for i in range(8)]) \
                .astype(np.int64)
            for _ in range(40):
                exe.run(main, feed={"tokens": toks}, fetch_list=[loss])
    return scope


@pytest.fixture(scope="module")
def models():
    """name -> (JAX scope, port scope on the CPU holding its weights)."""
    out = {}
    for name in MODELS:
        sj = _jax_scope(name)
        params = {n: np.asarray(sj.get(n)) for n in sj.names()
                  if sj.find_var(n) is not None}
        out[name] = (sj, scope_from_numpy(params, ft.Scope(),
                                          ft.CPUPlace()))
    return out


@pytest.fixture(autouse=True)
def _hygiene():
    reset_globals()
    yield
    reset_globals()


# a request's deadline (queue wait and decode) unless a test sets one: the
# 1000 ms default (FLAGS_serving_default_timeout_ms) would make a test's
# outcome depend on how loaded the machine is
DEADLINE_MS = 120000.0


def _engines(models, name, **kw):
    """A JAX engine and a port engine over the same weights."""
    sj, st = models[name]
    seq = MODELS[name][1]
    ej = JEngine(_cfg(gj, name), sj, exe=fj.Executor(fj.CPUPlace()),
                 max_seq=seq, default_timeout_ms=DEADLINE_MS, **kw)
    et = TEngine(_cfg(gt, name), st, exe=ft.Executor(ft.CPUPlace()),
                 max_seq=seq, default_timeout_ms=DEADLINE_MS, **kw)
    return ej, et


def _serial(models, name, prompt, n, **kw):
    """The port's serial slab kv_generate stream (batch 1)."""
    _, st = models[name]
    main, startup = ft.Program(), ft.Program()
    with ft.program_guard(main, startup):
        step = gt.build_decode_step(_cfg(gt, name), batch=1,
                                    max_seq=MODELS[name][1])
    return gt.kv_generate(ft.Executor(ft.CPUPlace()), st, main,
                          step.token_var, step.logits_var,
                          step.cache_names, prompt=prompt,
                          max_new_tokens=n, **kw)


def _run(eng, Request, cases):
    """Submit every case at once; the streams in submission order."""
    eng.start()
    try:
        resps = [eng.submit(Request(p, n, **kw)) for p, n, kw in cases]
        out = [r.result(timeout=120.0)["tokens"] for r in resps]
        assert eng.post_warmup_compiles() == 0, eng.cache_stats()
    finally:
        eng.stop()
    return out


# greedy and sampled requests over 2 slots: admission and release mid-run
CASES = [([3, 17, 40], 9, {}), ([5], 12, {}),
         ([9, 8, 7, 6, 5, 4], 7, {}),
         ([1, 2], 10, {"temperature": 0.8, "top_k": 5, "seed": 7}),
         ([60, 3, 3], 8, {"temperature": 0.8, "top_k": 5, "seed": 11})]


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_streams_match_jax_and_serial(models, paged):
    kw = {"max_slots": 2, "paged": paged}
    if paged:
        # 2 slots x 8 blocks of 4 tokens, but 12 allocatable blocks:
        # finished requests' blocks are reused for admission
        kw.update(block_size=4, kv_pool_blocks=13)
    ej, et = _engines(models, "random", **kw)
    want = _run(ej, JRequest, CASES)
    got = _run(et, TRequest, CASES)
    assert got == want
    serial = [_serial(models, "random", p, n, **k) for p, n, k in CASES]
    assert got == serial


def test_shared_prefix_hits_like_jax(models):
    prefix = [0, 1, 2, 3, 4, 5, 6, 7]        # two full 4-token blocks
    cases = [(prefix + [8], 3, {}), (prefix + [9], 3, {})]
    results, counters = {}, {}
    for pkg, mon in (("jax", jmon), ("torch", tmon)):
        pkg_mod = fj if pkg == "jax" else ft
        pkg_mod.set_flags({"FLAGS_enable_monitor": True})
        ej, et = _engines(models, "cyclic", max_slots=2, block_size=4)
        eng = ej if pkg == "jax" else et
        eng.start()
        try:
            results[pkg] = [eng.generate(p, n) for p, n, _ in cases]
            assert eng.post_warmup_compiles() == 0
            assert eng.kv_block_stats()["prefix_entries"] >= 2
        finally:
            eng.stop()
        c = mon.get_stats_snapshot()["counters"]
        counters[pkg] = (c["serving.gen_prefix_hits"],
                         c["serving.gen_prefix_misses"])
    for a, b in zip(results["torch"], results["jax"]):
        assert a["tokens"] == b["tokens"]
        assert a["cached_tokens"] == b["cached_tokens"]
    assert [r["cached_tokens"] for r in results["torch"]] == [0, 8]
    assert counters["torch"] == counters["jax"] == (1, 1)
    assert [r["tokens"] for r in results["torch"]] == \
        [_serial(models, "cyclic", p, n) for p, n, _ in cases]


def test_slot_manager_lowest_first_and_release():
    m = SlotManager(3)
    assert [m.acquire() for _ in range(3)] == [0, 1, 2]
    assert m.acquire() is None and m.free_count() == 0
    m.release(1)
    assert m.active_count() == 2 and m.acquire() == 1
    m.release(2)
    m.release(0)
    assert m.acquire() == 0
    for bad in (2, 99):
        with pytest.raises(ValueError):
            m.release(bad)
    with pytest.raises(ValueError):
        SlotManager(0)


def test_request_validation():
    with pytest.raises(ValueError):
        TRequest([], 4)
    with pytest.raises(ValueError):
        TRequest([1], 0)
    r = TRequest(np.array([1, 2], np.int64), 3, eos_id=7)
    assert r.prompt == [1, 2] and r.eos_id == 7


def _port_engine(models, name="cyclic", **kw):
    _, st = models[name]
    return TEngine(_cfg(gt, name), st, exe=ft.Executor(ft.CPUPlace()),
                   max_seq=MODELS[name][1], default_timeout_ms=DEADLINE_MS,
                   **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_queue_full_and_capacity_validation(models, paged):
    eng = _port_engine(models, max_slots=1, queue_capacity=1, paged=paged,
                       block_size=4)
    eng.submit(TRequest([1], 2))       # not started: nothing drains
    with pytest.raises(QueueFullError):
        eng.submit(TRequest([2], 2))
    with pytest.raises(ValueError):
        eng.submit(TRequest(list(range(8)), 12))


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_deadline_fails_queued_request(models, paged):
    eng = _port_engine(models, max_slots=1, paged=paged,
                       block_size=4).start()
    try:
        slow = eng.submit(TRequest([0, 1], 8))
        fast = eng.submit(TRequest([3], 2, timeout_ms=0.01))
        with pytest.raises(DeadlineExceededError):
            fast.result(timeout=30.0)
        assert len(slow.result(timeout=30.0)["tokens"]) == 8
    finally:
        eng.stop()


def test_stop_without_drain_fails_queued_and_running(models):
    eng = _port_engine(models, max_slots=1, block_size=4).start()
    gate = threading.Event()
    first = eng.submit(TRequest([0, 1], 8,
                                stream_cb=lambda tok: gate.wait(10)))
    queued = eng.submit(TRequest([3], 2))
    eng.stop(drain=False, timeout=0)
    gate.set()
    for r in (first, queued):
        with pytest.raises(EngineClosedError):
            r.result(timeout=30.0)
    assert eng.health()["state"] == "stopped"
    with pytest.raises(EngineClosedError):
        eng.submit(TRequest([1], 1))
    eng.stop()


def test_stop_with_drain_finishes_queued(models):
    eng = _port_engine(models, max_slots=1, block_size=4).start()
    resps = [eng.submit(TRequest([i], 3)) for i in range(3)]
    eng.stop(drain=True)
    assert [len(r.result(timeout=1.0)["tokens"]) for r in resps] == \
        [3, 3, 3]
    st = eng.kv_block_stats()
    assert st["blocks_free"] + st["prefix_entries"] == st["blocks_total"]


def test_join_mid_flight_matches_serial(models):
    want_a = _serial(models, "cyclic", [0, 1, 2], 6)
    want_b = _serial(models, "cyclic", [7, 8], 4)
    eng = _port_engine(models, max_slots=2, block_size=4).start()
    try:
        later = []

        def cb(tok):
            if not later:
                later.append(eng.submit(TRequest([7, 8], 4)))

        got_a = eng.submit(TRequest([0, 1, 2], 6, stream_cb=cb)) \
            .result(timeout=30.0)["tokens"]
        assert got_a == want_a
        assert later[0].result(timeout=30.0)["tokens"] == want_b
        assert eng.post_warmup_compiles() == 0
    finally:
        eng.stop()


def test_eos_and_result_metadata(models):
    full = _serial(models, "cyclic", [0, 1], 6)
    eng = _port_engine(models, max_slots=2, block_size=4).start()
    try:
        out = eng.generate([0, 1], 6, eos_id=full[2])
        assert out["tokens"] == full[:3] and out["finish_reason"] == "eos"
        assert out["ttft_ms"] > 0 and out["e2e_ms"] >= out["ttft_ms"]
        out = eng.generate([0, 1], 4)
        assert out["finish_reason"] == "length" and len(out["tokens"]) == 4
    finally:
        eng.stop()


# --- stats and spans against the JAX engine ---------------------------------

SEQUENTIAL = [([0, 1, 2, 3, 4, 5], 4, {}), ([7], 3, {}),
              ([0, 1, 2, 3, 4, 9], 2, {})]


def _observed(eng, pkg, mon, tr):
    """Requests one after another with the monitor and every trace on:
    the stat names by kind, and each request's span tree as a sorted
    list of (name, parent name)."""
    pkg.set_flags({"FLAGS_enable_monitor": True,
                   "FLAGS_enable_trace": True, "FLAGS_trace_sample": 1.0})
    eng.start()
    try:
        for p, n, kw in SEQUENTIAL:
            eng.generate(p, n, **kw)
    finally:
        eng.stop()
    snap = mon.get_stats_snapshot()
    # not ported: the analysis gates' stats (ROADMAP A9)
    names = {k: {n for n in snap[k] if not n.startswith("analysis.")}
             for k in ("counters", "gauges", "histograms")}
    spans = tr.drain_spans()
    by_id = {s["span_id"]: s for s in spans}
    trees = collections.defaultdict(list)
    for s in spans:
        parent = by_id.get(s["parent_id"])
        trees[s["trace_id"]].append(
            (s["name"], parent["name"] if parent else None,
             tuple(sorted({e["name"] for e in s["events"]}))))
    return names, sorted(sorted(t) for t in trees.values())


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_stat_names_and_span_trees_match_jax(models, paged):
    ej, et = _engines(models, "cyclic", max_slots=2, paged=paged,
                      block_size=4)
    names_j, trees_j = _observed(ej, fj, jmon, jtrace)
    names_t, trees_t = _observed(et, ft, tmon, ttrace)
    assert names_t == names_j
    assert trees_t == trees_j
    assert len(trees_t) == len(SEQUENTIAL)
    assert {"serving.gen_ttft_ms", "serving.gen_e2e_ms",
            "serving.gen_inter_token_ms"} <= names_t["histograms"]
    assert ("fetch", "decode", ()) in trees_t[0]
    if paged:
        # chip_smoke.py's [gen_serve] gate lists only what the JAX
        # engine records (the prefix of SEQUENTIAL[0] hits once)
        from test_torch_generate import _chip_smoke
        for kind, want in _chip_smoke().GEN_STATS.items():
            assert set(want) <= names_j[kind], kind


# --- the failure envelope ---------------------------------------------------

FAULTS = ("transient_fail:p=0.3:site=generation,"
          "transient_fail:p=0.3:site=gen_prefill,"
          "transient_fail:p=0.2:site=executor")


def test_injected_faults_are_retried_and_streams_unchanged(models):
    greedy = [c for c in CASES if not c[2]]
    eng = _port_engine(models, "random", max_slots=2, block_size=4)
    want = _run(eng, TRequest, greedy)
    ft.set_flags({"FLAGS_enable_monitor": True, "FLAGS_fault_spec": FAULTS,
                  "FLAGS_fault_seed": 3, "FLAGS_retry_max_attempts": 20,
                  "FLAGS_retry_base_ms": 0.01, "FLAGS_retry_max_ms": 0.01})
    eng = _port_engine(models, "random", max_slots=2, block_size=4)
    assert _run(eng, TRequest, greedy) == want
    c = tmon.get_stats_snapshot()["counters"]
    assert c["resilience.retries"] > 0 and c["resilience.fault_transient"] \
        > 0
    assert "resilience.gen_step_failures" not in c
    assert eng.breaker.state == CLOSED


@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_a_runtime_error_fails_the_step_not_the_worker(models, paged,
                                                       monkeypatch):
    ft.set_flags({"FLAGS_enable_monitor": True})
    eng = _port_engine(models, max_slots=2, paged=paged,
                       block_size=4).start()
    try:
        real = eng.exe.run
        calls = []

        def cuda_error(*a, **k):
            calls.append(1)
            raise RuntimeError("CUDA error: device-side assert triggered")

        monkeypatch.setattr(eng.exe, "run", cuda_error)
        r = eng.submit(TRequest([1, 2], 3))
        with pytest.raises(RuntimeError, match="(decode|prefill) step"):
            r.result(timeout=60.0)
        assert calls == [1]                     # never retried
        monkeypatch.setattr(eng.exe, "run", real)
        assert len(eng.generate([1, 2], 3)["tokens"]) == 3
        c = tmon.get_stats_snapshot()["counters"]
        assert c["resilience.gen_step_failures"] == 1
        assert eng.breaker.state == CLOSED      # not a transient error
        assert eng.health()["state"] == "ready"
    finally:
        eng.stop()
    if paged:
        st = eng.kv_block_stats()
        assert st["blocks_free"] + st["prefix_entries"] == \
            st["blocks_total"]


def test_transient_failures_trip_the_breaker(models):
    from paddle_tpu_torch.serving import OverloadedError
    ft.set_flags({"FLAGS_enable_monitor": True,
                  "FLAGS_serving_breaker_threshold": 2,
                  "FLAGS_serving_breaker_cooldown_ms": 1e6,
                  "FLAGS_retry_max_attempts": 1})
    eng = _port_engine(models, max_slots=2, block_size=4).start()
    try:
        ft.set_flags({"FLAGS_fault_spec":
                      "transient_fail:p=1.0:site=gen_prefill"})
        for _ in range(2):
            with pytest.raises(RuntimeError, match="prefill step"):
                eng.generate([1, 2, 3], 2)
        assert eng.health()["state"] == "open"
        with pytest.raises(OverloadedError):
            eng.submit(TRequest([1, 2, 3], 2))
        c = tmon.get_stats_snapshot()["counters"]
        assert c["resilience.breaker_opens"] == 1
        assert c["resilience.gen_step_failures"] == 2
    finally:
        eng.stop()


# --- the span tree on an injected clock -------------------------------------

def test_request_span_tree_accounts_for_e2e(models, monkeypatch):
    """Copied from test_trace.py's end-to-end case, on an injected clock:
    each clock read of the executor (a step's work) advances it 1 ms,
    each read of the trace and generation modules (bookkeeping) 1 us.
    Queue + prefill + decode (its fetch child nested, not added) account
    for the e2e the caller measures."""
    ft.set_flags({"FLAGS_enable_trace": True, "FLAGS_trace_sample": 1.0})
    eng = _port_engine(models, max_slots=2, block_size=4)
    with fake_clock(monkeypatch, ttrace, tgen, (texec, 1e-3),
                    step=1e-6) as clock:
        eng.start()
        try:
            t0 = clock.perf_counter()
            root = ttrace.start_span("request")
            with ttrace.use_span(root):
                resp = eng.submit(TRequest([0, 1, 2, 3, 4, 5], 5))
            out = resp.result(timeout=60.0)
            e2e_ms = (clock.perf_counter() - t0) * 1e3
            ttrace.finish_trace(root, e2e_ms=e2e_ms)
        finally:
            eng.stop()
    assert out["finish_reason"] == "length"
    spans = ttrace.drain_spans()
    gen = next(s for s in spans if s["name"] == "gen.request")
    assert gen["parent_id"] == root.span_id
    assert gen["attrs"]["tokens"] == 5
    phases = {s["name"]: s for s in spans
              if s["parent_id"] == gen["span_id"]}
    assert set(phases) == {"queue", "prefill", "decode"}
    fetch = next(s for s in spans if s["name"] == "fetch")
    assert fetch["parent_id"] == phases["decode"]["span_id"]
    crit = sum(s["dur_ms"] for s in phases.values())
    assert abs(e2e_ms - crit) <= 0.10 * e2e_ms + 5.0, (e2e_ms, crit)
