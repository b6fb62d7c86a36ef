"""The port's HTTP front end (paddle_tpu_torch/serving/http.py) against
the JAX package's (paddle_tpu/serving/http.py).

One server per package, each over that package's ServingEngine (a tiny
BERT encoder saved by the JAX package: 2 layers, d 32, T 16, max batch
2) and GenerationEngine (a tiny GPT with the JAX package's seeded
weights: d 32, 2 layers, vocab 64, max_seq 32, slab KV). The same
requests go to both; the status codes, the JSON body keys and the
trace headers (traceparent, X-Request-Id) must agree, /v1/predict's
outputs within atol 1e-4 (two layers of float32 products summed in
other orders) and /v1/generate's greedy tokens exactly. Also:
/healthz's worst-state aggregation over a warming engine, the alert
exposure on /alertz, /healthz and /metrics, and the deliberate
difference: /v1/kv/export and /v1/kv/adopt answer 404 naming the route
as not ported, even over a paged engine, where the JAX package's
server would ship KV blocks (ROADMAP §C).
"""
import contextlib
import json
import tempfile
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu import monitor_alerts as jal
from paddle_tpu.models import gpt as gj
from paddle_tpu.models import transformer as tj
from paddle_tpu.serving import EngineConfig as JConfig
from paddle_tpu.serving import GenerationEngine as JGen
from paddle_tpu.serving import ServingEngine as JServing
from paddle_tpu.serving.http import ServingHTTPServer as JServer
from paddle_tpu_torch import monitor_alerts as tal
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.models import gpt as gt
from paddle_tpu_torch.serving import EngineConfig as TConfig
from paddle_tpu_torch.serving import GenerationEngine as TGen
from paddle_tpu_torch.serving import ServingEngine as TServing
from paddle_tpu_torch.serving import ServingHTTPServer as TServer
from paddle_tpu_torch.serving import serve as tserve

from test_torch_observability import reset_globals

T = 16
ATOL = 1e-4
DEADLINE_MS = 120000.0
VOCAB, MAX_SEQ = 64, 32


def _gpt_cfg(g):
    return g.gpt_small(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2,
                       d_ff=64, max_seq_len=MAX_SEQ, dropout=0.0,
                       use_flash=False)


@pytest.fixture(scope="module")
def servers():
    """{"jax" | "torch": (server, serving engine, generation engine)},
    started; stopped after the module."""
    out = {}
    with tempfile.TemporaryDirectory() as d:
        main, startup = fj.Program(), fj.Program()
        startup.random_seed = 7
        with fj.program_guard(main, startup), fj.unique_name.guard():
            cfg = tj.bert_base(vocab_size=60, d_model=32, n_heads=2,
                               n_layers=2, d_ff=64, max_seq_len=T,
                               use_flash=True, dropout=0.1,
                               attn_dropout=0.0)
            tok = fj.layers.data("tokens", shape=[T], dtype="int64")
            hidden = tj.encoder(tok, cfg)
        scope = fj.Scope()
        with fj.scope_guard(scope):
            exe = fj.Executor(fj.CPUPlace())
            exe.run(startup)
            fj.io.save_inference_model(d, ["tokens"], [hidden], exe,
                                       main_program=main)
        gmain, gstart = fj.Program(), fj.Program()
        gstart.random_seed = 11
        gscope = fj.Scope()
        with fj.program_guard(gmain, gstart), fj.scope_guard(gscope):
            gj.build_train(_gpt_cfg(gj), batch=2, seq_len=MAX_SEQ)
            fj.Executor(fj.CPUPlace()).run(gstart)
        params = {n: np.asarray(gscope.get(n)) for n in gscope.names()
                  if gscope.find_var(n) is not None}

        pred_cfg = ft.inference.AnalysisConfig(d)
        pred_cfg.disable_gpu()
        engines = {
            "jax": (JServing(JConfig(d, max_batch_size=2,
                                     default_timeout_ms=DEADLINE_MS)),
                    JGen(_gpt_cfg(gj), gscope, exe=fj.Executor(
                        fj.CPUPlace()), max_seq=MAX_SEQ, paged=False,
                        default_timeout_ms=DEADLINE_MS)),
            "torch": (TServing(TConfig(max_batch_size=2,
                                       default_timeout_ms=DEADLINE_MS),
                               predictor=ft.inference
                               .create_paddle_predictor(pred_cfg)),
                      TGen(_gpt_cfg(gt), scope_from_numpy(
                          params, ft.Scope(), ft.CPUPlace()),
                          exe=ft.Executor(ft.CPUPlace()), max_seq=MAX_SEQ,
                          paged=False, default_timeout_ms=DEADLINE_MS)),
        }
        for name, (eng, gen) in engines.items():
            eng.start()
            gen.start()
            srv = (JServer if name == "jax" else TServer)(
                eng, port=0, gen_engine=gen)
            out[name] = (srv, eng, gen)
        yield out
        for srv, eng, gen in out.values():
            srv.close()
            eng.stop()
            gen.stop()


@pytest.fixture(autouse=True)
def _hygiene():
    reset_globals()
    yield
    reset_globals()


def _call(url, body=None, raw=None, headers=None):
    """(status, headers, parsed JSON body or text)."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            status, hdrs, payload = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, payload = e.code, dict(e.headers), e.read()
    text = payload.decode()
    if hdrs.get("Content-Type") == "application/json":
        return status, hdrs, json.loads(text)
    return status, hdrs, text


def _keys(body):
    """The key structure of a JSON body, values dropped."""
    if isinstance(body, dict):
        return {k: _keys(v) for k, v in body.items()}
    return type(body).__name__ if not isinstance(body, (int, float)) \
        else "number"


def _tokens(rows, seed):
    return np.random.RandomState(seed).randint(0, 60, (rows, T)).tolist()


REQUESTS = [
    ("GET", "/healthz", None, None),
    ("GET", "/alertz", None, None),
    ("GET", "/nope", None, None),
    ("POST", "/v1/predict", {"inputs": {"tokens": _tokens(1, 0)}}, None),
    ("POST", "/v1/predict", {"inputs": {"tokens": _tokens(2, 1)},
                             "timeout_ms": 60000}, None),
    ("POST", "/v1/predict", None, b"{not json"),
    ("POST", "/v1/predict", {"rows": [1, 2]}, None),
    ("POST", "/v1/predict", {"inputs": {}}, None),
    ("POST", "/v1/predict", {"inputs": [1, 2]}, None),
    ("POST", "/v1/generate", {"prompt": [3, 5, 7], "max_new_tokens": 6},
     None),
    ("POST", "/v1/generate", {"prompt": [1, 2, 3, 4, 5, 6, 7, 8, 9],
                              "max_new_tokens": 4, "spec_decode": False},
     None),
    ("POST", "/v1/generate", {"prompt": [3]}, None),
    ("POST", "/v1/generate", {"prompt": [], "max_new_tokens": 2}, None),
    ("POST", "/v1/generate", None, b"[broken"),
    ("POST", "/v1/kv/export", {"prompt": [1, 2, 3]}, None),
    ("POST", "/v1/kv/adopt", {}, None),
    ("POST", "/v1/unknown", {}, None),
]


@pytest.mark.parametrize("i", range(len(REQUESTS)),
                         ids=[f"{m}{p}-{i}" for i, (m, p, _, _) in
                              enumerate(REQUESTS)])
def test_same_answer_as_jax(servers, i):
    method, path, body, raw = REQUESTS[i]
    got = {name: _call(srv.url + path, body, raw)
           for name, (srv, _, _) in servers.items()}
    (sj, hj, bj), (st, ht, bt) = got["jax"], got["torch"]
    assert st == sj, (path, st, sj, bt, bj)
    assert ht.get("Content-Type") == hj.get("Content-Type")
    if path == "/healthz":
        # the engines' own health detail differs by what each package
        # counts; the verdict and its keys agree
        assert bt["state"] == bj["state"] == "ok"
        assert set(bt) == set(bj) and set(bt["engines"]) == \
            set(bj["engines"])
        return
    if path.startswith("/v1/kv/"):
        # the JAX server has no paged engine here either: both refuse
        assert st == 404 and set(bt) >= {"error"}
        return
    assert _keys(bt) == _keys(bj) if st == 200 else set(bt) == set(bj)
    if path == "/v1/predict" and st == 200:
        assert bt["shapes"] == bj["shapes"]
        for name, out in bj["outputs"].items():
            np.testing.assert_allclose(np.asarray(bt["outputs"][name]),
                                       np.asarray(out), atol=ATOL)
    if path == "/v1/generate" and st == 200:
        assert bt["tokens"] == bj["tokens"]
        assert bt["finish_reason"] == bj["finish_reason"]


def test_traceparent_is_continued(servers):
    """With tracing on, a caller's traceparent is continued: the answer
    echoes its trace id in traceparent and X-Request-Id."""
    caller = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
    echoed = {}
    for name, (srv, _, _) in servers.items():
        pkg = fj if name == "jax" else ft
        pkg.set_flags({"FLAGS_enable_trace": True,
                       "FLAGS_trace_sample": 1.0})
        status, hdrs, _ = _call(srv.url + "/v1/predict",
                                {"inputs": {"tokens": _tokens(1, 3)}},
                                headers={"traceparent": caller})
        echoed[name] = (status, hdrs["X-Request-Id"],
                        hdrs["traceparent"].split("-")[1],
                        hdrs["traceparent"].split("-")[3])
    assert echoed["torch"] == echoed["jax"]
    assert echoed["torch"][1] == "0af7651916cd43dd8448eb211c80319c"


def test_alerts_on_alertz_healthz_and_metrics(servers):
    """A threshold rule over the front end's own request counter: firing
    shows on /alertz, in /healthz's alerts_firing (health stays ok) and
    as an ALERTS series on /metrics, the same in both packages."""
    seen = {}
    for name, (srv, _, _) in servers.items():
        pkg, al = (fj, jal) if name == "jax" else (ft, tal)
        pkg.set_flags({"FLAGS_enable_monitor": True,
                       "FLAGS_alert_rules":
                       "busy:threshold:serving.http_requests >= 1",
                       "FLAGS_alert_eval_interval_s": 0.0})
        al.stop_alerts()
        try:
            eng = al.maybe_start()
            _call(srv.url + "/nope")
            eng.evaluate_once(now=1000.0)
            _, _, alertz = _call(srv.url + "/alertz")
            code, _, health = _call(srv.url + "/healthz")
            _, _, metrics = _call(srv.url + "/metrics")
            seen[name] = (alertz["firing"], alertz["rules"][0]["state"],
                          code, health["state"], health["alerts_firing"],
                          [ln for ln in metrics.splitlines()
                           if ln.startswith("ALERTS")])
        finally:
            al.stop_alerts()
            pkg.set_flags({"FLAGS_alert_rules": "",
                           "FLAGS_alert_eval_interval_s": 5.0})
    assert seen["torch"] == seen["jax"]
    assert seen["torch"] == (1, "firing", 200, "ok", 1, [
        'ALERTS{alertname="busy",alertstate="firing"} 1'])


@contextlib.contextmanager
def _server(cls, *a, **kw):
    srv = cls(*a, **kw)
    try:
        yield srv
    finally:
        srv.close()


class _Warming:
    """An engine that has not finished warmup."""
    ready = False


def test_healthz_worst_state_and_missing_engines(servers):
    """A warming engine turns the verdict to 503 warming; a server
    without a generation engine answers /v1/generate 404, one without a
    serving engine /v1/predict 404."""
    _, eng_t, gen_t = servers["torch"]
    _, eng_j, gen_j = servers["jax"]
    got = {}
    for name, cls, eng, gen in (("jax", JServer, eng_j, gen_j),
                                ("torch", TServer, eng_t, gen_t)):
        with _server(cls, _Warming(), port=0, gen_engine=gen) as srv:
            code, _, body = _call(srv.url + "/healthz")
            warming = (code, body["state"])
        with _server(cls, eng, port=0) as srv:
            no_gen = _call(srv.url + "/v1/generate",
                           {"prompt": [1], "max_new_tokens": 1})[0]
        with _server(cls, None, port=0, gen_engine=gen) as srv:
            no_eng = _call(srv.url + "/v1/predict",
                           {"inputs": {"tokens": _tokens(1, 0)}})[0]
        got[name] = (warming, no_gen, no_eng)
    assert got["torch"] == got["jax"] == ((503, "warming"), 404, 404)
    with pytest.raises(ValueError):
        TServer(None, port=0)


def test_kv_routes_answer_not_ported_over_a_paged_engine(servers):
    """The deliberate difference (ROADMAP §C): the KV transfer hop needs
    serving/disagg.py and kv_wire.py, not ported yet, so even over a
    paged engine both routes answer 404 naming themselves."""
    _, eng, gen = servers["torch"]
    paged = TGen(_gpt_cfg(gt), gen.scope, exe=ft.Executor(ft.CPUPlace()),
                 max_seq=MAX_SEQ, paged=True,
                 default_timeout_ms=DEADLINE_MS)
    with _server(TServer, None, port=0, gen_engine=paged) as srv:
        for route in ("/v1/kv/export", "/v1/kv/adopt"):
            code, _, body = _call(srv.url + route, {"prompt": [1, 2]})
            assert code == 404 and body["not_ported"] is True
            assert route in body["error"] and "not ported" in body["error"]


def test_serve_reads_the_port_from_the_engine_config(servers):
    """serve() starts the engines and binds EngineConfig.http_port
    (FLAGS_serving_http_port by default; 0 = an ephemeral port)."""
    _, eng, _ = servers["torch"]
    assert eng.config.http_port == 0 == TConfig().http_port
    srv = tserve(eng)
    try:
        assert srv.port > 0 and _call(srv.url + "/healthz")[0] == 200
    finally:
        srv.close()
