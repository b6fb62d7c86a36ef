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
exposure on /alertz, /healthz and /metrics, and the disaggregated KV
routes: /v1/kv/export and /v1/kv/adopt over a paged GenerationEngine of
each package (block 4) answer the JAX server's codes and bodies for
valid, malformed and refused requests (a shipment's rows within atol
1e-5: each package computed its own KV), 404 without a paged engine,
and a shipment exported by either server and adopted by the other
decodes the slab engines' greedy stream from the adopted prefix.
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
def gpt_weights():
    """The tiny GPT's seeded JAX startup: (JAX scope, {name: array})."""
    gmain, gstart = fj.Program(), fj.Program()
    gstart.random_seed = 11
    gscope = fj.Scope()
    with fj.program_guard(gmain, gstart), fj.scope_guard(gscope):
        gj.build_train(_gpt_cfg(gj), batch=2, seq_len=MAX_SEQ)
        fj.Executor(fj.CPUPlace()).run(gstart)
    params = {n: np.asarray(gscope.get(n)) for n in gscope.names()
              if gscope.find_var(n) is not None}
    return gscope, params


@pytest.fixture(scope="module")
def servers(gpt_weights):
    """{"jax" | "torch": (server, serving engine, generation engine)},
    started; stopped after the module."""
    out = {}
    gscope, params = gpt_weights
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
        # a slab engine: both refuse the KV routes alike
        assert st == 404 and bt == bj == {
            "error": "no paged generation engine attached"}
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


BLOCK = 4
KV_PROMPT = [5, 9, 2, 7, 1, 8, 3, 6, 4]    # two full blocks of 4


@pytest.fixture(scope="module")
def paged(gpt_weights):
    """{"jax" | "torch": server over a paged GenerationEngine (block
    BLOCK) on the tiny GPT's weights}, started; stopped after the
    module."""
    gscope, params = gpt_weights
    out = {}
    for name in ("jax", "torch"):
        if name == "jax":
            scope = fj.Scope()
            for n, a in params.items():
                scope.var(n)
                scope.set(n, np.array(a))
            gen = JGen(_gpt_cfg(gj), scope,
                       exe=fj.Executor(fj.CPUPlace()), max_seq=MAX_SEQ,
                       paged=True, block_size=BLOCK, max_slots=2,
                       default_timeout_ms=DEADLINE_MS)
        else:
            gen = TGen(_gpt_cfg(gt), scope_from_numpy(
                params, ft.Scope(), ft.CPUPlace()),
                exe=ft.Executor(ft.CPUPlace()), max_seq=MAX_SEQ,
                paged=True, block_size=BLOCK, max_slots=2,
                default_timeout_ms=DEADLINE_MS)
        gen.start()
        out[name] = ((JServer if name == "jax" else TServer)(
            None, port=0, gen_engine=gen), gen)
    yield out
    for srv, gen in out.values():
        srv.close()
        gen.stop()


def _shipment(rows_from, **changes):
    """A valid shipment of KV_PROMPT exported by the JAX paged server,
    with `changes` applied."""
    status, _, body = _call(rows_from + "/v1/kv/export",
                            {"prompt": KV_PROMPT})
    assert status == 200
    return {**body, **changes}


KV_CASES = {
    "export": ("/v1/kv/export", {"prompt": KV_PROMPT}, None),
    "export_short": ("/v1/kv/export", {"prompt": [1, 2]}, None),
    "export_not_resident": ("/v1/kv/export",
                            {"prompt": [9] * 8, "run_prefill": False},
                            None),
    "export_no_prompt": ("/v1/kv/export", {}, None),
    "export_broken_json": ("/v1/kv/export", None, b"{broken"),
    "adopt_not_a_shipment": ("/v1/kv/adopt", {"prompt": [1]}, None),
    "adopt_block_size": ("/v1/kv/adopt", "block_size", None),
    "adopt_version": ("/v1/kv/adopt", "version", None),
    "adopt_truncated": ("/v1/kv/adopt", "truncated", None),
    "adopt_rows": ("/v1/kv/adopt", "rows", None),
    "no_route": ("/v1/kv/nope", {}, None),
}


def _kv_body(case, ref_url):
    path, body, raw = KV_CASES[case]
    if body == "block_size":
        body = _shipment(ref_url, block_size=BLOCK * 2)
    elif body == "version":
        body = _shipment(ref_url, version=7)
    elif body == "truncated":
        ship = _shipment(ref_url)
        layer = dict(ship["layers"][0], k=ship["layers"][0]["k"][:16])
        body = dict(ship, layers=[layer] + ship["layers"][1:])
    elif body == "rows":
        ship = _shipment(ref_url)
        body = dict(ship, shape=[ship["shape"][0], BLOCK, 2, 16],
                    layers=[{"k": _b64_zeros(ship["shape"][0] * BLOCK * 32),
                             "v": _b64_zeros(ship["shape"][0] * BLOCK * 32)}
                            for _ in ship["layers"]])
    return path, body, raw


def _b64_zeros(n):
    import base64
    return base64.b64encode(np.zeros(n, np.float32).tobytes()).decode()


def _rows(body):
    from paddle_tpu_torch.serving.kv_wire import unpack_blocks
    return [r.numpy() for layer in unpack_blocks(body).layers
            for r in layer]


@pytest.mark.parametrize("case", list(KV_CASES))
def test_kv_routes_match_jax(paged, case):
    """Each KV request to both paged servers: equal status and body; an
    export's rows within ATOL_KV of the JAX server's."""
    ref = paged["jax"][0].url
    path, body, raw = _kv_body(case, ref)
    got = {name: _call(srv.url + path, body, raw)
           for name, (srv, _) in paged.items()}
    (sj, _, bj), (st, _, bt) = got["jax"], got["torch"]
    assert st == sj, (case, bt, bj)
    if case == "export":
        assert st == 200 and bt["n_blocks"] == 2
        assert {k: v for k, v in bt.items() if k != "layers"} == \
            {k: v for k, v in bj.items() if k != "layers"}
        for a, b in zip(_rows(bt), _rows(bj)):
            np.testing.assert_allclose(a, b, atol=ATOL_KV, rtol=0)
        return
    assert bt == bj
    assert st == {"export_short": 200, "no_route": 404}.get(case, 400)


ATOL_KV = 1e-5


@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
def test_adopted_stream_equals_serial(servers, paged, src, dst):
    """A shipment exported over HTTP by one package's paged server and
    adopted over HTTP by the other's: the adopting server decodes the
    slab engines' greedy stream, with the shipped prefix cached."""
    # a prompt of each direction's own: each server's prefix cache keeps
    # what it exported or adopted before
    prompt = [7, 3, 11, 2, 9, 14, 5, 1, 12, 6] if src == "jax" else \
        [8, 30, 2, 41, 17, 5, 60, 3, 22]
    want = {name: _call(srv.url + "/v1/generate",
                        {"prompt": prompt, "max_new_tokens": 5})[2]
            ["tokens"] for name, (srv, _, _) in servers.items()}
    assert want["torch"] == want["jax"]
    status, _, ship = _call(paged[src][0].url + "/v1/kv/export",
                            {"prompt": prompt})
    assert status == 200 and ship["n_blocks"] == 2
    status, _, res = _call(paged[dst][0].url + "/v1/kv/adopt", ship)
    assert status == 200 and res == {
        "adopted": 2, "duplicate": 0, "resident": 2, "blocks": 2,
        "n_tokens": 2 * BLOCK, "block_size": BLOCK}
    status, _, out = _call(paged[dst][0].url + "/v1/generate",
                           {"prompt": prompt, "max_new_tokens": 5})
    assert status == 200 and out["tokens"] == want["jax"]
    assert out["cached_tokens"] == 2 * BLOCK
    assert paged[dst][1].post_warmup_compiles() == 0


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
