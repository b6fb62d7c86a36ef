"""The port's serving router (paddle_tpu_torch/serving/router.py) against
the JAX package's (paddle_tpu/serving/router.py).

The dispatch policy is pinned on stub engines (no model, no warmup), as
tests/test_router.py pins it: each scenario below runs the same script
of events through both packages' `Router` and records what it observes
(which stub answered, the counters, the healthy set, the errors), and
the two records must be equal, and equal to what the JAX test asserts.
The scenarios: least-loaded dispatch, failover, shedding with
Retry-After, a non-retryable error, the breaker opening and its
half-open recovery, the healthz read paths, affinity and its LRU bound,
probing, preempt/resume, the roles of a disaggregated fleet, the
hot-swap gates and its drain, and the worst-state health of a replica
with two engines. SIGTERM chaining and `RouterHTTP`'s codes, bodies and
Retry-After headers are compared the same way. Cooldowns are waited
out with a sleep longer than the cooldown (a lower bound on the clock);
nothing asserts a wall-clock share.

One test starts two replica processes (`python -m
paddle_tpu_torch.serving.replica --cpu --weights ...`), a prefill and a
decode replica, and sends a disaggregated request through a Router over
them as url= replicas: the stream equals serial decode, each side
prints the same row digest, the decode replica's http.request span
parents under the router's router.dispatch span, and SIGTERM drains
and exits 0.
"""
import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu.serving as js
import paddle_tpu_torch as ft
import paddle_tpu_torch.serving as ts
from paddle_tpu import resilience as jres
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch import trace as ttrace

from test_torch_observability import reset_globals

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": types.SimpleNamespace(
        Replica=js.Replica, Router=js.Router, RouterHTTP=js.RouterHTTP,
        Overloaded=js.OverloadedError, QueueFull=js.QueueFullError,
        Closed=js.EngineClosedError, CLOSED=jres.CLOSED),
    "torch": types.SimpleNamespace(
        Replica=ts.Replica, Router=ts.Router, RouterHTTP=ts.RouterHTTP,
        Overloaded=ts.OverloadedError, QueueFull=ts.QueueFullError,
        Closed=ts.EngineClosedError, CLOSED=tres.CLOSED),
}


@pytest.fixture(autouse=True)
def _hygiene():
    reset_globals()
    yield
    reset_globals()


class _StubEngine:
    """Duck-typed ServingEngine: load/health/predict/output_names plus
    the lifecycle hooks Replica touches. `gate`, when set, is an Event
    every predict waits on (a request held in flight)."""

    def __init__(self, tag, load=0):
        self.tag = float(tag)
        self.load_value = load
        self.calls = 0
        self.fail = None
        self.gate = None
        self.entered = threading.Event()
        self.started = self.stopped = False
        self.state = "ready"

    def start(self):
        self.started = True

    def stop(self, drain=True, timeout=30.0):
        self.stopped = True

    def cache_stats(self):
        return {"misses": 0}

    def load(self):
        return self.load_value

    def health(self):
        return {"state": self.state, "retry_after_s": 0.0}

    def output_names(self):
        return ["y"]

    def predict(self, feed, timeout_ms=None):
        self.calls += 1
        self.entered.set()
        if self.gate is not None:
            self.gate.wait(30)
        if self.fail is not None:
            raise self.fail
        return [np.full((1, 1), self.tag, np.float32)]


class _Done:
    def __init__(self, payload):
        self._payload = payload

    def result(self, timeout=None):
        return self._payload


class _StubGen:
    def __init__(self, tag, load=0, compiles=0):
        self.tag = tag
        self.load_value = load
        self.compiles = compiles
        self.calls = 0
        self.stopped = False

    def start(self):
        pass

    def stop(self, drain=True, timeout=30.0):
        self.stopped = True

    def load(self):
        return self.load_value

    def health(self):
        return {"state": "ready", "retry_after_s": 0.0}

    def post_warmup_compiles(self):
        return self.compiles

    def submit(self, greq):
        self.calls += 1
        return _Done({"text": f"from-{self.tag}", "tokens": [1, 2, 3]})


FEED = {"x": np.zeros((1, 4, 6), np.float32)}
GEN = {"prompt": [1, 2, 3], "max_new_tokens": 4}


@contextlib.contextmanager
def _router(p, *reps, **kw):
    kw.setdefault("start_probe", False)
    rt = p.Router(list(reps), **kw)
    try:
        yield rt
    finally:
        rt.close()


def _y(out):
    return float(out["y"][0, 0])


def _names(rt):
    return [r.name for r in rt.healthy_replicas()]


# --- scenarios: each returns what it observed -----------------------------

def least_loaded(p):
    stubs = [_StubEngine(tag=i, load=l) for i, l in enumerate((5, 0, 3))]
    with _router(p, *[p.Replica(f"r{i}", engine=s)
                      for i, s in enumerate(stubs)]) as rt:
        seen = [_y(rt.predict(FEED)), [s.calls for s in stubs]]
        stubs[1].load_value = 9          # load moves, dispatch follows
        seen += [_y(rt.predict(FEED)), rt.requests, rt.redispatches]
    return seen


def failover(p):
    bad, good = _StubEngine(tag=0, load=0), _StubEngine(tag=7, load=5)
    bad.fail = p.QueueFull("replica queue full")
    with _router(p, p.Replica("bad", engine=bad),
                 p.Replica("good", engine=good)) as rt:
        return [_y(rt.predict(FEED)), bad.calls, good.calls,
                rt.redispatches]


def shed_with_retry_after(p):
    s = _StubEngine(tag=0, load=0)
    s.fail = p.Overloaded("full", retry_after_s=3.0)
    with _router(p, p.Replica("r0", engine=s), redispatch_budget=2) as rt:
        try:
            rt.predict(FEED)
            err = None
        except p.Overloaded as e:
            err = (type(e).__name__, e.retry_after_s >= 1.0)
        return [err, s.calls, rt.shed]


def nonretryable(p):
    a, b = _StubEngine(tag=0, load=0), _StubEngine(tag=1, load=5)
    a.fail = ValueError("bad feed")
    with _router(p, p.Replica("a", engine=a),
                 p.Replica("b", engine=b)) as rt:
        with pytest.raises(ValueError):
            rt.predict(FEED)
        return [b.calls, rt.redispatches, _names(rt)]


def breaker_opens(p):
    bad, good = _StubEngine(tag=0, load=0), _StubEngine(tag=1, load=50)
    bad.fail = p.QueueFull("full")
    with _router(p, p.Replica("bad", engine=bad, failure_threshold=2),
                 p.Replica("good", engine=good)) as rt:
        outs = [_y(rt.predict(FEED)) for _ in range(3)]
        before = bad.calls
        outs.append(_y(rt.predict(FEED)))
        return [outs, _names(rt), before, bad.calls]


def half_open_recovers(p):
    """Read-only paths (healthz, probe sweeps, healthy_replicas) must not
    consume the HALF_OPEN probe slot."""
    bad = _StubEngine(tag=3, load=0)
    bad.fail = p.QueueFull("full")
    rep = p.Replica("r", engine=bad, failure_threshold=1)
    rep.breaker.cooldown_ms = 60.0
    with _router(p, rep) as rt:
        with pytest.raises(p.Overloaded):
            rt.predict(FEED)           # one strike trips the breaker
        seen = [_names(rt)]
        time.sleep(0.1)                # past the cooldown: HALF_OPEN
        for _ in range(5):
            rt.healthz()
            rt.probe_once()
            seen.append(_names(rt))
        bad.fail = None
        seen += [_y(rt.predict(FEED)), rep.breaker.state == p.CLOSED,
                 _names(rt)]
    return seen


def nonretryable_in_half_open(p):
    bad = _StubEngine(tag=0, load=0)
    bad.fail = p.QueueFull("full")
    rep = p.Replica("r", engine=bad, failure_threshold=1)
    rep.breaker.cooldown_ms = 40.0
    with _router(p, rep) as rt:
        with pytest.raises(p.Overloaded):
            rt.predict(FEED)           # OPEN
        time.sleep(0.08)               # HALF_OPEN
        bad.fail = ValueError("bad feed")
        with pytest.raises(ValueError):
            rt.predict(FEED)           # probe claimed, then released
        seen = [_names(rt)]
        bad.fail = None
        return seen + [_y(rt.predict(FEED))]


def healthz_does_not_shed(p):
    with _router(p, p.Replica("r", engine=_StubEngine(tag=0))) as rt:
        rt.preempt("r")
        codes = []
        for _ in range(3):
            code, body, ra = rt.healthz()
            codes.append((code, body["state"], ra >= 1.0))
        return [codes, rt.shed]


def affinity(p):
    g0, g1 = _StubGen("g0", load=0), _StubGen("g1", load=5)
    with _router(p, p.Replica("r0", gen_engine=g0),
                 p.Replica("r1", gen_engine=g1)) as rt:
        seen = [rt.generate(GEN, session="s1")["text"]]
        g0.load_value = 50             # the pin holds under load
        seen.append(rt.generate(GEN, session="s1")["text"])
        seen.append(rt.generate(GEN, session="s2")["text"])
        rt.preempt("r0")               # the pin breaks and re-pins
        seen.append(rt.generate(GEN, session="s1")["text"])
    return seen


def affinity_lru(p):
    g = _StubGen("g", load=0)
    with _router(p, p.Replica("r", gen_engine=g), affinity_max=4) as rt:
        for i in range(10):
            rt.generate(GEN, session=f"s{i}")
        seen = [list(rt._affinity)]
        rt.generate(GEN, session="s6")
        rt.generate(GEN, session="new")
        return seen + [list(rt._affinity)]


def probe_once(p):
    a, b = _StubEngine(tag=0, load=0), _StubEngine(tag=1, load=5)
    with _router(p, p.Replica("a", engine=a),
                 p.Replica("b", engine=b)) as rt:
        a.health = lambda: {"state": "open", "retry_after_s": 2.0}
        rt.probe_once()
        seen = [_names(rt), _y(rt.predict(FEED)), a.calls]
        a.health = lambda: {"state": "ready", "retry_after_s": 0.0}
        rt.probe_once()
        rep_a = [r for r in rt.replicas() if r.name == "a"][0]
        seen.append(rep_a.backoff_until > 0)
        rep_a.backoff_until = 0.0
        return seen + [_names(rt)]


def preempt_resume(p):
    a, b = _StubEngine(tag=0, load=0), _StubEngine(tag=1, load=5)
    with _router(p, p.Replica("a", engine=a),
                 p.Replica("b", engine=b)) as rt:
        rt.preempt("a")
        seen = [_names(rt), _y(rt.predict(FEED))]
        rt.resume("a")
        return seen + [_names(rt), _y(rt.predict(FEED))]


def stopped_replica_fails_over(p):
    """A replica stopped mid-traffic answers EngineClosedError; the
    router re-dispatches, and the probe takes it out of the table."""
    a, b = _StubEngine(tag=0, load=0), _StubEngine(tag=1, load=5)
    with _router(p, p.Replica("a", engine=a),
                 p.Replica("b", engine=b)) as rt:
        a.fail, a.state = p.Closed("engine is shut down"), "stopped"
        seen = [_y(rt.predict(FEED)), rt.redispatches]
        rt.probe_once()
        return seen + [_names(rt), _y(rt.predict(FEED)), a.calls]


def roles(p):
    rp = p.Replica("p0", gen_engine=_StubGen("p"), role="prefill")
    rd = p.Replica("d0", gen_engine=_StubGen("d"), role="decode")
    with _router(p, rp, rd) as rt:
        seen = [rt._pick("generate", set(), None).name,
                rt._pick("prefill", set(), None).name,
                rt._pick("predict", set(), None)]
        code, body, _ = rt.healthz()
        seen += [code, {n: d["role"] for n, d in body["replicas"].items()}]
    try:
        p.Replica("x", gen_engine=_StubGen("x"), role="wat")
    except ValueError:
        seen.append("bad role refused")
    return seen


def hot_swap_gates(p):
    a, b = _StubEngine(tag=0, load=0), _StubEngine(tag=1, load=9)
    with _router(p, p.Replica("r0", engine=a),
                 p.Replica("r1", engine=b)) as rt:
        dup = _StubEngine(tag=2)
        with pytest.raises(ValueError):
            rt.hot_swap("r0", p.Replica("r1", engine=dup))
        seen = [dup.started, sorted(r.name for r in rt.replicas())]
        res = rt.hot_swap("r0", p.Replica("r0", engine=_StubEngine(tag=5),
                                          version="v2"))
        reps = {r.name: r for r in rt.replicas()}
        seen += [res, sorted(reps), reps["r0"].version,
                 _y(rt.predict(FEED)), a.stopped]
    g, comp = _StubGen("g0"), _StubGen("c", compiles=1)
    with _router(p, p.Replica("g0", gen_engine=g)) as rt:
        with pytest.raises(RuntimeError, match="post-warmup compiles"):
            rt.hot_swap("g0", p.Replica("g1", gen_engine=comp))
        seen += [comp.stopped, [r.name for r in rt.replicas()],
                 rt.generate(GEN)["text"]]
    return seen


def hot_swap_drains(p):
    """A request held in flight on the old replica: hot_swap flips the
    table at once, waits for the request to finish, then stops the old
    replica; traffic after the flip goes to the standby."""
    old, new = _StubEngine(tag=1), _StubEngine(tag=2)
    old.gate = threading.Event()
    with _router(p, p.Replica("r0", engine=old),
                 drain_timeout_s=30.0) as rt:
        held = {}
        t = threading.Thread(
            target=lambda: held.update(out=_y(rt.predict(FEED))))
        t.start()
        old.entered.wait(30)
        swap = {}
        s = threading.Thread(target=lambda: swap.update(
            res=rt.hot_swap("r0", p.Replica("r0v2", engine=new))))
        s.start()
        while [r.name for r in rt.replicas()] != ["r0v2"]:
            time.sleep(0.005)          # the table flips before the drain
        during = [_y(rt.predict(FEED)), old.stopped, "res" in swap]
        old.gate.set()
        t.join(30)
        s.join(30)
        return [during, held["out"], swap["res"], old.stopped]


def replica_worst_state(p):
    """Replica.health over two engines: the worst state wins, the
    largest Retry-After is kept, and "ready" reads "ok"."""
    seen = []
    for s1 in ("ready", "degraded", "warming", "open", "stopped"):
        for s2 in ("ready", "degraded", "open", "stopped"):
            a, g = _StubEngine(tag=0), _StubGen("g")
            a.health = lambda s=s1: {"state": s, "retry_after_s":
                                     2.0 if s == "open" else 0.0}
            g.health = lambda s=s2: {"state": s, "retry_after_s":
                                     5.0 if s == "open" else 0.0}
            rep = p.Replica("r", engine=a, gen_engine=g)
            seen.append((s1, s2, rep.health()))
    return seen


SCENARIOS = {
    "least_loaded": (least_loaded, [1.0, [0, 1, 0], 2.0, 2, 0]),
    "failover": (failover, [7.0, 1, 1, 1]),
    "shed_with_retry_after": (shed_with_retry_after,
                              [("OverloadedError", True), 1, 1]),
    "nonretryable": (nonretryable, [0, 0, ["a", "b"]]),
    "breaker_opens": (breaker_opens,
                      [[1.0, 1.0, 1.0, 1.0], ["good"], 2, 2]),
    "half_open_recovers": (half_open_recovers,
                           [[]] + [["r"]] * 5 + [3.0, True, ["r"]]),
    "nonretryable_in_half_open": (nonretryable_in_half_open,
                                  [["r"], 0.0]),
    "healthz_does_not_shed": (healthz_does_not_shed,
                              [[(503, "open", True)] * 3, 0]),
    "affinity": (affinity, ["from-g0", "from-g0", "from-g1", "from-g1"]),
    "affinity_lru": (affinity_lru, [["s6", "s7", "s8", "s9"],
                                    ["s8", "s9", "s6", "new"]]),
    "probe_once": (probe_once, [["b"], 1.0, 0, True, ["a", "b"]]),
    "preempt_resume": (preempt_resume, [["b"], 1.0, ["a", "b"], 0.0]),
    "stopped_replica_fails_over": (stopped_replica_fails_over,
                                   [1.0, 1, ["b"], 1.0, 1]),
    "roles": (roles, ["d0", "p0", None, 200,
                      {"p0": "prefill", "d0": "decode"},
                      "bad role refused"]),
    "hot_swap_gates": (hot_swap_gates, None),
    "hot_swap_drains": (hot_swap_drains, None),
    "replica_worst_state": (replica_worst_state, None),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_router_scenario_matches_jax(name):
    fn, expect = SCENARIOS[name]
    got = {k: fn(p) for k, p in PKGS.items()}
    assert got["torch"] == got["jax"]
    if expect is not None:
        assert got["torch"] == expect
    if name == "hot_swap_gates":
        assert got["torch"][0] is False and got["torch"][4] == "v2"
        assert got["torch"][2]["swapped"] and got["torch"][5] == 5.0
    if name == "hot_swap_drains":
        during, held, res, stopped = got["torch"]
        assert during == [2.0, False, False]
        assert held == 1.0 and res["drained"] and stopped
        assert res["standby_post_warmup_compiles"] == 0
    if name == "replica_worst_state":
        by = {(a, b): h for a, b, h in got["torch"]}
        assert by[("ready", "ready")] == {"state": "ok",
                                          "retry_after_s": 0.0}
        assert by[("degraded", "open")] == {"state": "open",
                                            "retry_after_s": 5.0}
        assert by[("stopped", "ready")]["state"] == "stopped"


class _ClosingEngine(_StubEngine):
    """A stub that, once stopped, answers as a stopped ServingEngine
    does: EngineClosedError, and a "stopped" health."""

    def stop(self, drain=True, timeout=30.0):
        self.stopped, self.state = True, "stopped"

    def predict(self, feed, timeout_ms=None):
        if self.stopped:
            raise ts.EngineClosedError("engine is shut down")
        time.sleep(0.001)
        return super().predict(feed, timeout_ms)


@pytest.mark.parametrize("run", range(5))
def test_stop_drill_redispatches_on_purpose(run):
    """chip_smoke's [router_drill] stop action (stop_and_redispatch)
    under the drill's client threads, on a Router with no background
    probe as [router_serve] builds it: the action itself lands a request
    on the stopped r0, so every run counts a re-dispatch, no client
    fails, and the drill's probe then takes r0 out of the table."""
    from test_torch_generate import _chip_smoke
    c = _chip_smoke()
    engines = {n: _ClosingEngine(tag=i) for i, n in enumerate(("r0", "r1"))}
    reps = {n: ts.Replica(n, engine=e) for n, e in engines.items()}
    with _router(PKGS["torch"], *reps.values()) as rt:
        reqs = [np.zeros((1, 4, 6), np.float32)] * 3
        got, errors, moved, after = c._router_drill(
            rt, reqs, lambda wait: c.stop_and_redispatch(
                rt, reps["r0"], {"tokens": reqs[0]}))
        assert not errors and moved >= 1 and rt.redispatches >= 1
        assert after >= c.ROUTER_DRILL_AFTER
        rt.probe_once()
        assert [r.name for r in rt.healthy_replicas()] == ["r1"]


def test_install_sigterm_chains_previous_handler():
    seen = {}
    for name, p in PKGS.items():
        calls = []

        def prev_handler(signum, frame):
            calls.append(signum)

        old = signal.signal(signal.SIGTERM, prev_handler)
        try:
            with _router(p, p.Replica("a", engine=_StubEngine(tag=0))) \
                    as rt:
                rt.install_sigterm("a")
                handler = signal.getsignal(signal.SIGTERM)
                replaced = handler is not prev_handler
                handler(signal.SIGTERM, None)
                registered = rt.replicas()[0].registered
            restored = signal.getsignal(signal.SIGTERM) is prev_handler
        finally:
            signal.signal(signal.SIGTERM, old)
        seen[name] = (replaced, calls, registered, restored)
    assert seen["torch"] == seen["jax"] == (
        True, [signal.SIGTERM], False, True)


def _call(url, body=None, raw=None, headers=None):
    """(status, headers, parsed JSON body or text) of one request."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, hdrs, payload = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, payload = e.code, dict(e.headers), e.read()
    text = payload.decode()
    if hdrs.get("Content-Type") == "application/json":
        return status, hdrs, json.loads(text)
    return status, hdrs, text


HTTP_REQUESTS = [
    ("/healthz", None, None, None),
    ("/nope", None, None, None),
    ("/alertz", None, None, None),
    ("/v1/predict", {"inputs": {"x": FEED["x"].tolist()}}, None, None),
    ("/v1/predict", None, b"{not json", None),
    ("/v1/predict", {"inputs": {}}, None, None),
    ("/v1/predict", {"rows": [1]}, None, None),
    ("/v1/generate", GEN, None, None),
    ("/v1/generate", {**GEN, "session": "s1"}, None, None),
    ("/v1/generate", GEN, None, {"X-Session-Id": "s2"}),
    ("/v1/generate", {"prompt": [1]}, None, None),
    ("/v1/unknown", {}, None, None),
]


def test_router_http_codes_and_bodies_match_jax():
    """RouterHTTP over two stub replicas in each package: every request
    of HTTP_REQUESTS, then the same with every replica preempted (503
    and a Retry-After on the routes and on /healthz), answers with the
    JAX front end's status, body and Retry-After."""
    seen = {}
    for name, p in PKGS.items():
        eng, gen = _StubEngine(tag=4), _StubGen("g")
        rt = p.Router([p.Replica("r0", engine=eng, gen_engine=gen,
                                 version="v1")], start_probe=False)
        srv = p.RouterHTTP(rt, port=0)
        answers = []
        try:
            for phase in ("up", "preempted"):
                if phase == "preempted":
                    rt.preempt("r0")
                for path, body, raw, hdrs in HTTP_REQUESTS:
                    code, h, b = _call(srv.url + path, body, raw, hdrs)
                    if isinstance(b, dict):
                        # the clock's reading differs between the calls
                        b = {k: v for k, v in b.items() if k != "ts"}
                    answers.append((phase, path, code, b,
                                    "Retry-After" in h))
            answers.append(("sessions", sorted(rt._affinity), rt.shed))
        finally:
            srv.close()
            rt.close()
        seen[name] = answers
    assert seen["torch"] == seen["jax"]
    codes = [a[2] for a in seen["torch"][:len(HTTP_REQUESTS)]]
    assert codes == [200, 404, 200, 200, 400, 400, 400, 200, 200, 200,
                     400, 404]
    shed = [a for a in seen["torch"][len(HTTP_REQUESTS):-1]
            if a[1].startswith("/v1/") and a[2] == 503]
    assert shed and all(a[4] and a[3]["retryable"] for a in shed)
    # preempt dropped the pins; the 4 routed requests were shed
    assert seen["torch"][-1] == ("sessions", [], 4)


# --- two replica processes --------------------------------------------------

VOCAB, SEQ, BLOCK = 64, 32, 4
SPAWN_TIMEOUT_S = 240.0


def _gpt_cfg(g):
    return g.gpt_small(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2,
                       d_ff=64, max_seq_len=SEQ, dropout=0.0,
                       use_flash=False)


def _weights(path):
    """The JAX package's seeded GPT startup written as an npz, as a
    trained scope would be; returns the arrays."""
    from paddle_tpu.models import gpt as gj
    main, startup = fj.Program(), fj.Program()
    startup.random_seed = 11
    scope = fj.Scope()
    with fj.program_guard(main, startup), fj.scope_guard(scope):
        gj.build_train(_gpt_cfg(gj), batch=2, seq_len=SEQ)
        fj.Executor(fj.CPUPlace()).run(startup)
    params = {n: np.asarray(scope.get(n)) for n in scope.names()
              if scope.find_var(n) is not None}
    np.savez(path, **params)
    return params


def _spawn(tmp, name, weights, env):
    """Start one --cpu --weights replica; returns (process, port file,
    log path)."""
    port_file = os.path.join(tmp, f"{name}.port")
    log = os.path.join(tmp, f"{name}.log")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.replica",
           "--cpu", "--weights", weights, "--vocab", str(VOCAB),
           "--max-seq", str(SEQ), "--block-size", str(BLOCK),
           "--slots", "2", "--timeout-ms", "120000", "--kv-digest",
           "--port-file", port_file,
           "--trace-out", os.path.join(tmp, f"{name}.spans.jsonl")]
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
    return proc, port_file, log


def test_replica_processes_serve_a_disaggregated_request(tmp_path):
    from paddle_tpu_torch.models import gpt as gt

    tmp = str(tmp_path)
    weights = os.path.join(tmp, "w.npz")
    params = _weights(weights)
    env = dict(os.environ, PYTHONPATH=REPO, FLAGS_enable_trace="1",
               FLAGS_trace_sample="1.0", OMP_NUM_THREADS="1")
    procs = {n: _spawn(tmp, n, weights, env) for n in ("p0", "d0")}
    prompt = [(3 * i + 1) % VOCAB for i in range(3 * BLOCK + 2)]
    try:
        # serial decode of the same weights in this process
        scope = ft.convert.scope_from_numpy(params, ft.Scope(),
                                            ft.CPUPlace())
        main, startup = ft.Program(), ft.Program()
        with ft.program_guard(main, startup):
            step = gt.build_decode_step(_gpt_cfg(gt), batch=1, max_seq=SEQ)
        want = gt.kv_generate(ft.Executor(ft.CPUPlace()), scope, main,
                              step.token_var, step.logits_var,
                              step.cache_names, prompt=prompt,
                              max_new_tokens=5)
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        for name, (proc, port_file, log) in procs.items():
            while not os.path.exists(port_file):
                assert proc.poll() is None, open(log).read()
                assert time.monotonic() < deadline, f"{name} not ready"
                time.sleep(0.1)
        urls = {n: f"http://127.0.0.1:{open(pf).read()}"
                for n, (_, pf, _) in procs.items()}
        ft.set_flags({"FLAGS_enable_trace": True, "FLAGS_trace_sample": 1.0,
                      "FLAGS_enable_monitor": True})
        rt = ts.Router([ts.Replica("p0", url=urls["p0"], role="prefill"),
                        ts.Replica("d0", url=urls["d0"], role="decode")],
                       start_probe=False, disagg=True)
        try:
            for rep in rt.replicas():
                rep.start(timeout_s=60)
            root = ttrace.start_span("request")
            with ttrace.use_span(root):
                out = rt.generate({"prompt": prompt, "max_new_tokens": 5,
                                   "timeout_ms": 120000})
            ttrace.finish_trace(root)
            again = rt.generate({"prompt": prompt, "max_new_tokens": 5,
                                 "timeout_ms": 120000})
            counters = ft.monitor.get_stats_snapshot()["counters"]
        finally:
            rt.close()
        spans = ttrace.drain_spans()
        for proc, _, _ in procs.values():
            proc.send_signal(signal.SIGTERM)
        codes = {n: proc.wait(60) for n, (proc, _, _) in procs.items()}
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
    logs = {n: [json.loads(ln) for ln in open(log)
                if ln.startswith("{")] for n, (_, _, log) in procs.items()}
    assert codes == {"p0": 0, "d0": 0}, logs
    assert out["tokens"] == want and again["tokens"] == want
    assert out["cached_tokens"] == 3 * BLOCK
    assert counters["serving.kv_xfer_blocks"] == 3
    assert counters["serving.disagg_prefix_reuse"] == 1
    exp = [r for r in logs["p0"] if r["kind"] == "kv_export"]
    adp = [r for r in logs["d0"] if r["kind"] == "kv_adopt"]
    assert len(exp) == len(adp) == 1 and exp[0]["blocks"] == 3
    assert (adp[0]["blocks"], adp[0]["adopted"]) == (3, 3)
    assert adp[0]["sha256"] == exp[0]["sha256"]
    assert [r["kind"] for r in logs["d0"]][-1] == "replica_exit"
    # the decode replica's /v1/generate span parents under the first
    # request's router.dispatch span: one trace over both processes
    disp = [s for s in spans if s["name"] == "router.dispatch"
            and s["trace_id"] == root.trace_id]
    child = [json.loads(ln) for ln in
             open(os.path.join(tmp, "d0.spans.jsonl"))]
    hop = [s for s in child if s["name"] == "http.request"
           and s["attrs"].get("path") == "/v1/generate"
           and s["trace_id"] == root.trace_id]
    assert len(disp) == 1 and len(hop) == 1
    assert hop[0]["parent_id"] == disp[0]["span_id"]


def test_replica_without_cpu_raises_where_there_is_no_card(tmp_path):
    """No fallback hides the device: without --cpu the replica resolves
    CUDAPlace(0), which raises on a machine without a card."""
    from paddle_tpu_torch.serving import replica
    if ft.core.place.torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    np.savez(tmp_path / "w.npz", x=np.zeros(1, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replica.main(["--weights", str(tmp_path / "w.npz")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replica.main(["--model-dir", str(tmp_path)])
