"""Stdlib HTTP front end for ServingEngine / GenerationEngine.

The JAX package's `serving/http.py` over this package's engines: the
same routes, status codes, body keys, health aggregation and
traceparent handling.

Endpoints (JSON over ThreadingHTTPServer — each client connection gets
its own handler thread, which blocks in `engine.predict` /
`gen_engine.generate` so the batching layers see genuine concurrency):

- ``POST /v1/predict``  body ``{"inputs": {name: nested list},
  "timeout_ms": optional}`` -> ``{"outputs": {name: nested list},
  "shapes": {...}}``; 400 malformed, 503 queue-full/closed (the
  backpressure status clients should retry with backoff), 504 deadline.
- ``POST /v1/generate`` body ``{"prompt": [token ids],
  "max_new_tokens": n, "temperature"/"top_k"/"eos_id"/"seed"/
  "timeout_ms"/"spec_decode": optional}`` -> ``{"tokens": [...],
  "finish_reason": "length"|"eos", "ttft_ms", "e2e_ms"}`` from the
  continuous-batching
  GenerationEngine; same 400/503/504 error mapping. 404 when the server
  was started without a generation engine.
- ``POST /v1/kv/export`` body ``{"prompt": [token ids],
  "run_prefill": optional}`` -> a ``kv_wire`` shipment (the prompt's
  full-block KV prefix, prefilled locally if needed), and
  ``POST /v1/kv/adopt`` body = a shipment -> adoption summary; the
  disaggregated-fleet transfer hop (serving/disagg.py). 404 unless a
  *paged* generation engine is attached.
- ``GET /healthz``      -> aggregated engine health. 200 with
  ``{"state": "ok"|"degraded", ...}`` while every attached engine is
  ready (degraded = some circuit breaker is half-open and probing);
  503 with ``{"state": "warming"|"open"|"stopped", ...}`` otherwise —
  ``warming`` until warmup() completes, ``open`` (plus a
  ``Retry-After`` header) while a breaker is shedding load.
- ``GET /metrics``      -> the same Prometheus text the monitor's scrape
  endpoint serves (monitor.prometheus_text), so one port serves both
  traffic and observability — including ``ALERTS{...}`` series and
  ``alerts.*`` stats when the SLO engine is running.
- ``GET /alertz``       -> the alert engine's full rule/state dump
  (monitor_alerts.alertz_dict): every rule with its state
  (inactive/pending/firing), last value, windows, and the incident
  bundle path of the current firing. Always 200 — an alert never flips
  health; ``/healthz`` detail carries an ``alerts_firing`` count for
  operators instead.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional

import numpy as np

from .. import monitor_alerts, trace
from ..monitor import STAT_ADD, prometheus_text
from .batcher import (DeadlineExceededError, EngineClosedError,
                      OverloadedError, QueueFullError)
from .engine import ServingEngine

# severity order for aggregating per-engine health states into one
# /healthz verdict (worst wins); ok/degraded answer 200, the rest 503
_STATE_RANK = {"ready": 0, "degraded": 1, "warming": 2, "open": 3,
               "stopped": 4}


def _retry_after_hdr(e: OverloadedError):
    s = getattr(e, "retry_after_s", 0.0) or 0.0
    if s <= 0:
        return None
    return {"Retry-After": str(max(1, int(round(s))))}

__all__ = ["ServingHTTPServer", "serve"]


class ServingHTTPServer:
    """Owns the listening socket + serve_forever thread. `port=0` binds
    an ephemeral port (read it back from `.port` — tests do).

    Attach a `ServingEngine` (/v1/predict), a `GenerationEngine`
    (/v1/generate), or both on one port; an absent engine's route
    answers 404."""

    def __init__(self, engine: Optional[ServingEngine] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 gen_engine=None, kv_hook=None):
        import http.server

        if engine is None and gen_engine is None:
            raise ValueError("ServingHTTPServer needs an engine and/or "
                             "a gen_engine")
        eng = engine
        gen = gen_engine
        # In-flight POST accounting so close(drain=True) can wait for
        # work already inside an engine instead of resetting the
        # connection under it (replica restarts behind the router must
        # not surface as wrong answers).
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._draining = False
        # kv_hook(route, gen_engine, request, answer): called after each
        # successful /v1/kv/export ("export") or /v1/kv/adopt ("adopt"),
        # before the answer goes out (the replica process logs shipment
        # digests through it)
        self.kv_hook = kv_hook
        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # per-request trace state (each request is handled
            # start-to-finish on one connection thread)
            _span = None
            _last_code = None

            def _reply(self, code: int, payload: dict, headers=None):
                self._last_code = code
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if self._span is not None:
                    # Router-ready response identity: clients (and the
                    # future multi-replica router) correlate by request
                    # id; the traceparent echo lets a caller that did
                    # NOT send one adopt the trace this server opened.
                    self._span.set_attr("http.status", code)
                    self.send_header("X-Request-Id",
                                     self._span.trace_id)
                    self.send_header(
                        "traceparent",
                        trace.format_traceparent(self._span))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _healthz(self):
                worst = "ready"
                retry_after = 0.0
                detail = {}
                for name, e in (("predict", eng), ("generate", gen)):
                    if e is None:
                        continue
                    if hasattr(e, "health"):
                        h = e.health()
                    else:
                        h = {"state": "ready" if e.ready
                             else "warming"}
                    if hasattr(e, "post_warmup_compiles"):
                        h = dict(h)
                        h["post_warmup_compiles"] = \
                            e.post_warmup_compiles()
                    if hasattr(e, "kv_block_stats"):
                        h["kv"] = e.kv_block_stats()
                    detail[name] = h
                    if _STATE_RANK.get(h["state"], 4) > \
                            _STATE_RANK.get(worst, 4):
                        worst = h["state"]
                    retry_after = max(retry_after,
                                      h.get("retry_after_s") or 0.0)
                body = {"state": "ok" if worst == "ready" else worst,
                        "engines": detail,
                        # informational: firing alerts never change the
                        # health verdict (alerts page humans; healthz
                        # steers load balancers)
                        "alerts_firing": monitor_alerts.firing_count()}
                if worst in ("ready", "degraded"):
                    self._reply(200, body)
                else:
                    hdrs = None
                    if worst == "open" and retry_after > 0:
                        hdrs = {"Retry-After":
                                str(max(1, int(round(retry_after))))}
                    self._reply(503, body, headers=hdrs)

            def do_GET(self):
                STAT_ADD("serving.http_requests")
                if self.path.startswith("/healthz"):
                    self._healthz()
                elif self.path.startswith("/metrics"):
                    body = prometheus_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/alertz"):
                    self._reply(200, monitor_alerts.alertz_dict())
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                STAT_ADD("serving.http_requests")
                with outer._inflight_cv:
                    if outer._draining:
                        draining = True
                    else:
                        draining = False
                        outer._inflight += 1
                if draining:
                    # Keep-alive connections outlive shutdown(); refuse
                    # new work with the retryable backpressure status
                    # and drop the connection so clients re-dial.
                    self._reply(503, {"error": "server is draining",
                                      "retryable": True})
                    self.close_connection = True
                    return
                try:
                    self._do_post()
                finally:
                    with outer._inflight_cv:
                        outer._inflight -= 1
                        if outer._inflight == 0:
                            outer._inflight_cv.notify_all()

            def _do_post(self):
                self._span = None
                self._last_code = None
                if trace.enabled():
                    # W3C trace-context ingress: continue the caller's
                    # trace when a valid traceparent arrived, else open
                    # a new root. The span is contextvar-current for
                    # the handler body, so the batcher/generation
                    # submit() spans parent under it.
                    remote = trace.parse_traceparent(
                        self.headers.get("traceparent"))
                    self._span = trace.start_span(
                        "http.request", remote=remote,
                        attrs={"method": "POST",
                               "path": self.path.split("?")[0]})
                try:
                    with trace.use_span(self._span):
                        self._route_post()
                except BaseException as e:
                    trace.finish_trace(
                        self._span, error=f"{type(e).__name__}: {e}")
                    self._span = None
                    raise
                else:
                    code = self._last_code
                    err = f"http {code}" \
                        if code is not None and code >= 400 else None
                    trace.finish_trace(self._span, error=err)
                    self._span = None

            def _route_post(self):
                if self.path.startswith("/v1/generate"):
                    self._generate()
                    return
                if self.path.startswith("/v1/kv/"):
                    self._kv()
                    return
                if not self.path.startswith("/v1/predict") \
                        or eng is None:
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    inputs = req["inputs"]
                    if not isinstance(inputs, dict) or not inputs:
                        raise ValueError(
                            "'inputs' must be a non-empty object")
                    feed = {str(k): np.asarray(v)
                            for k, v in inputs.items()}
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                try:
                    outs = eng.predict(
                        feed, timeout_ms=req.get("timeout_ms"))
                except OverloadedError as e:
                    self._reply(503, {"error": str(e),
                                      "retryable": True},
                                headers=_retry_after_hdr(e))
                    return
                except QueueFullError as e:
                    self._reply(503, {"error": str(e),
                                      "retryable": True})
                    return
                except DeadlineExceededError as e:
                    self._reply(504, {"error": str(e)})
                    return
                except EngineClosedError as e:
                    self._reply(503, {"error": str(e),
                                      "retryable": False})
                    return
                except ValueError as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                names = eng.output_names()
                self._reply(200, {
                    "outputs": {n: o.tolist()
                                for n, o in zip(names, outs)},
                    "shapes": {n: list(o.shape)
                               for n, o in zip(names, outs)},
                })

            def _generate(self):
                from .generation import GenerationRequest
                if gen is None:
                    self._reply(404, {"error": "no generation engine "
                                               "attached"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    greq = GenerationRequest(
                        prompt=req["prompt"],
                        max_new_tokens=req["max_new_tokens"],
                        temperature=req.get("temperature", 0.0),
                        top_k=req.get("top_k", 0),
                        eos_id=req.get("eos_id"),
                        timeout_ms=req.get("timeout_ms"),
                        seed=req.get("seed", 0),
                        spec_decode=req.get("spec_decode"))
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                try:
                    out = gen.submit(greq).result()
                except OverloadedError as e:
                    self._reply(503, {"error": str(e),
                                      "retryable": True},
                                headers=_retry_after_hdr(e))
                    return
                except QueueFullError as e:
                    self._reply(503, {"error": str(e),
                                      "retryable": True})
                    return
                except DeadlineExceededError as e:
                    self._reply(504, {"error": str(e)})
                    return
                except EngineClosedError as e:
                    self._reply(503, {"error": str(e),
                                      "retryable": False})
                    return
                except ValueError as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                self._reply(200, out)

            def _kv(self):
                """Disaggregated KV transfer (serving/disagg.py):
                /v1/kv/export packs a prompt's full-block prefix into a
                kv_wire shipment; /v1/kv/adopt unpacks one into the
                local pool. 404 unless a paged generation engine is
                attached."""
                from . import disagg
                if gen is None or not getattr(gen, "paged", False):
                    self._reply(404, {"error": "no paged generation "
                                               "engine attached"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                try:
                    if self.path.startswith("/v1/kv/export"):
                        route = "export"
                        out = disagg.export_prefix(
                            gen, req["prompt"],
                            run_prefill=bool(
                                req.get("run_prefill", True)))
                    elif self.path.startswith("/v1/kv/adopt"):
                        route = "adopt"
                        out = disagg.adopt_prefix(gen, req)
                    else:
                        self._reply(404, {"error":
                                          f"no route {self.path}"})
                        return
                except (KeyError, ValueError, TypeError) as e:
                    self._reply(400, {"error": f"bad request: {e}"})
                    return
                except OverloadedError as e:
                    self._reply(503, {"error": str(e),
                                      "retryable": True},
                                headers=_retry_after_hdr(e))
                    return
                except QueueFullError as e:
                    self._reply(503, {"error": str(e),
                                      "retryable": True})
                    return
                except DeadlineExceededError as e:
                    self._reply(504, {"error": str(e)})
                    return
                except EngineClosedError as e:
                    self._reply(503, {"error": str(e),
                                      "retryable": False})
                    return
                if outer.kv_hook is not None:
                    outer.kv_hook(route, gen, req, out)
                self._reply(200, out)

            def log_message(self, *args):
                pass  # request logging goes through the monitor, not
                # stderr

        self.engine = engine
        # SLO alerting rides on the serving lifecycle: a front end with
        # FLAGS_alert_rules set gets the background evaluator for free
        # (no-op when no rules are configured).
        monitor_alerts.maybe_start()
        self._srv = http.server.ThreadingHTTPServer((host, port),
                                                    _Handler)
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        name="ptt-serving-http",
                                        daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"http://{host}:{port}"

    def inflight(self) -> int:
        with self._inflight_cv:
            return self._inflight

    def close(self, drain: bool = True, timeout: float = 10.0):
        """Stop accepting, optionally wait (bounded) for in-flight POSTs
        to finish, then release the socket. Requests arriving on live
        keep-alive connections after close() begins answer a retryable
        503 instead of a connection reset."""
        with self._inflight_cv:
            self._draining = True
        self._srv.shutdown()
        if drain:
            deadline = time.monotonic() + max(0.0, timeout)
            with self._inflight_cv:
                while self._inflight > 0:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._inflight_cv.wait(left)
        self._srv.server_close()

    # the router's replica lifecycle speaks stop(); same semantics
    stop = close


def serve(engine: Optional[ServingEngine] = None,
          port: Optional[int] = None,
          gen_engine=None,
          async_start: bool = False) -> ServingHTTPServer:
    """Start the engine(s) (if not already started) and expose them
    over HTTP. port=None reads EngineConfig.http_port when a
    ServingEngine is attached (itself defaulted from
    FLAGS_serving_http_port; 0 binds an ephemeral port).

    async_start=True binds the port first and runs the engine starts
    (warmup compiles) on a background thread, so /healthz answers 503
    ``{"state": "warming"}`` during warmup instead of the connection
    being refused — the readiness-probe contract load balancers
    expect."""
    def _start_engines():
        if engine is not None:
            engine.start()
        if gen_engine is not None:
            gen_engine.start()

    if port is None:
        port = engine.config.http_port if engine is not None else 0
    if async_start:
        srv = ServingHTTPServer(engine, port=port,
                                gen_engine=gen_engine)
        threading.Thread(target=_start_engines,
                         name="ptt-serving-warmup",
                         daemon=True).start()
        return srv
    _start_engines()
    return ServingHTTPServer(engine, port=port, gen_engine=gen_engine)
