"""Multi-replica serving router: the front tier over N engine replicas.

The JAX package's `serving/router.py` over this package's engines, with
the same policy, stats, spans and HTTP protocol:

- **Least-loaded dispatch.** Every `Replica` exposes its instantaneous
  load (ServingEngine batcher rows + GenerationEngine queued/active
  slots + the router's own in-flight count); `POST /v1/predict` and
  `/v1/generate` go to the healthy replica with the smallest load.
- **Health gating.** An active probe loop polls each replica
  (`/healthz` for ``url=`` replicas, `engine.health()` in-process) on
  FLAGS_router_probe_interval_s, and a per-replica `CircuitBreaker`
  does passive failure accounting on the dispatch path — either signal
  routes traffic around a sick replica.
- **Failover.** A retryable dispatch failure (replica death, 503 shed,
  connection reset) re-dispatches the request to a different healthy
  replica, bounded by FLAGS_router_redispatch_budget and honoring the
  replica's ``Retry-After`` backoff. Requests here are idempotent
  (predict is pure; generation is seeded), so a re-dispatch can never
  produce a different answer. Deadline expiries and malformed requests
  are NOT retried.
- **Session affinity.** `generate(..., session=)` pins a session to
  one replica while it stays healthy, so its KV prefix cache keeps
  paying; affinity breaks (and re-pins) the moment the pinned replica
  leaves the healthy set. The pins are LRU-bounded
  (FLAGS_router_affinity_max).
- **Zero-downtime hot-swap.** `hot_swap(old, standby)` warms the
  standby through its full warmup while the old replica keeps serving,
  refuses to flip if the standby added executor cache entries after
  its warmup (`post_warmup_compiles()`), atomically swaps the routing
  table, then drains the old replica to zero in-flight (bounded by
  FLAGS_router_drain_timeout_s) before stopping it.
- **Preemption-aware membership.** `preempt(name)` (wired to SIGTERM
  via `install_sigterm`, chaining any previous handler like
  resilience/trainer_guard.py) deregisters a replica without killing
  its in-flight work; `resume(name)` re-registers it. The router sheds
  load (OverloadedError → 503 + Retry-After) only when *every* replica
  is out.
- **Disaggregated prefill/decode** (FLAGS_router_disagg): `generate`
  picks the decode replica first and, unless the fleet prefix store
  says it owns the prompt's full-block chain, has a prefill-capable
  replica export the KV blocks and the decode replica adopt them
  (serving/disagg.py); any transfer failure falls back to a local
  re-prefill, so answers never change.

Spans: each dispatch attempt runs under a ``router.dispatch`` span
(child of the caller's request span). For ``url=`` replicas the
traceparent of that span crosses the hop, so the replica's
``http.request`` span parents under it and one trace covers both tiers.
"""
from __future__ import annotations

import json
import signal
import threading
import time
import urllib.error
import urllib.request
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

from .. import trace
from ..core.flags import FLAGS
from ..monitor import STAT_ADD, STAT_OBSERVE, STAT_SET, flight_record
from ..resilience.breaker import CircuitBreaker
from .batcher import (DeadlineExceededError, EngineClosedError,
                      OverloadedError, QueueFullError)

__all__ = ["Replica", "Router", "RouterHTTP"]

# health() states that keep a replica in the routing table
_ROUTABLE_STATES = ("ok", "ready", "degraded")

# dispatch failures that justify trying another replica (the request
# never ran, or the backend refused/lost it before answering)
_RETRYABLE = (OverloadedError, QueueFullError, EngineClosedError,
              ConnectionError)


class Replica:
    """One backend the router can dispatch to: either in-process
    engines (``engine=`` / ``gen_engine=``, called directly) or a
    remote replica server (``url=``, spoken to over the same JSON
    protocol serving/http.py serves).

    The router only reads/writes a replica through this surface:
    `load()`, `health()`, `predict()`, `generate()`, drain/stop, plus
    the passive-accounting breaker."""

    def __init__(self, name: str, engine=None, gen_engine=None,
                 url: Optional[str] = None, version: str = "v1",
                 failure_threshold: Optional[int] = None,
                 role: str = "unified"):
        if url is None and engine is None and gen_engine is None:
            raise ValueError(f"replica {name!r} needs engine, "
                             "gen_engine, or url")
        if url is not None and (engine is not None
                                or gen_engine is not None):
            raise ValueError(f"replica {name!r}: url= and in-process "
                             "engines are mutually exclusive")
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"replica {name!r}: role must be unified, prefill, or "
                f"decode, got {role!r}")
        self.name = name
        self.engine = engine
        self.gen_engine = gen_engine
        self.url = url.rstrip("/") if url else None
        self.version = version
        self.role = role
        self.registered = True
        self.healthy = True          # last probe verdict
        self.backoff_until = 0.0     # monotonic; Retry-After honor
        self.breaker = CircuitBreaker(
            failure_threshold=(
                failure_threshold if failure_threshold is not None
                else FLAGS.router_failure_threshold),
            name=f"router.{name}")
        self._inflight = 0
        self._cv = threading.Condition()
        self._warm_misses: Optional[int] = None

    # -- lifecycle -------------------------------------------------------

    def start(self, timeout_s: float = 120.0):
        """Warm the replica to readiness: in-process engines run their
        full warmup ladder; a url replica is polled until /healthz
        leaves ``warming``."""
        if self.url is not None:
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                h = self.health()
                if h["state"] in _ROUTABLE_STATES:
                    return
                time.sleep(0.05)
            raise TimeoutError(
                f"replica {self.name!r} at {self.url} did not become "
                f"ready within {timeout_s}s")
        if self.engine is not None:
            self.engine.start()
            self._warm_misses = self.engine.cache_stats()["misses"]
        if self.gen_engine is not None:
            self.gen_engine.start()

    def stop(self, drain: bool = True, timeout: float = 30.0):
        if self.engine is not None:
            self.engine.stop(drain=drain, timeout=timeout)
        if self.gen_engine is not None:
            self.gen_engine.stop(drain=drain, timeout=timeout)

    def post_warmup_compiles(self) -> int:
        """Compiles since start() across both engines — must be 0 for
        a standby to be allowed into the routing table (hot-swap's
        no-compile-storm gate)."""
        n = 0
        if self.gen_engine is not None:
            n += self.gen_engine.post_warmup_compiles()
        if self.engine is not None and self._warm_misses is not None:
            n += self.engine.cache_stats()["misses"] - self._warm_misses
        return n

    # -- routing inputs --------------------------------------------------

    def inflight(self) -> int:
        with self._cv:
            return self._inflight

    def load(self) -> float:
        """Dispatch metric: backend queue depth + requests this router
        already has in flight on the replica (covers the window before
        the backend's own gauges move)."""
        n = float(self.inflight())
        if self.url is not None:
            return n
        if self.engine is not None:
            n += self.engine.load()
        if self.gen_engine is not None:
            n += self.gen_engine.load()
        return n

    def health(self) -> dict:
        """Worst-state-wins across the replica's engines, same ranking
        /healthz uses; url replicas answer their actual /healthz."""
        if self.url is not None:
            return self._remote_health()
        from .http import _STATE_RANK
        worst, retry_after = "ready", 0.0
        for e in (self.engine, self.gen_engine):
            if e is None:
                continue
            h = e.health()
            if _STATE_RANK.get(h["state"], 4) > \
                    _STATE_RANK.get(worst, 4):
                worst = h["state"]
            retry_after = max(retry_after,
                              h.get("retry_after_s") or 0.0)
        return {"state": "ok" if worst == "ready" else worst,
                "retry_after_s": retry_after}

    def _remote_health(self) -> dict:
        try:
            req = urllib.request.Request(self.url + "/healthz")
            with urllib.request.urlopen(req, timeout=2.0) as r:
                body = json.loads(r.read() or b"{}")
                return {"state": body.get("state", "ok"),
                        "retry_after_s": 0.0}
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
            except Exception:
                body = {}
            ra = e.headers.get("Retry-After") if e.headers else None
            return {"state": body.get("state", "open"),
                    "retry_after_s": float(ra) if ra else 0.0}
        except Exception:
            return {"state": "stopped", "retry_after_s": 0.0}

    # -- dispatch --------------------------------------------------------

    def _track(self):
        return _Inflight(self)

    def predict(self, feed: Dict[str, np.ndarray],
                timeout_ms: Optional[float] = None
                ) -> Dict[str, np.ndarray]:
        with self._track():
            if self.url is not None:
                payload = {"inputs": {k: np.asarray(v).tolist()
                                      for k, v in feed.items()}}
                if timeout_ms is not None:
                    payload["timeout_ms"] = timeout_ms
                body = self._post("/v1/predict", payload, timeout_ms)
                return {k: np.asarray(v)
                        for k, v in body["outputs"].items()}
            if self.engine is None:
                raise ValueError(
                    f"replica {self.name!r} has no predict engine")
            outs = self.engine.predict(feed, timeout_ms=timeout_ms)
            return dict(zip(self.engine.output_names(), outs))

    def generate(self, payload: dict) -> dict:
        with self._track():
            if self.url is not None:
                return self._post("/v1/generate", payload,
                                  payload.get("timeout_ms"))
            if self.gen_engine is None:
                raise ValueError(
                    f"replica {self.name!r} has no generation engine")
            from .generation import GenerationRequest
            greq = GenerationRequest(
                prompt=payload["prompt"],
                max_new_tokens=payload["max_new_tokens"],
                temperature=payload.get("temperature", 0.0),
                top_k=payload.get("top_k", 0),
                eos_id=payload.get("eos_id"),
                timeout_ms=payload.get("timeout_ms"),
                seed=payload.get("seed", 0))
            return self.gen_engine.submit(greq).result()

    def kv_export(self, prompt, run_prefill: bool = True) -> dict:
        """Disaggregated prefill: pack the prompt's full-block KV
        prefix into a kv_wire shipment (running chunked prefill through
        the replica's existing executable if not already resident)."""
        with self._track():
            if self.url is not None:
                return self._post(
                    "/v1/kv/export",
                    {"prompt": [int(t) for t in prompt],
                     "run_prefill": bool(run_prefill)}, None)
            if self.gen_engine is None:
                raise ValueError(
                    f"replica {self.name!r} has no generation engine")
            from . import disagg
            return disagg.export_prefix(self.gen_engine, prompt,
                                        run_prefill=run_prefill)

    def kv_adopt(self, payload: dict) -> dict:
        """Disaggregated decode: adopt a kv_wire shipment into the
        replica's local BlockPool/PrefixCache."""
        with self._track():
            if self.url is not None:
                return self._post("/v1/kv/adopt", payload, None)
            if self.gen_engine is None:
                raise ValueError(
                    f"replica {self.name!r} has no generation engine")
            from . import disagg
            return disagg.adopt_prefix(self.gen_engine, payload)

    def _post(self, path: str, payload: dict,
              timeout_ms: Optional[float]) -> dict:
        """POST to the replica server, translating its status codes
        back into the engine exception taxonomy so the router's
        failover logic is transport-agnostic. The current
        ``router.dispatch`` span's traceparent crosses the hop."""
        data = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        sp = trace.current_span()
        if sp is not None:
            headers["traceparent"] = trace.format_traceparent(sp)
        req = urllib.request.Request(self.url + path, data=data,
                                     headers=headers)
        timeout_s = (timeout_ms / 1e3 + 5.0) if timeout_ms else 30.0
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                return json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
            except Exception:
                body = {}
            msg = body.get("error", f"replica answered {e.code}")
            if e.code == 503:
                ra = e.headers.get("Retry-After") if e.headers else None
                if ra:
                    raise OverloadedError(msg,
                                          retry_after_s=float(ra))
                if body.get("retryable", True):
                    raise QueueFullError(msg)
                raise EngineClosedError(msg)
            if e.code == 504:
                raise DeadlineExceededError(msg)
            if e.code == 400:
                raise ValueError(msg)
            raise RuntimeError(f"replica {self.name!r}: {msg}")
        except urllib.error.URLError as e:
            raise ConnectionError(
                f"replica {self.name!r} unreachable: {e.reason}")

    # -- drain -----------------------------------------------------------

    def drain(self, timeout_s: float) -> bool:
        """Wait for in-flight (and in-process backend queues) to reach
        zero. True = fully drained before the deadline."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline:
            if self.inflight() == 0 and (
                    self.url is not None or self.load() == 0):
                return True
            with self._cv:
                self._cv.wait(0.02)
        return self.inflight() == 0

    def _dec(self):
        with self._cv:
            self._inflight -= 1
            if self._inflight == 0:
                self._cv.notify_all()


class _Inflight:
    def __init__(self, rep: Replica):
        self.rep = rep

    def __enter__(self):
        with self.rep._cv:
            self.rep._inflight += 1
        return self

    def __exit__(self, *exc):
        self.rep._dec()
        return False


class Router:
    """Health-gated least-loaded dispatcher over a set of `Replica`s.

    Thread-safe: dispatch, probe loop, hot-swap, and preempt/resume all
    take `_lock` only for table reads/writes — never across a backend
    call, so a slow replica can't wedge the router."""

    def __init__(self, replicas=(), probe_interval_s=None,
                 redispatch_budget=None, drain_timeout_s=None,
                 affinity_max=None, start_probe: bool = True,
                 disagg: Optional[bool] = None):
        from .disagg import FleetPrefixStore
        self.probe_interval_s = float(
            probe_interval_s if probe_interval_s is not None
            else FLAGS.router_probe_interval_s)
        self.disagg = bool(FLAGS.router_disagg if disagg is None
                           else disagg)
        # fleet-level content-addressed prefix registry (chain hash ->
        # owning replica names); maintained even with disagg off so a
        # flag flip needs no restart
        self.prefix_store = FleetPrefixStore()
        self.redispatch_budget = int(
            redispatch_budget if redispatch_budget is not None
            else FLAGS.router_redispatch_budget)
        self.drain_timeout_s = float(
            drain_timeout_s if drain_timeout_s is not None
            else FLAGS.router_drain_timeout_s)
        self.affinity_max = int(
            affinity_max if affinity_max is not None
            else FLAGS.router_affinity_max)
        self._lock = threading.RLock()
        self._replicas: Dict[str, Replica] = {}
        # session -> replica-name pins, LRU-bounded at affinity_max so
        # a stream of short-lived sessions can't grow the map forever
        self._affinity: "OrderedDict[str, str]" = OrderedDict()
        # plain counters mirroring the serving.router_* stats, readable
        # without a monitor scrape (loadgen records them)
        self.requests = 0
        self.redispatches = 0
        self.shed = 0
        self._closed = False
        self._prev_sigterm = None
        self._sigterm_replicas: List[str] = []
        for r in replicas:
            self.add_replica(r)
        self._probe_stop = threading.Event()
        self._probe_thread = None
        if start_probe and self.probe_interval_s > 0:
            self._probe_thread = threading.Thread(
                target=self._probe_loop, name="ptt-router-probe",
                daemon=True)
            self._probe_thread.start()

    # -- membership ------------------------------------------------------

    def add_replica(self, rep: Replica):
        with self._lock:
            if rep.name in self._replicas:
                raise ValueError(f"duplicate replica {rep.name!r}")
            rep.registered = True
            self._replicas[rep.name] = rep
        self._publish_gauges()
        flight_record("router_add_replica", replica=rep.name,
                      version=rep.version)

    def remove_replica(self, name: str, drain: bool = True,
                       stop: bool = False):
        with self._lock:
            rep = self._replicas.pop(name, None)
            self._drop_affinity_locked(name)
        if rep is None:
            return
        rep.registered = False
        # forget its fleet-store blocks: a chain entry pointing at a
        # gone replica would only buy failed transfers
        self.prefix_store.drop_owner(name)
        if drain:
            rep.drain(self.drain_timeout_s)
        if stop and rep.url is None:
            rep.stop()
        self._publish_gauges()

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def _drop_affinity_locked(self, name: str):
        for s, n in list(self._affinity.items()):
            if n == name:
                del self._affinity[s]

    # -- health ----------------------------------------------------------

    def _routable(self, rep: Replica, now: float) -> bool:
        # would_allow, not allow: this runs from read-only paths
        # (gauges, healthz, candidate filtering) and must never consume
        # a HALF_OPEN probe slot — _dispatch claims the slot via
        # allow() on the one replica it actually sends to
        return (rep.registered and rep.healthy
                and now >= rep.backoff_until
                and rep.breaker.would_allow())

    def healthy_replicas(self) -> List[Replica]:
        now = time.monotonic()
        with self._lock:
            reps = list(self._replicas.values())
        return [r for r in reps if self._routable(r, now)]

    def _probe_loop(self):
        while not self._probe_stop.wait(self.probe_interval_s):
            self.probe_once()

    def probe_once(self):
        """One active-probe sweep; callable directly from tests."""
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            try:
                h = rep.health()
                ok = h["state"] in _ROUTABLE_STATES
                ra = h.get("retry_after_s") or 0.0
            except Exception:
                ok, ra = False, 0.0
            if not ok:
                STAT_ADD("serving.router_probe_failures")
                if ra > 0:
                    rep.backoff_until = max(
                        rep.backoff_until, time.monotonic() + ra)
            if ok != rep.healthy:
                flight_record("router_health_flip", replica=rep.name,
                              healthy=ok)
            rep.healthy = ok
        self._publish_gauges()

    def _publish_gauges(self):
        now = time.monotonic()
        with self._lock:
            reps = list(self._replicas.values())
        STAT_SET("serving.router_replicas", len(reps))
        STAT_SET("serving.router_healthy_replicas",
                 sum(1 for r in reps if self._routable(r, now)))

    # -- dispatch --------------------------------------------------------

    # which replica roles may serve each dispatch kind: a prefill-only
    # worker must never absorb decode traffic (or skew least-loaded
    # picks), and vice versa; predict stays on unified replicas
    _KIND_ROLES = {"generate": ("unified", "decode"),
                   "prefill": ("unified", "prefill"),
                   "predict": ("unified",)}

    def _pick(self, kind: str, exclude, session: Optional[str],
              prefer: Optional[str] = None) -> Optional[Replica]:
        roles = self._KIND_ROLES.get(kind, ("unified",))
        now = time.monotonic()
        with self._lock:
            reps = [r for r in self._replicas.values()
                    if r.name not in exclude
                    and r.role in roles
                    and self._routable(r, now)
                    and (r.url is not None
                         or (r.engine if kind == "predict"
                             else r.gen_engine) is not None)]
            if not reps:
                return None
            if prefer is not None:
                for r in reps:
                    if r.name == prefer:
                        if session is not None:
                            self._affinity[session] = r.name
                            self._affinity.move_to_end(session)
                        return r
            if session is not None:
                pinned = self._affinity.get(session)
                if pinned is not None:
                    self._affinity.move_to_end(session)
                for r in reps:
                    if r.name == pinned:
                        STAT_ADD("serving.router_affinity_hits")
                        return r
            best = min(reps, key=lambda r: (r.load(), r.name))
            if session is not None:
                self._affinity[session] = best.name
                self._affinity.move_to_end(session)
                while len(self._affinity) > self.affinity_max:
                    self._affinity.popitem(last=False)
            return best

    def _fleet_retry_after(self) -> float:
        """Max backoff across the fleet — the Retry-After an unhealthy
        router answers with. Pure read: bumps no counters, so healthz
        polls don't inflate the shed stat."""
        now = time.monotonic()
        with self._lock:
            reps = list(self._replicas.values())
        ra = 1.0
        for r in reps:
            ra = max(ra, r.breaker.retry_after_s(),
                     r.backoff_until - now)
        return ra

    def _shed_error(self) -> OverloadedError:
        STAT_ADD("serving.router_shed")
        with self._lock:
            self.shed += 1
        return OverloadedError(
            "no healthy replica (all replicas unhealthy, "
            "backing off, or deregistered)",
            retry_after_s=self._fleet_retry_after())

    def _dispatch(self, kind: str, call, session: Optional[str] = None,
                  prefer: Optional[str] = None):
        STAT_ADD("serving.router_requests")
        with self._lock:
            self.requests += 1
        t0 = time.perf_counter()
        tried = set()
        attempt = 0
        while True:
            # `prefer` only steers the FIRST pick (disagg phase 2:
            # decode must land where the KV was just adopted); failover
            # reverts to least-loaded
            rep = self._pick(kind, tried, session,
                             prefer=prefer if attempt == 0 else None)
            if rep is None:
                # every replica is out (or the budget exhausted the
                # healthy set): shed with Retry-After rather than
                # queueing work nobody can do
                raise self._shed_error()
            if not rep.breaker.allow():
                # raced: another thread claimed the last HALF_OPEN
                # probe slot between _pick's read-only check and here
                tried.add(rep.name)
                continue
            sp = trace.start_span(
                "router.dispatch",
                attrs={"replica": rep.name, "attempt": attempt,
                       "kind": kind})
            try:
                with trace.use_span(sp):
                    out = call(rep)
            except _RETRYABLE as e:
                trace.end_span(sp, error=type(e).__name__)
                rep.breaker.record_failure()
                ra = getattr(e, "retry_after_s", 0.0) or 0.0
                if ra > 0:
                    rep.backoff_until = max(
                        rep.backoff_until, time.monotonic() + ra)
                tried.add(rep.name)
                if session is not None:
                    with self._lock:
                        if self._affinity.get(session) == rep.name:
                            del self._affinity[session]
                attempt += 1
                if attempt > self.redispatch_budget:
                    raise
                STAT_ADD("serving.router_redispatches")
                with self._lock:
                    self.redispatches += 1
                flight_record("router_redispatch", replica=rep.name,
                              attempt=attempt,
                              error=type(e).__name__)
                continue
            except Exception:
                # non-retryable (bad request, deadline): the replica is
                # not at fault — don't punish its breaker, but hand
                # back the probe slot allow() may have claimed
                rep.breaker.release_probe()
                trace.end_span(sp, error="dispatch_error")
                raise
            trace.end_span(sp)
            rep.breaker.record_success()
            STAT_OBSERVE("serving.router_e2e_ms",
                         (time.perf_counter() - t0) * 1e3)
            return out

    def predict(self, feed: Dict[str, np.ndarray],
                timeout_ms: Optional[float] = None
                ) -> Dict[str, np.ndarray]:
        """Route one predict request; returns {output_name: array}."""
        return self._dispatch(
            "predict",
            lambda rep: rep.predict(feed, timeout_ms=timeout_ms))

    def generate(self, payload: dict,
                 session: Optional[str] = None) -> dict:
        """Route one generation request (a /v1/generate-shaped dict).
        `session` pins subsequent calls with the same key to the same
        replica while it stays healthy (KV prefix-cache affinity).
        With disagg on this becomes two-phase prefill->decode
        scheduling (see _generate_disagg)."""
        if self.disagg:
            return self._generate_disagg(payload, session)
        return self._dispatch(
            "generate", lambda rep: rep.generate(payload),
            session=session)

    # -- disaggregated prefill/decode dispatch --------------------------

    def _generate_disagg(self, payload: dict,
                         session: Optional[str] = None) -> dict:
        """Two-phase dispatch: pick the decode replica first (session
        affinity pins to it), consult the fleet prefix store, and only
        when the decode replica does not already own the prompt's
        full-block chain run the prefill hop (export on a
        prefill-capable peer, adopt on the decode replica). Any
        transfer failure — prefill worker death mid-transfer included
        — falls back to plain dispatch: the decode worker re-prefills
        locally, so answers never change, only latency."""
        from .kv_blocks import PrefixCache
        STAT_ADD("serving.disagg_requests")
        rep_d = self._pick("generate", set(), session)
        if rep_d is None:
            raise self._shed_error()
        prompt = [int(t) for t in payload.get("prompt", ())]
        store = self.prefix_store
        bs = store.block_size
        hashes: List[str] = []
        if bs and len(prompt) >= bs:
            hashes = PrefixCache.chunk_hashes(
                prompt[:(len(prompt) // bs) * bs], bs)
        need_xfer = bs is None or bool(
            hashes and store.owned_depth(hashes, rep_d.name)
            < len(hashes))
        if hashes and not need_xfer:
            STAT_ADD("serving.disagg_prefix_reuse")
        if need_xfer and (bs is None or hashes):
            try:
                self._disagg_transfer(prompt, rep_d, hashes, store)
            except Exception as e:
                STAT_ADD("serving.disagg_fallbacks")
                flight_record("disagg_fallback", replica=rep_d.name,
                              error=type(e).__name__)
        sp = trace.start_span("decode", attrs={"replica": rep_d.name})
        try:
            with trace.use_span(sp):
                out = self._dispatch(
                    "generate", lambda rep: rep.generate(payload),
                    session=session, prefer=rep_d.name)
        except Exception as e:
            trace.end_span(sp, error=type(e).__name__)
            raise
        trace.end_span(sp)
        return out

    def _disagg_transfer(self, prompt, rep_d: Replica,
                         hashes: List[str], store):
        """The prefill hop: export the prompt's KV prefix from a
        prefill-capable source and adopt it on the decode replica.
        Raises on any failure — the caller falls back."""
        from . import kv_wire
        src = None
        if hashes:
            owner = store.chain_owner(hashes, exclude=(rep_d.name,))
            if owner is not None:
                with self._lock:
                    cand = self._replicas.get(owner)
                if cand is not None and \
                        self._routable(cand, time.monotonic()):
                    src = cand
        if src is None:
            src = self._pick("prefill", {rep_d.name}, None)
        if src is None:
            raise OverloadedError(
                "no prefill-capable replica for KV transfer")
        t0 = time.perf_counter()
        sp = trace.start_span(
            "prefill", attrs={"replica": src.name,
                              "prompt_tokens": len(prompt)})
        try:
            with trace.use_span(sp):
                shipment = src.kv_export(prompt)
        except Exception as e:
            trace.end_span(sp, error=type(e).__name__)
            raise
        trace.end_span(sp)
        store.learn_block_size(int(shipment.get("block_size") or 0))
        hs = [str(h) for h in shipment.get("chain_hashes", ())]
        if not hs:
            return
        store.register(hs, src.name)
        nbytes = kv_wire.payload_bytes(shipment)
        sp = trace.start_span(
            "fetch", attrs={"src": src.name, "dst": rep_d.name,
                            "blocks": len(hs), "bytes": nbytes})
        try:
            with trace.use_span(sp):
                res = rep_d.kv_adopt(shipment)
        except Exception as e:
            trace.end_span(sp, error=type(e).__name__)
            raise
        trace.end_span(sp)
        resident = int(res.get("resident") or 0)
        if resident:
            store.register(hs[:resident], rep_d.name)
        STAT_ADD("serving.kv_xfer_blocks", len(hs))
        STAT_ADD("serving.kv_xfer_bytes", nbytes)
        STAT_OBSERVE("serving.kv_xfer_ms",
                     (time.perf_counter() - t0) * 1e3)

    # -- elasticity: hot swap -------------------------------------------

    def hot_swap(self, old_name: str, standby: Replica,
                 drain_timeout_s: Optional[float] = None) -> dict:
        """Zero-downtime model swap: warm `standby` through its full
        ladder while `old_name` keeps serving, gate on zero
        post-warmup compiles, atomically flip the table, drain the old
        replica, stop it. `standby.name == old_name` is allowed (the
        restart-with-new-weights pattern); any other name collision is
        rejected before the standby is ever started, and an abort on
        any later gate stops the standby so no warmed engine leaks.
        Call from any thread — traffic keeps flowing the whole time."""
        timeout = (drain_timeout_s if drain_timeout_s is not None
                   else self.drain_timeout_s)

        def _check_collision():
            # lock held; same-name swap is fine — old_name is popped
            # in the same critical section the standby goes in
            if standby.name != old_name and \
                    standby.name in self._replicas:
                raise ValueError(
                    f"duplicate replica {standby.name!r}")

        with self._lock:
            _check_collision()
        try:
            standby.start()
            compiles = standby.post_warmup_compiles()
            if compiles:
                raise RuntimeError(
                    f"hot-swap aborted: standby {standby.name!r} "
                    f"would compile in the serving path "
                    f"({compiles} post-warmup compiles)")
            with self._lock:
                _check_collision()   # re-check: add_replica may race
                old = self._replicas.pop(old_name, None)
                standby.registered = True
                self._replicas[standby.name] = standby
                self._drop_affinity_locked(old_name)
        except BaseException:
            try:
                standby.stop(drain=False)
            except Exception:
                pass
            raise
        self._publish_gauges()
        drained = True
        if old is not None:
            old.registered = False
            drained = old.drain(timeout)
            if old.url is None:
                old.stop(drain=True)
        STAT_ADD("serving.router_hot_swaps")
        flight_record("router_hot_swap", old=old_name,
                      new=standby.name, version=standby.version,
                      drained=drained)
        return {"swapped": True, "old": old_name,
                "new": standby.name, "version": standby.version,
                "drained": bool(drained),
                "standby_post_warmup_compiles": int(compiles)}

    # -- elasticity: preemption -----------------------------------------

    def preempt(self, name: str):
        """Deregister a replica (SIGTERM path): no new dispatches, but
        in-flight work finishes. The replica object stays known so
        `resume` can re-register it."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                return
            rep.registered = False
            self._drop_affinity_locked(name)
        STAT_ADD("serving.router_preemptions")
        flight_record("router_preempt", replica=name)
        self._publish_gauges()

    def resume(self, name: str):
        """Re-register a previously preempted replica."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                return
            rep.registered = True
            rep.healthy = True
            rep.backoff_until = 0.0
        flight_record("router_resume", replica=name)
        self._publish_gauges()

    def install_sigterm(self, *names: str):
        """Route SIGTERM through `preempt` for the named replicas,
        chaining any previously installed handler (same pattern as
        resilience/trainer_guard.py). No-op off the main thread —
        callers there use `preempt()` directly."""
        self._sigterm_replicas = list(names)
        if self._prev_sigterm is not None:
            return  # already installed; just updated the name list

        def _on_term(signum, frame):
            for n in self._sigterm_replicas:
                self.preempt(n)
            prev = self._prev_sigterm
            if callable(prev) and prev not in (signal.SIG_DFL,
                                               signal.SIG_IGN):
                prev(signum, frame)

        try:
            self._prev_sigterm = signal.getsignal(signal.SIGTERM)
            signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            self._prev_sigterm = None

    # -- aggregate health ------------------------------------------------

    def healthz(self) -> tuple:
        """(http_code, body, retry_after_s) for the router's /healthz:
        200 while at least one replica is routable, else 503 with the
        fleet's max Retry-After."""
        now = time.monotonic()
        with self._lock:
            reps = list(self._replicas.values())
        detail = {r.name: {"registered": r.registered,
                           "healthy": r.healthy,
                           "version": r.version,
                           "role": r.role,
                           "load": r.load()} for r in reps}
        # informational only — a firing SLO alert never makes the
        # router stop routing (monitor_alerts.py)
        from .. import monitor_alerts
        firing = monitor_alerts.firing_count()
        if any(self._routable(r, now) for r in reps):
            return 200, {"state": "ok", "replicas": detail,
                         "alerts_firing": firing}, 0.0
        return 503, {"state": "open", "replicas": detail,
                     "alerts_firing": firing}, \
            self._fleet_retry_after()

    def close(self, stop_replicas: bool = False):
        self._closed = True
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)
            self._probe_thread = None
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._prev_sigterm = None
        if stop_replicas:
            for rep in self.replicas():
                if rep.url is None:
                    rep.stop()


class RouterHTTP:
    """HTTP front end for a Router — same JSON protocol as the
    per-replica ServingHTTPServer (so clients can't tell a router from
    a replica), plus `X-Session-Id` / body ``"session"`` for
    generation affinity. Drains in-flight requests on close, like the
    replica server."""

    def __init__(self, router: Router, port: int = 0,
                 host: str = "127.0.0.1"):
        import http.server

        rt = router
        self.router = router
        # same lifecycle hook as ServingHTTPServer: a router front end
        # with FLAGS_alert_rules set runs the SLO evaluator
        from .. import monitor_alerts
        monitor_alerts.maybe_start()
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self._draining = False
        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            _span = None
            _last_code = None

            def _reply(self, code, payload, headers=None):
                self._last_code = code
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if self._span is not None:
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

            def do_GET(self):
                STAT_ADD("serving.http_requests")
                if self.path.startswith("/healthz"):
                    code, body, ra = rt.healthz()
                    hdrs = None
                    if code != 200 and ra > 0:
                        hdrs = {"Retry-After":
                                str(max(1, int(round(ra))))}
                    self._reply(code, body, headers=hdrs)
                elif self.path.startswith("/metrics"):
                    from ..monitor import prometheus_text
                    body = prometheus_text().encode()
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/plain; version=0.0.4")
                    self.send_header("Content-Length",
                                     str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/alertz"):
                    from .. import monitor_alerts
                    self._reply(200, monitor_alerts.alertz_dict())
                else:
                    self._reply(404,
                                {"error": f"no route {self.path}"})

            def do_POST(self):
                STAT_ADD("serving.http_requests")
                with outer._inflight_cv:
                    if outer._draining:
                        draining = True
                    else:
                        draining = False
                        outer._inflight += 1
                if draining:
                    self._reply(503, {"error": "router is draining",
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
                    remote = trace.parse_traceparent(
                        self.headers.get("traceparent"))
                    self._span = trace.start_span(
                        "http.request", remote=remote,
                        attrs={"method": "POST", "tier": "router",
                               "path": self.path.split("?")[0]})
                try:
                    with trace.use_span(self._span):
                        self._route_post()
                except BaseException as e:
                    trace.finish_trace(
                        self._span,
                        error=f"{type(e).__name__}: {e}")
                    self._span = None
                    raise
                else:
                    code = self._last_code
                    err = f"http {code}" \
                        if code is not None and code >= 400 else None
                    trace.finish_trace(self._span, error=err)
                    self._span = None

            def _route_post(self):
                try:
                    length = int(
                        self.headers.get("Content-Length", 0))
                    req = json.loads(
                        self.rfile.read(length) or b"{}")
                except (ValueError, json.JSONDecodeError) as e:
                    self._reply(400,
                                {"error": f"bad request: {e}"})
                    return
                try:
                    if self.path.startswith("/v1/predict"):
                        inputs = req["inputs"]
                        if not isinstance(inputs, dict) or not inputs:
                            raise ValueError(
                                "'inputs' must be a non-empty object")
                        feed = {str(k): np.asarray(v)
                                for k, v in inputs.items()}
                        outs = rt.predict(
                            feed, timeout_ms=req.get("timeout_ms"))
                        self._reply(200, {
                            "outputs": {n: o.tolist()
                                        for n, o in outs.items()},
                            "shapes": {n: list(o.shape)
                                       for n, o in outs.items()}})
                    elif self.path.startswith("/v1/generate"):
                        session = req.pop("session", None) or \
                            self.headers.get("X-Session-Id")
                        if "prompt" not in req or \
                                "max_new_tokens" not in req:
                            raise ValueError(
                                "'prompt' and 'max_new_tokens' are "
                                "required")
                        out = rt.generate(req, session=session)
                        self._reply(200, out)
                    else:
                        self._reply(404, {"error":
                                          f"no route {self.path}"})
                except OverloadedError as e:
                    hdrs = None
                    s = getattr(e, "retry_after_s", 0.0) or 0.0
                    if s > 0:
                        hdrs = {"Retry-After":
                                str(max(1, int(round(s))))}
                    self._reply(503, {"error": str(e),
                                      "retryable": True},
                                headers=hdrs)
                except QueueFullError as e:
                    self._reply(503, {"error": str(e),
                                      "retryable": True})
                except DeadlineExceededError as e:
                    self._reply(504, {"error": str(e)})
                except (EngineClosedError, ConnectionError) as e:
                    self._reply(503, {"error": str(e),
                                      "retryable": False})
                except (KeyError, TypeError, ValueError) as e:
                    self._reply(400,
                                {"error": f"bad request: {e}"})

            def log_message(self, *args):
                pass

        self._srv = http.server.ThreadingHTTPServer((host, port),
                                                    _Handler)
        self._thread = threading.Thread(
            target=self._srv.serve_forever,
            name="ptt-router-http", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._srv.server_address[:2]
        return f"http://{host}:{port}"

    def close(self, drain: bool = True, timeout: float = 10.0):
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

    stop = close
