"""Continuous-batching generation: slot-based KV-cache decode serving.

The JAX package's `serving/generation.py` over this package's decode
programs (`models/gpt.py`), with the same scheduler, stats, spans and
failure envelope. Iteration-level scheduling: the scheduler re-decides
the batch BETWEEN decode steps, so a finished request's slot is handed to
a queued request at once rather than when the whole batch finishes.

Every step feeds the same fixed shapes. The slab decode step
(`build_decode_step`) carries a per-slot `decode_pos` vector plus
`slot_reset`/`slot_active` feeds: a new request joins a running batch by
feeding reset=1 on its slot, and an empty slot rides along muted with
active=0. Admission, prefill, sampling (on the host,
`models/sampling.py`), eviction and re-admission never present the
executor a new feed signature, so after `start()` its cache gains no
entry: `post_warmup_compiles()` (new executor cache entries since warmup)
stays 0 for the engine's lifetime.

Queueing reuses the `batcher.py` vocabulary: a bounded queue with
`QueueFullError` backpressure, per-request deadlines failing with
`DeadlineExceededError`, `EngineClosedError` + drain semantics on
shutdown, `_Response` future handles.

Paged KV (FLAGS_gen_paged_kv, the default): K/V lives in per-layer pools
of fixed-size blocks (`serving/kv_blocks.py`), addressed through per-slot
block tables fed to the `paged_attention` op every step. Admission gates
on free blocks; a slot "reset" is releasing its blocks to the pool; and
shared prompt prefixes hit a content-hash `PrefixCache`, so identical
prompt prefixes reuse the same physical blocks and skip their prefill.
Long prompts retire through a second fixed-shape program that prefills a
whole block per step (chunked prefill), interleaved with the decode
batch. Both programs run once in `start()`.

Speculative decoding (FLAGS_gen_spec_decode / GenerationRequest
.spec_decode, paged engines only): a host-side n-gram drafter
(`serving/spec_decode.py`) proposes up to FLAGS_spec_decode_k tokens per
slot between steps, and a third fixed-shape program, the `[max_slots,
k+1]` verify step (`models/gpt.build_spec_verify_step`), scores every
draft position in one pass. `models/sampling.accept_draft` commits the
longest agreeing prefix through the same sample_token path as serial
decode, so outputs stay token-for-token identical at any temperature.
The verify program also runs once in `start()`.

A step that raises after its dispatch (a CUDA error is a RuntimeError,
from a launch or from the sync at fetch) fails the requests that were in
it and releases their slots; it is never retried, because the KV state
already advanced. Only an injected TransientFault, fired before the
dispatch, is retried.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from .. import goodput as _goodput
from .. import trace
from ..monitor import STAT_ADD, STAT_OBSERVE, STAT_SET
from ..monitor import enabled as _monitor_on
from ..resilience.breaker import CLOSED, HALF_OPEN, OPEN, CircuitBreaker
from ..resilience.faults import TransientFault
from ..resilience.faults import injector as _fault_injector
from ..resilience.retry import RetryPolicy, is_transient
from .batcher import (DeadlineExceededError, EngineClosedError,
                      FRACTION_BUCKETS, MS_BUCKETS, OverloadedError,
                      QueueFullError, ServingError, _Response)
from .kv_blocks import BlockPool, PrefixCache, blocks_for_tokens

__all__ = ["GenerationRequest", "SlotManager", "GenerationEngine"]

# Effective tokens committed per verify step: 1 (full reject) through
# spec_k + 1 (full accept + bonus token). Count-valued, so the ms/
# fraction bucket ladders don't fit; upper rungs leave headroom for
# larger FLAGS_spec_decode_k settings.
SPEC_TOKEN_BUCKETS = (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 12.0, 16.0)


class GenerationRequest:
    """One generation job: prompt in, up to `max_new_tokens` out.

    `temperature`/`top_k` select the sampling policy (see
    models/sampling.py; temperature 0 = greedy, fully deterministic
    given `seed`). `eos_id` stops the request early when sampled.
    `timeout_ms` is a wall-clock deadline covering queue wait AND
    decode; None falls back to the engine default. `stream_cb(token_id)`
    fires from the engine thread after every generated token — the
    streaming hook (and a client's TTFT/inter-token probe).
    `spec_decode` opts this request in/out of speculative decoding
    (serving/spec_decode.py): None defers to the engine default
    (FLAGS_gen_spec_decode), False forces plain one-token decode, True
    speculates when the engine carries the verify program (and
    degrades silently to plain decode when it does not — outputs are
    identical either way, only the step count changes).
    """

    __slots__ = ("prompt", "max_new_tokens", "temperature", "top_k",
                 "eos_id", "timeout_ms", "seed", "stream_cb",
                 "spec_decode")

    def __init__(self, prompt: Sequence[int], max_new_tokens: int,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None,
                 timeout_ms: Optional[float] = None, seed: int = 0,
                 stream_cb: Optional[Callable[[int], None]] = None,
                 spec_decode: Optional[bool] = None):
        self.prompt = [int(t) for t in prompt]
        if not self.prompt:
            raise ValueError("GenerationRequest: prompt must be "
                             "non-empty")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("GenerationRequest: max_new_tokens must "
                             "be >= 1")
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.timeout_ms = timeout_ms
        self.seed = int(seed)
        self.stream_cb = stream_cb
        self.spec_decode = None if spec_decode is None \
            else bool(spec_decode)


class SlotManager:
    """Free-list over the decode graph's B slots.

    Owned by the engine worker thread (admission and eviction both
    happen between steps on that thread), so no internal locking.
    """

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("SlotManager: need at least one slot")
        self.n_slots = int(n_slots)
        self._free = list(range(self.n_slots - 1, -1, -1))  # pop() -> 0 first

    def acquire(self) -> Optional[int]:
        """Lowest free slot index, or None when fully occupied."""
        return self._free.pop() if self._free else None

    def release(self, slot: int):
        if slot in self._free or not 0 <= slot < self.n_slots:
            raise ValueError(f"SlotManager: bad release of slot {slot}")
        self._free.append(slot)
        self._free.sort(reverse=True)

    def free_count(self) -> int:
        return len(self._free)

    def active_count(self) -> int:
        return self.n_slots - len(self._free)


class _SlotState:
    """Per-occupied-slot decode progress (worker-thread private)."""

    __slots__ = ("req", "response", "fed", "cur", "generated", "rng",
                 "needs_reset", "deadline", "t_submit", "t_prev_token",
                 "ttft_ms", "blocks", "n_cached", "registered",
                 "span", "phase_span", "fetch_s",
                 "spec_k_cur", "spec_acc_ewma")

    def __init__(self, req: GenerationRequest, response: _Response,
                 deadline: Optional[float], t_submit: float):
        self.req = req
        self.response = response
        self.fed = 0                  # tokens already stepped (== the
        #                               slot's next KV write position)
        self.cur = req.prompt[0]      # next token to feed
        self.generated: List[int] = []
        self.rng = np.random.RandomState(req.seed)
        self.needs_reset = True       # feed slot_reset=1 on first step
        self.deadline = deadline
        self.t_submit = t_submit
        self.t_prev_token: Optional[float] = None
        self.ttft_ms: Optional[float] = None
        # paged-KV bookkeeping: the slot's block table (shared prefix
        # blocks first, then owned), prefix-cache hit length in tokens,
        # and whether the full prompt blocks have been registered
        self.blocks: List[int] = []
        self.n_cached = 0
        self.registered = False
        # Tracing: the request span (carried over from _Queued — spans
        # cross the submit -> worker thread hand-off ON these objects),
        # the current lifecycle phase span (prefill, then decode), and
        # accumulated fetch-block seconds from the steps this slot rode.
        self.span = None
        self.phase_span = None
        self.fetch_s = 0.0
        # adaptive speculative decoding: per-slot draft budget and
        # acceptance-rate EWMA (None until the first measured ratio)
        self.spec_k_cur: Optional[int] = None
        self.spec_acc_ewma: Optional[float] = None


class _Queued:
    __slots__ = ("req", "response", "deadline", "t_submit",
                 "span", "qspan")

    def __init__(self, req, response, deadline, t_submit):
        self.req = req
        self.response = response
        self.deadline = deadline
        self.t_submit = t_submit
        self.span = None   # request span (hand-off to the worker)
        self.qspan = None  # its queue-wait child


class GenerationEngine:
    """Iteration-level (continuous-batching) generation service.

    Construct with a trained `scope` (weights under the training-graph
    names) and the model's TransformerConfig; the engine builds its own
    `max_slots`-wide decode program whose STATE names carry
    `state_prefix`, so it can share the scope with training graphs or a
    serial batch=1 decode graph without collision. `exe` defaults to an
    `Executor()` on the card. Lifecycle mirrors `ServingEngine`:
    `start()` (state init + one warmup step per program: every executor
    cache entry of the engine's lifetime), `submit`/`generate` from any
    thread, `stop(drain=True)`.
    """

    def __init__(self, cfg, scope, exe=None,
                 max_slots: Optional[int] = None,
                 max_seq: Optional[int] = None,
                 queue_capacity: Optional[int] = None,
                 default_timeout_ms: Optional[float] = None,
                 state_prefix: str = "gen.",
                 paged: Optional[bool] = None,
                 block_size: Optional[int] = None,
                 kv_pool_blocks: Optional[int] = None,
                 spec_decode: Optional[bool] = None,
                 spec_k: Optional[int] = None,
                 spec_adaptive: Optional[bool] = None):
        import paddle_tpu_torch as ptt
        from ..core.flags import FLAGS
        from ..models import gpt

        self.cfg = cfg
        self.scope = scope
        self.exe = exe if exe is not None else ptt.Executor()
        self.max_slots = int(max_slots if max_slots is not None
                             else FLAGS.serving_max_batch_size)
        self.max_seq = int(max_seq if max_seq is not None
                           else cfg.max_seq_len)
        self.queue_capacity = int(queue_capacity
                                  if queue_capacity is not None
                                  else FLAGS.serving_queue_capacity)
        self.default_timeout_ms = (
            default_timeout_ms if default_timeout_ms is not None
            else FLAGS.serving_default_timeout_ms)
        self.paged = bool(FLAGS.gen_paged_kv if paged is None else paged)
        # the decode-step program(s); their startup is never run (it
        # would re-init the shared trained weights) — state is seeded
        # by _ensure_decode_state in start()
        self._prog = ptt.Program()
        self._startup = ptt.Program()
        self._prefill_prog = None
        self._pool: Optional[BlockPool] = None
        self._prefix: Optional[PrefixCache] = None
        if self.paged:
            self.block_size = int(
                min(block_size if block_size is not None
                    else FLAGS.gen_kv_block_size, self.max_seq))
            self.num_blocks = self._resolve_pool_blocks(kv_pool_blocks)
            with ptt.program_guard(self._prog, self._startup):
                self.step = gpt.build_paged_decode_step(
                    cfg, batch=self.max_slots, max_seq=self.max_seq,
                    block_size=self.block_size,
                    num_blocks=self.num_blocks, seq_tokens=1,
                    state_prefix=state_prefix)
            # the second program of the lifetime: retires one whole
            # block of prompt per row per step
            self._prefill_prog = ptt.Program()
            self._prefill_startup = ptt.Program()
            with ptt.program_guard(self._prefill_prog,
                                     self._prefill_startup):
                self.prefill_step = gpt.build_paged_decode_step(
                    cfg, batch=self.max_slots, max_seq=self.max_seq,
                    block_size=self.block_size,
                    num_blocks=self.num_blocks,
                    seq_tokens=self.block_size,
                    state_prefix=state_prefix, with_logits=False)
            self._pool = BlockPool(self.num_blocks, self.block_size)
            self._prefix = PrefixCache(self._pool)
        else:
            spec_decode = False  # the slab graph has no verify substrate
            self.block_size = 0
            self.num_blocks = 0
            with ptt.program_guard(self._prog, self._startup):
                self.step = gpt.build_decode_step(
                    cfg, batch=self.max_slots, max_seq=self.max_seq,
                    state_prefix=state_prefix)
        # speculative decoding (serving/spec_decode.py): paged-only —
        # the verify step is the third and last fixed-shape program,
        # sharing the decode/prefill programs' K/V pools via
        # state_prefix. Engines with spec off build nothing extra and
        # keep the two-program warmup unchanged.
        self.spec_decode = bool(FLAGS.gen_spec_decode
                                if spec_decode is None else spec_decode)
        self.spec_k = int(spec_k if spec_k is not None
                          else FLAGS.spec_decode_k)
        self._spec_prog = None
        self.spec_step = None
        self._drafter = None
        if self.spec_decode and self.spec_k >= 1:
            from .spec_decode import NgramDrafter
            self._spec_prog = ptt.Program()
            self._spec_startup = ptt.Program()
            with ptt.program_guard(self._spec_prog,
                                     self._spec_startup):
                self.spec_step = gpt.build_spec_verify_step(
                    cfg, batch=self.max_slots, max_seq=self.max_seq,
                    block_size=self.block_size,
                    num_blocks=self.num_blocks, k=self.spec_k,
                    state_prefix=state_prefix)
            self._drafter = NgramDrafter(
                max_ngram=int(FLAGS.spec_decode_ngram), k=self.spec_k)
        else:
            self.spec_decode = False
        # acceptance-aware adaptive draft length: host-side only (the
        # verify program is still [max_slots, spec_k+1]); a slot
        # whose measured acceptance stops paying for the verify premium
        # shrinks its own proposal budget toward 1
        self.spec_adaptive = bool(
            FLAGS.spec_decode_adaptive if spec_adaptive is None
            else spec_adaptive) and self.spec_decode
        self._slots = SlotManager(self.max_slots)
        self._state: List[Optional[_SlotState]] = \
            [None] * self.max_slots
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[_Queued] = []
        self._closed = False
        self._draining = True
        self._worker: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._warm_misses: Optional[int] = None
        # resilience: a failed decode step fails the requests that were
        # mid-step (their KV state is unreplayable) but never the
        # worker; repeated failures trip the breaker and submissions
        # shed with OverloadedError
        self._breaker = CircuitBreaker(name="generation")
        self._step_retry = RetryPolicy(
            is_retryable=lambda e: isinstance(e, TransientFault))
        self._engine_state = "warming"  # warming -> ready -> stopped
        # serializes the paged KV structures (BlockPool, PrefixCache and
        # the pool tensors the scope holds) between the worker's
        # iteration and a cross-process export/adopt (serving/disagg.py)
        self._kv_mutex = threading.Lock()

    # -- paged-pool sizing ----------------------------------------------
    def kv_block_bytes(self) -> int:
        """Device bytes one block occupies across every layer's K+V
        pool (float32)."""
        if not self.paged:
            return 0
        return 2 * self.cfg.n_layers * self.block_size * \
            self.cfg.d_model * 4

    def kv_pool_bytes(self) -> int:
        """Total K/V pool device bytes across layers."""
        if not self.paged:
            return 2 * self.cfg.n_layers * self.max_slots * \
                self.max_seq * self.cfg.d_model * 4
        return self.num_blocks * self.kv_block_bytes()

    def _resolve_pool_blocks(self, kv_pool_blocks) -> int:
        """Pool size precedence: ctor arg > FLAGS_gen_kv_pool_blocks >
        FLAGS_gen_kv_pool_bytes (budget // block_bytes) > full capacity
        (every slot can hold max_seq — no eviction pressure, but also
        no savings; production sets the budget)."""
        from ..core.flags import FLAGS
        per_slot = blocks_for_tokens(self.max_seq, self.block_size)
        if kv_pool_blocks is not None:
            # an explicit ctor arg is honored exactly (tests build
            # deliberately tight pools; submit reports requests that
            # can never fit) — only the BlockPool minimum applies
            return max(int(kv_pool_blocks), 2)
        if FLAGS.gen_kv_pool_blocks > 0:
            n = int(FLAGS.gen_kv_pool_blocks)
        elif FLAGS.gen_kv_pool_bytes > 0:
            block_bytes = 2 * self.cfg.n_layers * self.block_size * \
                self.cfg.d_model * 4
            n = int(FLAGS.gen_kv_pool_bytes) // block_bytes
        else:
            n = self.max_slots * per_slot + 1
        # floor: scratch + one slot's worth, or nothing ever admits
        return max(n, per_slot + 1)

    # -- lifecycle -------------------------------------------------------
    def start(self):
        """Seed the decode state on the executor's place, run one warmup
        step per program (slab: one; paged: decode + chunk prefill, and
        the verify step when speculating — every executor cache entry of
        the engine's lifetime, slots muted), then start the worker
        thread."""
        if self._worker is not None:
            return self
        from ..models import gpt
        blk = self._prog.global_block()
        gpt._ensure_decode_state(self.scope, blk, self.step.cache_names,
                                 self.exe.place)
        if self.paged:
            B = self.max_slots
            mb = self.step.max_blocks_per_slot
            self._run_paged(self._prog, self.step,
                            np.zeros((B, 1), np.int64),
                            np.zeros((B, mb), np.int64),
                            np.zeros(B, np.int64),
                            np.zeros(B, np.int64))
            self._run_paged(self._prefill_prog, self.prefill_step,
                            np.zeros((B, self.block_size), np.int64),
                            np.zeros((B, mb), np.int64),
                            np.zeros(B, np.int64),
                            np.zeros(B, np.int64))
            if self.spec_step is not None:
                # the verify program's one cache entry of the lifetime
                self._run_paged(self._spec_prog, self.spec_step,
                                np.zeros((B, self.spec_k + 1),
                                         np.int64),
                                np.zeros((B, mb), np.int64),
                                np.zeros(B, np.int64),
                                np.zeros(B, np.int64))
            STAT_SET("serving.gen_kv_blocks_total",
                     self._pool.capacity())
            STAT_SET("serving.gen_kv_blocks_free",
                     self._pool.free_count())
        else:
            self._run_step(np.zeros((self.max_slots, 1), np.int64),
                           reset=np.ones(self.max_slots, np.float32),
                           active=np.zeros(self.max_slots, np.float32))
        self._warm_misses = self.cache_stats()["misses"]
        self._closed = False
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="ptt-generation-worker",
                                        daemon=True)
        self._worker.start()
        self._engine_state = "ready"
        self._ready.set()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = 30.0):
        """Reject new submissions; drain=True finishes queued + active
        requests first, drain=False fails them with EngineClosedError."""
        self._ready.clear()
        self._engine_state = "stopped"
        with self._cond:
            self._closed = True
            self._draining = drain
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout)
            self._worker = None

    @property
    def ready(self) -> bool:
        return self._ready.is_set()

    @property
    def breaker(self) -> CircuitBreaker:
        return self._breaker

    def health(self) -> dict:
        """Same shape as ServingEngine.health(): state warming / ready
        / degraded / open / stopped + breaker detail (for /healthz)."""
        if self._engine_state != "ready":
            return {"state": self._engine_state,
                    "breaker": self._breaker.state, "retry_after_s": 0.0}
        b = self._breaker.state
        state = {OPEN: "open", HALF_OPEN: "degraded",
                 CLOSED: "ready"}[b]
        return {"state": state, "breaker": b,
                "retry_after_s": self._breaker.retry_after_s()}

    def load(self) -> int:
        """Queued + active requests: what the router's least-loaded
        dispatch compares."""
        with self._cond:
            queued = len(self._queue)
        return queued + self._slots.active_count()

    def cache_stats(self):
        """The executor's per-instance cache counters; after `start()`
        the `misses` count must never move again."""
        return self.exe.cache_stats()

    def kv_block_stats(self) -> dict:
        """Snapshot of the paged pool for reporting: capacity/free in
        blocks, the bytes the pool pins, and how many prefix-cache
        entries are resident."""
        if not self.paged:
            return {"paged": False, "pool_bytes": self.kv_pool_bytes()}
        return {"paged": True,
                "block_size": self.block_size,
                "blocks_total": self._pool.capacity(),
                "blocks_free": self._pool.free_count(),
                "prefix_entries": len(self._prefix),
                "pool_bytes": self.kv_pool_bytes()}

    def post_warmup_compiles(self) -> int:
        """New executor cache entries since `start()` finished warming:
        0 while every step fed the warmed shapes and dtypes."""
        if self._warm_misses is None:
            return 0
        return self.cache_stats()["misses"] - self._warm_misses

    # -- request path ----------------------------------------------------
    def submit(self, req: GenerationRequest) -> _Response:
        """Enqueue; returns a future handle whose `.result()` blocks for
        ``{"tokens", "finish_reason", "ttft_ms", "e2e_ms"}``."""
        need = len(req.prompt) + req.max_new_tokens - 1
        if self.paged:
            # block-aware admission: a request that can never fit is
            # rejected here; one that merely has to WAIT for blocks
            # queues and is admitted by the worker when the pool drains
            need_blocks = blocks_for_tokens(need, self.block_size)
            if need_blocks > self.step.max_blocks_per_slot:
                raise ValueError(
                    f"request needs {need_blocks} KV blocks but a "
                    f"slot's block table holds at most "
                    f"{self.step.max_blocks_per_slot} "
                    f"(max_seq={self.max_seq}, "
                    f"block_size={self.block_size})")
            if need_blocks > self._pool.capacity():
                raise ValueError(
                    f"request needs {need_blocks} KV blocks but the "
                    f"engine's pool has only {self._pool.capacity()} "
                    f"allocatable blocks "
                    f"({self._pool.free_count()} free now)")
        elif need > self.max_seq:
            raise ValueError(
                f"request needs {need} cache positions but the engine "
                f"was built with max_seq={self.max_seq}")
        timeout_ms = req.timeout_ms if req.timeout_ms is not None \
            else self.default_timeout_ms
        now = time.perf_counter()
        deadline = now + timeout_ms / 1e3 if timeout_ms else None
        if not self._breaker.allow():
            raise OverloadedError(
                "generation backend is unhealthy (circuit breaker "
                "open)", retry_after_s=self._breaker.retry_after_s())
        resp = _Response()
        q = _Queued(req, resp, deadline, now)
        if trace.enabled():
            # Child of the caller's span (http.request, a client's
            # per-request root) when one is current, else a new root.
            q.span = trace.start_span(
                "gen.request",
                attrs={"prompt_tokens": len(req.prompt),
                       "max_new_tokens": req.max_new_tokens})
            resp.span = q.span
            q.qspan = trace.start_span("queue", parent=q.span)
        try:
            with self._cond:
                if self._closed:
                    raise EngineClosedError(
                        "generation engine is shut down")
                if len(self._queue) >= self.queue_capacity:
                    STAT_ADD("serving.gen_rejected")
                    raise QueueFullError(
                        f"generation queue at capacity "
                        f"({len(self._queue)}/{self.queue_capacity})")
                self._queue.append(q)
                STAT_ADD("serving.gen_requests")
                STAT_SET("serving.gen_queue_depth", len(self._queue))
                self._cond.notify_all()
        except ServingError as e:
            # Rejected before any worker saw it: the raise is the
            # completion (errored -> the tail rules keep the trace).
            trace.end_span(q.qspan, error=type(e).__name__)
            trace.complete_request(q.span,
                                   error=f"{type(e).__name__}: {e}")
            raise
        return resp

    def generate(self, prompt: Sequence[int], max_new_tokens: int,
                 **kw) -> dict:
        """Blocking submit+wait convenience."""
        return self.submit(GenerationRequest(
            prompt, max_new_tokens, **kw)).result()

    # -- decode step -----------------------------------------------------
    def _run_step(self, tokens, reset, active):
        out, = self.exe.run(
            self._prog,
            feed={self.step.token_var.name: tokens,
                  self.step.reset_var.name: reset,
                  self.step.active_var.name: active},
            fetch_list=[self.step.logits_var],
            scope=self.scope)
        return np.asarray(out)

    def _run_paged(self, prog, step, tokens, table, start, nvalid):
        out, = self.exe.run(
            prog,
            feed={step.token_var.name: tokens,
                  step.table_var.name: table,
                  step.start_var.name: start,
                  step.nvalid_var.name: nvalid},
            fetch_list=[step.logits_var],
            scope=self.scope)
        return np.asarray(out)

    # -- paged-KV bookkeeping (worker thread only) -----------------------
    def _alloc_block(self) -> Optional[int]:
        """Pool alloc with prefix-cache pressure relief: when the free
        list is empty, evict cold cached prefixes (LRU, only blocks no
        live slot references) until one frees."""
        bid = self._pool.alloc()
        while bid is None:
            if self._prefix.evict_lru() is None:
                return None
            bid = self._pool.alloc()
        return bid

    def _set_block_gauges(self):
        STAT_SET("serving.gen_kv_blocks_free", self._pool.free_count())

    def _adapt_spec_k(self, st: _SlotState, rate: float):
        """Fold one measured acceptance ratio into the slot's draft
        budget (spec_decode.update_spec_k). Gauge reflects the most
        recently adapted slot's budget."""
        from .spec_decode import update_spec_k
        from ..core.flags import FLAGS
        st.spec_k_cur, st.spec_acc_ewma, moved = update_spec_k(
            st.spec_k_cur, st.spec_acc_ewma, rate,
            k_max=self.spec_k, low=float(FLAGS.spec_adapt_low),
            high=float(FLAGS.spec_adapt_high))
        if moved < 0:
            STAT_ADD("serving.gen_spec_k_shrinks")
        elif moved > 0:
            STAT_ADD("serving.gen_spec_k_grows")
        STAT_SET("serving.gen_spec_k_effective", st.spec_k_cur)

    def _admit_trace(self, st: _SlotState, q: "_Queued"):
        """Queue -> prefill phase transition on the request's span tree
        (admission happens on the worker thread — the span rode the
        _Queued object across)."""
        st.span = q.span
        trace.end_span(q.qspan)
        st.phase_span = trace.start_span("prefill", parent=st.span)

    def _admit_locked(self) -> bool:
        """Move the queue head into a free slot. Paged mode additionally
        gates on block availability: shared prefix blocks come from the
        PrefixCache (refcounted, zero prefill cost), the rest are
        allocated upfront for the request's worst case — so a decode
        can never die mid-flight from pool exhaustion. Returns False
        (leaving the queue untouched) when the head cannot be placed
        yet."""
        q = self._queue[0]
        slot = self._slots.acquire()
        if slot is None:
            return False
        st = _SlotState(q.req, q.response, q.deadline, q.t_submit)
        if self.paged:
            prompt = q.req.prompt
            need = len(prompt) + q.req.max_new_tokens - 1
            # the last prompt position must stay writable (its KV is
            # written by this slot's first decode step), so the prefix
            # match is capped one token short of the prompt
            n_cached, shared = self._prefix.lookup(
                prompt, max_tokens=len(prompt) - 1)
            owned: List[int] = []
            missing = blocks_for_tokens(need, self.block_size) - \
                len(shared)
            while len(owned) < missing:
                bid = self._alloc_block()
                if bid is None:
                    break
                owned.append(bid)
            else:
                st.blocks = shared + owned
                st.n_cached = n_cached
                st.fed = n_cached
                st.cur = prompt[n_cached]
                STAT_ADD("serving.gen_prefix_hits" if n_cached
                         else "serving.gen_prefix_misses")
                self._set_block_gauges()
                self._admit_trace(st, q)
                if st.phase_span is not None and n_cached:
                    st.phase_span.set_attr("cached_tokens", n_cached)
                self._state[slot] = st
                self._queue.pop(0)
                return True
            # not enough blocks: roll back and wait for releases
            for bid in owned + shared:
                self._pool.decref(bid)
            self._slots.release(slot)
            self._set_block_gauges()
            return False
        self._admit_trace(st, q)
        self._state[slot] = st
        self._queue.pop(0)
        return True

    def _release_slot(self, i: int):
        """Retire slot i: in paged mode 'reset' IS this — the blocks go
        back to the pool (or stay resident for the prefix cache /
        other slots holding refs); the graph never wipes anything."""
        st = self._state[i]
        if st is not None and self.paged:
            for bid in st.blocks:
                self._pool.decref(bid)
            st.blocks = []
            self._set_block_gauges()
        self._state[i] = None
        self._slots.release(i)

    def _register_prefix(self, st: _SlotState):
        """After the first decode step, every full prompt block is
        immutable (all later writes land at positions past the prompt)
        — publish them to the prefix cache so the NEXT identical
        prefix skips its prefill."""
        bs = self.block_size
        n_full = len(st.req.prompt) // bs
        if n_full == 0:
            return
        hashes = self._prefix.chunk_hashes(st.req.prompt[:n_full * bs],
                                           bs)
        for j, h in enumerate(hashes):
            self._prefix.insert(h, st.blocks[j])
        self._set_block_gauges()

    # -- worker ----------------------------------------------------------
    def _expire_queued_locked(self, now) -> List[_Queued]:
        dead = [q for q in self._queue
                if q.deadline is not None and now >= q.deadline]
        if dead:
            self._queue = [q for q in self._queue if q not in dead]
        return dead

    def _finish(self, st: _SlotState, reason: str):
        now = time.perf_counter()
        e2e_ms = (now - st.t_submit) * 1e3
        if st.span is not None:
            # Aggregated device-sync attribution: one synthetic "fetch"
            # child of the decode phase carrying the summed fetch-block
            # time of every step this slot rode (NESTED, so the
            # queue+prefill+decode critical path doesn't double-count).
            if st.phase_span is not None and st.fetch_s > 0:
                trace.record_span(
                    "fetch", st.phase_span.t_start,
                    st.phase_span.t_start + st.fetch_s, st.phase_span,
                    attrs={"aggregated": True,
                           "fetch_ms": round(st.fetch_s * 1e3, 3)})
            trace.end_span(st.phase_span)
            st.span.attrs.update({
                "e2e_ms": round(e2e_ms, 3),
                "ttft_ms": None if st.ttft_ms is None
                else round(st.ttft_ms, 3),
                "tokens": len(st.generated),
                "finish_reason": reason,
                "cached_tokens": st.n_cached})
        st.response._complete({
            "tokens": list(st.generated),
            "finish_reason": reason,
            "ttft_ms": st.ttft_ms,
            "e2e_ms": e2e_ms,
            "cached_tokens": st.n_cached,
        })
        if _monitor_on():
            STAT_OBSERVE("serving.gen_e2e_ms", e2e_ms,
                         buckets=MS_BUCKETS,
                         exemplar=st.span.trace_id if st.span else None)

    def _worker_loop(self):
        from ..models import sampling
        B = self.max_slots
        while True:
            expired: List[_Queued] = []
            failed: List[_Queued] = []
            exit_loop = False
            with self._cond:
                now = time.perf_counter()
                expired = self._expire_queued_locked(now)
                if self._closed and not self._draining:
                    failed = self._queue
                    self._queue = []
                # admit queued requests into free slots (iteration-level
                # scheduling: this runs BETWEEN decode steps, so a slot
                # — and in paged mode its KV blocks — freed by the
                # previous step is reusable right now). Under _kv_mutex
                # too: admission allocates blocks and reads the
                # PrefixCache an adopt may be filling (the JAX package's
                # loop admits without it)
                with self._kv_mutex:
                    while self._queue and self._slots.free_count() \
                            and self._admit_locked():
                        pass
                active_idx = [i for i in range(B)
                              if self._state[i] is not None]
                STAT_SET("serving.gen_queue_depth", len(self._queue))
                STAT_SET("serving.gen_active_slots", len(active_idx))
                if not active_idx:
                    if self._closed and not self._queue:
                        exit_loop = True
                    elif not (self._closed and not self._draining):
                        # generation goodput: no active slot = idle wait
                        t_idle0 = time.perf_counter()
                        self._cond.wait(0.05)
                        _goodput.gen_idle(time.perf_counter() - t_idle0)
                        if self._closed and not self._draining:
                            # stop(drain=False) came during the wait: the
                            # exit below must not strand what was queued
                            # meanwhile (the JAX package's loop does)
                            failed = self._queue
                            self._queue = []
            for q in expired:
                STAT_ADD("serving.gen_timeouts")
                trace.end_span(q.qspan, error="DeadlineExceededError")
                q.response._complete(error=DeadlineExceededError(
                    "generation request waited past its deadline"))
            for q in failed:
                trace.end_span(q.qspan, error="EngineClosedError")
                q.response._complete(error=EngineClosedError(
                    "generation engine shut down before the request "
                    "ran"))
            if self._closed and not self._draining:
                # fail whatever is mid-decode and exit
                for i in range(B):
                    st = self._state[i]
                    if st is not None:
                        st.response._complete(error=EngineClosedError(
                            "generation engine shut down mid-decode"))
                        self._release_slot(i)
                break
            if exit_loop:
                break
            if not active_idx:
                continue
            if self.paged:
                t_busy0 = time.perf_counter()
                # _kv_mutex: a disagg export/adopt reads and writes the
                # same pools and PrefixCache between iterations; each
                # iteration leaves new pool tensors in the scope
                with self._kv_mutex:
                    self._paged_iteration()
                _goodput.gen_busy(time.perf_counter() - t_busy0)
                continue

            # ---- one decode step over the full fixed-shape batch ----
            now = time.perf_counter()
            t_busy0 = now
            tokens = np.zeros((B, 1), np.int64)
            reset = np.zeros(B, np.float32)
            active = np.zeros(B, np.float32)
            stepped: List[int] = []
            for i in active_idx:
                st = self._state[i]
                if st.deadline is not None and now >= st.deadline:
                    STAT_ADD("serving.gen_timeouts")
                    st.response._complete(
                        error=DeadlineExceededError(
                            "generation deadline passed mid-decode"))
                    self._state[i] = None
                    self._slots.release(i)
                    continue
                tokens[i, 0] = st.cur
                reset[i] = 1.0 if st.needs_reset else 0.0
                active[i] = 1.0
                stepped.append(i)
            if not stepped:
                continue

            def _attempt():
                inj = _fault_injector()
                if inj is not None:
                    inj.pre_step("generation")
                return self._run_step(tokens, reset, active)

            try:
                # only the injector's pre-dispatch TransientFault is
                # retryable: once the real step ran, the KV cache
                # advanced and a replay would double-step the slots
                logits = self._step_retry.call(_attempt)
            except Exception as e:  # noqa: BLE001 — worker must survive
                if is_transient(e):
                    self._breaker.record_failure()
                STAT_ADD("resilience.gen_step_failures")
                for i in stepped:
                    st = self._state[i]
                    st.response._complete(error=RuntimeError(
                        f"decode step failed: {e!r}"))
                    self._state[i] = None
                    self._slots.release(i)
                continue
            self._breaker.record_success()
            if trace.enabled():
                lt = self.exe.last_step_timings
                if lt is not None:
                    for i in stepped:
                        self._state[i].fetch_s += lt["fetch_s"]
            inj = _fault_injector()
            if inj is not None:
                # step_nan at site=generation corrupts only the host
                # logits copy; the device KV state is untouched
                arrs = [logits]
                if inj.corrupt_fetches("generation", arrs):
                    logits = arrs[0]
            from ..core.flags import FLAGS
            if FLAGS.serving_nan_guard:
                bad = [i for i in stepped
                       if not np.all(np.isfinite(logits[i, 0]))]
                if bad:
                    self._breaker.record_failure()
                    STAT_ADD("resilience.gen_step_failures")
                    for i in bad:
                        st = self._state[i]
                        st.response._complete(error=RuntimeError(
                            "non-finite logits (cannot replay a "
                            "stateful decode step)"))
                        self._state[i] = None
                        self._slots.release(i)
                    stepped = [i for i in stepped if i not in bad]
                    if not stepped:
                        continue
            STAT_ADD("serving.gen_steps")
            if _monitor_on():
                STAT_OBSERVE("serving.gen_slot_occupancy",
                             len(stepped) / float(B),
                             buckets=FRACTION_BUCKETS)

            # ---- per-slot bookkeeping (sampling, streaming, finish) --
            t_step = time.perf_counter()
            for i in stepped:
                st = self._state[i]
                st.needs_reset = False
                st.fed += 1
                prompt = st.req.prompt
                if st.fed < len(prompt):
                    st.cur = prompt[st.fed]     # still prefilling
                    continue
                tok = sampling.sample_token(
                    logits[i, 0], temperature=st.req.temperature,
                    top_k=st.req.top_k, rng=st.rng)
                st.generated.append(tok)
                STAT_ADD("serving.gen_tokens")
                if len(st.generated) == 1:
                    st.ttft_ms = (t_step - st.t_submit) * 1e3
                    if _monitor_on():
                        STAT_OBSERVE("serving.gen_ttft_ms", st.ttft_ms,
                                     buckets=MS_BUCKETS)
                    if st.span is not None:
                        # prefill -> decode phase flip at first token
                        trace.end_span(st.phase_span)
                        st.phase_span = trace.start_span(
                            "decode", parent=st.span)
                elif _monitor_on() and st.t_prev_token is not None:
                    STAT_OBSERVE("serving.gen_inter_token_ms",
                                 (t_step - st.t_prev_token) * 1e3,
                                 buckets=MS_BUCKETS)
                st.t_prev_token = t_step
                if st.req.stream_cb is not None:
                    st.req.stream_cb(tok)
                    if st.phase_span is not None:
                        st.phase_span.add_event(
                            "stream_flush", token_index=len(st.generated))
                done_eos = (st.req.eos_id is not None
                            and tok == st.req.eos_id)
                if done_eos or len(st.generated) >= \
                        st.req.max_new_tokens:
                    self._finish(st, "eos" if done_eos else "length")
                    self._state[i] = None
                    self._slots.release(i)
                else:
                    st.cur = tok
            _goodput.gen_busy(time.perf_counter() - t_busy0)

    # -- paged iteration -------------------------------------------------
    def _paged_iteration(self):
        """One scheduler iteration of the paged engine: (1) chunked
        prefill — every slot still consuming its prompt retires up to
        one BLOCK of tokens through the prefill program; (2) one
        decode step for every slot past its prompt. Both run the same
        two warmed programs every time (fixed shapes; muted rows write
        to the scratch block), so admission, chunk scheduling, release
        and prefix reuse never add an executor cache entry. Long
        prompts therefore interleave with decode at block granularity
        instead of stalling the batch for O(prompt) steps."""
        from ..core.flags import FLAGS
        from ..models import sampling
        B = self.max_slots
        bs = self.block_size
        mb = self.step.max_blocks_per_slot
        now = time.perf_counter()
        for i in range(B):
            st = self._state[i]
            if st is not None and st.deadline is not None \
                    and now >= st.deadline:
                STAT_ADD("serving.gen_timeouts")
                st.response._complete(error=DeadlineExceededError(
                    "generation deadline passed mid-decode"))
                self._release_slot(i)

        def fill_row(arr_table, arr_start, i, st):
            arr_table[i, :len(st.blocks)] = st.blocks
            arr_start[i] = st.fed

        def run_guarded(prog, step, tokens, table, start, nvalid,
                        idx, what, site="generation"):
            """Shared failure envelope: injector pre-step faults retry
            (RetryPolicy), anything after the real dispatch (a CUDA
            error from a launch or from the sync at fetch included)
            fails the involved slots — KV already advanced, a replay
            would double-write. Returns the fetch or None. `site` names
            the fault-injection hook (prefill chunks get their own,
            "gen_prefill", so drills can slow prefill without touching
            decode)."""
            def _attempt():
                inj = _fault_injector()
                if inj is not None:
                    inj.pre_step(site)
                return self._run_paged(prog, step, tokens, table,
                                       start, nvalid)
            try:
                out = self._step_retry.call(_attempt)
            except Exception as e:  # noqa: BLE001 — worker must survive
                if is_transient(e):
                    self._breaker.record_failure()
                STAT_ADD("resilience.gen_step_failures")
                for i in idx:
                    st = self._state[i]
                    st.response._complete(error=RuntimeError(
                        f"{what} step failed: {e!r}"))
                    self._release_slot(i)
                return None
            self._breaker.record_success()
            if trace.enabled():
                lt = self.exe.last_step_timings
                if lt is not None:
                    for i in idx:
                        st = self._state[i]
                        if st is not None:
                            st.fetch_s += lt["fetch_s"]
            return out

        # ---- phase 1: chunked prefill ---------------------------------
        prefill_idx = [
            i for i in range(B) if self._state[i] is not None
            and self._state[i].fed < len(self._state[i].req.prompt) - 1]
        if prefill_idx:
            tokens = np.zeros((B, bs), np.int64)
            table = np.zeros((B, mb), np.int64)
            start = np.zeros(B, np.int64)
            nvalid = np.zeros(B, np.int64)
            chunk_n = {}
            for i in prefill_idx:
                st = self._state[i]
                prompt = st.req.prompt
                n = min(bs, len(prompt) - 1 - st.fed)
                tokens[i, :n] = prompt[st.fed:st.fed + n]
                fill_row(table, start, i, st)
                nvalid[i] = n
                chunk_n[i] = n
            probe = run_guarded(self._prefill_prog, self.prefill_step,
                                tokens, table, start, nvalid,
                                prefill_idx, "prefill",
                                site="gen_prefill")
            if probe is None:
                return
            if FLAGS.serving_nan_guard:
                bad = [i for i in prefill_idx
                       if not np.isfinite(probe[i])]
                if bad:
                    self._breaker.record_failure()
                    STAT_ADD("resilience.gen_step_failures")
                    for i in bad:
                        st = self._state[i]
                        st.response._complete(error=RuntimeError(
                            "non-finite activations in chunked prefill "
                            "(cannot replay a stateful step)"))
                        self._release_slot(i)
                    prefill_idx = [i for i in prefill_idx
                                   if i not in bad]
            for i in prefill_idx:
                st = self._state[i]
                st.fed += chunk_n[i]
                st.cur = st.req.prompt[st.fed]
                STAT_ADD("serving.gen_chunked_prefills")
                if st.phase_span is not None:
                    st.phase_span.add_event("prefill_chunk",
                                            tokens=chunk_n[i])

        # ---- phase 2: one decode (or spec verify) step ----------------
        decode_idx = [
            i for i in range(B) if self._state[i] is not None
            and self._state[i].fed >=
            len(self._state[i].req.prompt) - 1]
        if not decode_idx:
            return
        # speculative drafts (serving/spec_decode.py): host-side n-gram
        # lookup over each opted-in slot's prompt + generated tokens.
        # Any non-empty draft routes the WHOLE batch through the verify
        # program — a draft-less row rides with n_valid=1, which is
        # semantically the decode step — while an all-empty round takes
        # the cheaper 1-token decode program. Both ran in start(), so
        # the per-iteration choice never adds a cache entry.
        drafts = {}
        if self._drafter is not None:
            for i in decode_idx:
                st = self._state[i]
                if st.req.spec_decode is False:
                    continue
                # cap drafts to the blocks admission reserved (need-1
                # is the slot's last writable position) and to the
                # request's remaining token budget (the verify row
                # already emits one token beyond the accepted drafts)
                need = len(st.req.prompt) + st.req.max_new_tokens - 1
                if st.spec_k_cur is None:
                    st.spec_k_cur = self.spec_k
                k_slot = st.spec_k_cur if self.spec_adaptive \
                    else self.spec_k
                cap = min(k_slot, need - 1 - st.fed,
                          st.req.max_new_tokens - len(st.generated) - 1)
                if cap < 1:
                    continue
                d = self._drafter.draft(st.req.prompt + st.generated,
                                        cap)
                if d:
                    drafts[i] = d
        use_spec = bool(drafts)
        prog = self._spec_prog if use_spec else self._prog
        step = self.spec_step if use_spec else self.step
        T = self.spec_k + 1 if use_spec else 1
        tokens = np.zeros((B, T), np.int64)
        table = np.zeros((B, mb), np.int64)
        start = np.zeros(B, np.int64)
        nvalid = np.zeros(B, np.int64)
        n_draft = {}
        for i in decode_idx:
            st = self._state[i]
            d = drafts.get(i, ())
            n_draft[i] = len(d)
            tokens[i, 0] = st.cur
            if d:
                tokens[i, 1:1 + len(d)] = d
            fill_row(table, start, i, st)
            nvalid[i] = 1 + len(d)
        logits = run_guarded(prog, step, tokens, table, start, nvalid,
                             decode_idx,
                             "spec verify" if use_spec else "decode")
        if logits is None:
            return
        inj = _fault_injector()
        if inj is not None:
            arrs = [logits]
            if inj.corrupt_fetches("generation", arrs):
                logits = arrs[0]
        if FLAGS.serving_nan_guard:
            bad = [i for i in decode_idx
                   if not np.all(np.isfinite(
                       logits[i, :1 + n_draft[i]]))]
            if bad:
                self._breaker.record_failure()
                STAT_ADD("resilience.gen_step_failures")
                for i in bad:
                    st = self._state[i]
                    st.response._complete(error=RuntimeError(
                        "non-finite logits (cannot replay a stateful "
                        "decode step)"))
                    self._release_slot(i)
                decode_idx = [i for i in decode_idx if i not in bad]
                if not decode_idx:
                    return
        STAT_ADD("serving.gen_steps")
        if use_spec:
            STAT_ADD("serving.gen_spec_steps")
        if _monitor_on():
            STAT_OBSERVE("serving.gen_slot_occupancy",
                         len(decode_idx) / float(B),
                         buckets=FRACTION_BUCKETS)

        t_step = time.perf_counter()
        for i in decode_idx:
            st = self._state[i]
            nd = n_draft[i]
            if nd:
                STAT_ADD("serving.gen_spec_draft_proposed", nd)
                # verify row j's logits condition on exactly the tokens
                # a serial decode would have fed; accept_draft draws
                # through the same sample_token path with the slot's
                # rng, so emitted tokens are bit-identical to serial
                # decode at any temperature (models/sampling.py)
                emitted, n_acc = sampling.accept_draft(
                    logits[i, :nd + 1], tokens[i, 1:1 + nd],
                    temperature=st.req.temperature,
                    top_k=st.req.top_k, rng=st.rng)
                STAT_ADD("serving.gen_spec_draft_accepted", n_acc)
                if _monitor_on():
                    STAT_OBSERVE("serving.gen_spec_acceptance_rate",
                                 n_acc / nd, buckets=FRACTION_BUCKETS)
                    STAT_OBSERVE("serving.gen_spec_tokens_per_step",
                                 len(emitted),
                                 buckets=SPEC_TOKEN_BUCKETS)
                # the committed token + accepted drafts are now valid
                # KV; writes past fed (rejected tail) sit beyond the
                # cursor and are rewritten before any mask reads them
                st.fed += 1 + n_acc
                if self.spec_adaptive:
                    self._adapt_spec_k(st, n_acc / nd)
            else:
                emitted = [sampling.sample_token(
                    logits[i, 0], temperature=st.req.temperature,
                    top_k=st.req.top_k, rng=st.rng)]
                st.fed += 1
            finished = False
            for tok in emitted:
                st.generated.append(tok)
                STAT_ADD("serving.gen_tokens")
                if len(st.generated) == 1:
                    st.ttft_ms = (t_step - st.t_submit) * 1e3
                    if _monitor_on():
                        STAT_OBSERVE("serving.gen_ttft_ms", st.ttft_ms,
                                     buckets=MS_BUCKETS)
                    if st.span is not None:
                        # prefill -> decode phase flip at first token
                        trace.end_span(st.phase_span)
                        st.phase_span = trace.start_span(
                            "decode", parent=st.span)
                    if not st.registered:
                        # the whole prompt (every full block of it) is
                        # now resident and immutable — shareable from
                        # here on
                        self._register_prefix(st)
                        st.registered = True
                elif _monitor_on() and st.t_prev_token is not None:
                    STAT_OBSERVE("serving.gen_inter_token_ms",
                                 (t_step - st.t_prev_token) * 1e3,
                                 buckets=MS_BUCKETS)
                st.t_prev_token = t_step
                if st.req.stream_cb is not None:
                    st.req.stream_cb(tok)
                    if st.phase_span is not None:
                        st.phase_span.add_event(
                            "stream_flush",
                            token_index=len(st.generated))
                done_eos = (st.req.eos_id is not None
                            and tok == st.req.eos_id)
                if done_eos or len(st.generated) >= \
                        st.req.max_new_tokens:
                    self._finish(st, "eos" if done_eos else "length")
                    self._release_slot(i)
                    finished = True
                    break
            if not finished:
                st.cur = emitted[-1]
