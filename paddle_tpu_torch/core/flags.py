"""Runtime flag registry + environment bootstrap.

The subset of the JAX package's flags that this package reads, with the
same names, defaults and ``FLAGS_<name>=<value>`` environment bootstrap
(read once at import; bools accept 0/1/true/false). The
``flash_attention_block_{q,k}`` flags are not here: they are TPU tile
hints, and the Hopper kernel picks its own tile.

    from paddle_tpu_torch.core.flags import FLAGS
    if FLAGS.check_nan_inf: ...
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

__all__ = ["FLAGS", "get_flags", "set_flags", "reload_from_env",
           "flag_handle"]


class _Flag:
    __slots__ = ("name", "default", "value", "ftype", "help", "traced")

    def __init__(self, name, default, ftype, help_, traced=False):
        self.name = name
        self.default = default
        self.value = default
        self.ftype = ftype
        self.help = help_
        # a traced flag changes what a prepared run does: its value keys
        # the executor's cache (traced_values)
        self.traced = traced


_REGISTRY: Dict[str, _Flag] = {}
_LOCK = threading.Lock()


def _define(name, default, ftype, help_, traced=False):
    with _LOCK:
        if name in _REGISTRY:
            raise ValueError(f"flag {name!r} already defined")
        _REGISTRY[name] = _Flag(name, ftype(default), ftype, help_, traced)
    _load_one_from_env(name)


def _parse(ftype, raw: str):
    if ftype is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return ftype(raw)


def _load_one_from_env(name):
    raw = os.environ.get(f"FLAGS_{name}")
    if raw is None:
        return
    f = _REGISTRY[name]
    try:
        f.value = _parse(f.ftype, raw)
    except (ValueError, TypeError):
        import warnings
        warnings.warn(
            f"ignoring malformed environment variable FLAGS_{name}="
            f"{raw!r} (expected {f.ftype.__name__}); keeping {f.value!r}")


def reload_from_env():
    """Re-read every FLAGS_* environment variable."""
    for name in _REGISTRY:
        _load_one_from_env(name)


class _FlagsNamespace:
    """Attribute access: FLAGS.check_nan_inf. Unknown names raise."""

    def __getattr__(self, name):
        try:
            return _REGISTRY[name].value
        except KeyError:
            raise AttributeError(f"unknown flag {name!r}") from None

    def __setattr__(self, name, value):
        f = _REGISTRY.get(name)
        if f is None:
            raise AttributeError(f"unknown flag {name!r}")
        f.value = _parse(f.ftype, value) if isinstance(value, str) \
            else f.ftype(value)

    def __dir__(self):
        return sorted(_REGISTRY)


FLAGS = _FlagsNamespace()


def get_flags(names) -> Dict[str, Any]:
    """get_flags(["FLAGS_x", ...]) -> {name: value}."""
    if isinstance(names, str):
        names = [names]
    out = {}
    for n in names:
        key = n[6:] if n.startswith("FLAGS_") else n
        if key not in _REGISTRY:
            raise ValueError(f"unknown flag {n!r}")
        out[n] = _REGISTRY[key].value
    return out


def set_flags(kv: Dict[str, Any]):
    """set_flags({"FLAGS_x": v, ...})."""
    for n, v in kv.items():
        key = n[6:] if n.startswith("FLAGS_") else n
        if key not in _REGISTRY:
            raise ValueError(f"unknown flag {n!r}")
        setattr(FLAGS, key, v)


def traced_values() -> tuple:
    """((name, value), ...) of the traced flags: part of the executor's
    cache key, so flipping one prepares a new run."""
    return tuple((f.name, f.value) for f in _REGISTRY.values() if f.traced)


def flag_handle(name: str) -> _Flag:
    """The mutable _Flag record for `name`. The monitor's, trace's and
    goodput's disabled fast paths cache this handle, so every hook costs
    one attribute read instead of a registry lookup."""
    return _REGISTRY[name]


_define("check_nan_inf", False, bool,
        "Debug mode: after every op, verify each floating-point output "
        "is finite; raises naming the op, its block/op index and the "
        "output var. Synchronises with the device on every op.")
_define("executor_cache_capacity", 64, int,
        "Max prepared (program, feed shapes, fetches) entries kept per "
        "Executor, LRU evicted.")
_define("reader_queue_depth", 2, int,
        "Default prefetch queue capacity of DataLoader/PyReader when the "
        "caller passes none (the reader's double-buffering depth).")
_define("serving_max_batch_size", 8, int,
        "Default EngineConfig.max_batch_size: the most request rows the "
        "serving engine coalesces into one padded batch.")
_define("serving_max_wait_us", 2000, int,
        "Default EngineConfig.max_wait_us: how long a partially-filled "
        "batch may wait for co-batchable requests before it is flushed.")
_define("serving_queue_capacity", 256, int,
        "Default EngineConfig.queue_capacity: max request rows pending "
        "before submissions are rejected with QueueFullError.")
_define("serving_default_timeout_ms", 1000.0, float,
        "Default EngineConfig.default_timeout_ms: per-request deadline; "
        "0 = no deadline.")

# -- observability (monitor.py, trace.py, goodput.py) ------------------------
_define("enable_monitor", False, bool,
        "Enable the runtime stats registry (monitor.py): executor step "
        "timing, serving and generation stats, device memory gauges. Off = "
        "every STAT_* call is a near-zero-cost no-op.")
_define("monitor_export_path", "", str,
        "Default JSONL file for monitor snapshots (append mode, one JSON "
        "object per line), used by monitor.snapshot_to_jsonl and "
        "start_exporter when no explicit path is given.")
_define("monitor_flush_interval_s", 10.0, float,
        "Interval of the background JSONL snapshot exporter "
        "(monitor.start_exporter).")
_define("monitor_http_port", 0, int,
        "When > 0, monitor.serve_prometheus() binds a stdlib HTTP scrape "
        "endpoint on 127.0.0.1:<port> serving prometheus_text(). 0 = "
        "disabled.")
_define("flight_recorder", True, bool,
        "Keep a bounded in-memory ring of per-step flight records (step "
        "index, program, cache hit/miss, timings, stat deltas) that "
        "monitor.dump_flight_recorder writes as JSONL on demand, on an "
        "unhandled exception or on SIGTERM.")
_define("flight_recorder_capacity", 512, int,
        "Max records kept in the flight-recorder ring (oldest dropped "
        "first).")
_define("flight_recorder_path", "", str,
        "Default path for monitor.dump_flight_recorder; empty = "
        "flight_recorder.jsonl in the working directory.")
_define("enable_trace", False, bool,
        "Per-request tracing (trace.py): spans with W3C traceparent "
        "propagation across the batcher -> engine -> executor path. Off, "
        "every trace entry point returns after one cached-flag read.")
_define("trace_sample", 0.05, float,
        "Head-sampling keep probability for request traces (decided once "
        "per root span). Errored requests and requests slower than the "
        "tail threshold are always kept. 1.0 keeps every trace.")
_define("trace_ring_capacity", 8192, int,
        "Bounded in-process span ring: kept spans past this count evict "
        "oldest-first.")
_define("trace_tail_slow_ms", 0.0, float,
        "Absolute tail-sampling slow threshold (ms): a request whose e2e "
        "exceeds it is kept regardless of head sampling. 0 = rolling p95 "
        "over the last trace window.")
_define("enable_goodput", False, bool,
        "Run-level goodput accounting (goodput.py): classify the wall "
        "clock of a run into exclusive categories that sum to it, and "
        "serving busy/idle/pad-waste seconds. Off = every goodput hook "
        "is one cached-flag read.")
_define("goodput_starved_ms", 50.0, float,
        "Input-starvation threshold: a reader batch wait above this many "
        "milliseconds counts as input-starved "
        "(goodput.input_starved_steps).")

# -- resilience (resilience/*.py) ----------------------------------------------
_define("fault_spec", "", str,
        "Deterministic fault-injection spec (resilience/faults.py): "
        "comma-separated kind:param list, e.g. 'step_nan:p=0.01,"
        "slow_step:ms=500,transient_fail:p=0.02,preempt_at:step=40'. "
        "Empty = injection disabled.")
_define("fault_seed", 0, int,
        "Seed of the fault-injection decisions, which derive from (seed, "
        "site, kind, per-site invocation counter): a spec and seed inject "
        "the same faults at the same steps whatever the timing.")
_define("retry_max_attempts", 3, int,
        "Default RetryPolicy attempt budget (resilience/retry.py): total "
        "tries, first included.")
_define("retry_base_ms", 10.0, float,
        "Default RetryPolicy base backoff (ms): attempt n sleeps about "
        "base * 2^(n-1), jittered, capped by FLAGS_retry_max_ms.")
_define("retry_max_ms", 1000.0, float,
        "Default RetryPolicy backoff cap (ms).")
_define("serving_breaker_threshold", 5, int,
        "Circuit breaker (resilience/breaker.py): consecutive batch or "
        "step failures before the serving/generation breaker trips "
        "CLOSED -> OPEN and submissions shed with OverloadedError. 0 "
        "disables the breaker.")
_define("serving_breaker_cooldown_ms", 1000.0, float,
        "How long an OPEN breaker sheds load before admitting half-open "
        "probe traffic.")
_define("serving_nan_guard", True, bool,
        "Serving output hygiene: a batch with a non-finite float output is "
        "treated as a transient fault (retried, then failed) instead of "
        "being served; a generation step with non-finite logits fails its "
        "slots.")

# -- the serving fleet (serving/router.py, serving/disagg.py) -----------------
_define("router_redispatch_budget", 2, int,
        "Multi-replica router (serving/router.py): how many times one "
        "request may be re-dispatched to a different replica after a "
        "retryable failure (replica death, 503 shed, connection reset) "
        "before the error is surfaced to the client. 0 disables "
        "failover.")
_define("router_probe_interval_s", 0.5, float,
        "Router health-probe cadence: every interval the router polls each "
        "replica's health (/healthz for url= replicas, engine.health() "
        "in-process) and updates its routing table. 0 disables active "
        "probing (passive failure accounting still runs).")
_define("router_failure_threshold", 3, int,
        "Consecutive dispatch failures before the router's per-replica "
        "circuit breaker marks that replica unhealthy and routes around "
        "it. 0 disables the per-replica breaker.")
_define("router_affinity_max", 4096, int,
        "Session-affinity table capacity: the router keeps at most this "
        "many session->replica pins, evicting the least recently used pin "
        "past the cap, so a long-running router's memory stays bounded "
        "under a stream of short-lived generation sessions.")
_define("router_drain_timeout_s", 30.0, float,
        "Hot-swap / deregister drain deadline: how long the router waits "
        "for a retired replica's in-flight requests to finish before "
        "stopping it anyway.")
_define("router_disagg", False, bool,
        "Disaggregated prefill/decode dispatch (serving/disagg.py): "
        "Router.generate() runs two-phase scheduling — pick a decode "
        "replica, and when the fleet prefix store says it does not "
        "already own the prompt's full-block chain, have a "
        "prefill-capable replica export the KV blocks over the wire and "
        "the decode replica adopt them before the decode dispatch. Off "
        "(default) = classic single-phase routing; transfer failures "
        "always fall back to the decode worker re-prefilling locally, so "
        "answers never change.")
_define("disagg_fleet_prefix_max", 4096, int,
        "FleetPrefixStore capacity: at most this many chain-hash entries "
        "(hash -> owning replica names) are kept on the router, "
        "LRU-evicted past the cap. Eviction only forgets WHERE a prefix "
        "lives — the worst case is a redundant re-prefill, never a wrong "
        "answer.")

# -- generation serving (serving/generation.py, serving/spec_decode.py) -------
_define("gen_paged_kv", True, bool,
        "Generation engine KV layout: True = block-table paged KV cache "
        "(serving/kv_blocks.py + models/gpt.build_paged_decode_step) with "
        "prefix caching and chunked prefill; False = the contiguous "
        "[max_slots, max_seq] slab decode.")
_define("gen_kv_block_size", 16, int,
        "Paged KV cache: tokens per physical block, and the chunk width "
        "of the chunked-prefill program.")
_define("gen_kv_pool_blocks", 0, int,
        "Paged KV cache: physical blocks in the pool (one is the scratch "
        "block). 0 = from FLAGS_gen_kv_pool_bytes when set, else full "
        "capacity (max_slots x ceil(max_seq/block_size) + scratch).")
_define("gen_kv_pool_bytes", 0, int,
        "Paged KV cache: device-memory budget for the K/V pools across "
        "all layers; the engine sizes the pool as budget // block_bytes "
        "blocks. 0 = unset.")
_define("gen_spec_decode", False, bool,
        "Generation engine default for speculative decoding "
        "(serving/spec_decode.py): a paged engine builds the [max_slots, "
        "k+1] verify program at start() and drafts with the n-gram "
        "drafter every decode iteration. GenerationRequest.spec_decode "
        "overrides per request.")
_define("spec_decode_k", 4, int,
        "Speculative decoding: the most draft tokens proposed per slot per "
        "iteration; the verify program is built at [max_slots, k+1].")
_define("spec_decode_ngram", 3, int,
        "Speculative decoding: longest context suffix the n-gram drafter "
        "matches against the slot's prompt + generated tokens; 0 disables "
        "drafting.")
_define("spec_decode_adaptive", True, bool,
        "Acceptance-aware adaptive draft length (spec_decode.update_spec_k): "
        "each slot shrinks its draft budget toward 1 while its acceptance "
        "EWMA is below FLAGS_spec_adapt_low and grows it back toward "
        "FLAGS_spec_decode_k above FLAGS_spec_adapt_high.")
_define("spec_adapt_low", 0.3, float,
        "Adaptive spec_k shrink threshold on a slot's acceptance EWMA.")
_define("spec_adapt_high", 0.8, float,
        "Adaptive spec_k grow threshold on a slot's acceptance EWMA.")

# -- front end, profiler, alerts (serving/http.py, profiler.py,
# monitor_alerts.py, goodput.py) ---------------------------------------------
_define("serving_http_port", 0, int,
        "Default EngineConfig.http_port for serving.serve(): the port of "
        "the JSON front end (/v1/predict, /healthz, /metrics). 0 binds an "
        "ephemeral port.")
_define("profiler_trace_dir", "", str,
        "When set, profiler.start_profiler writes its chrome traces here "
        "by default.")
_define("op_trace_scopes", True, bool,
        "While a torch profiler records, run each lowered op under "
        "record_function('{op.type}:{block}/{op_idx}') so device kernels "
        "attribute back to Program ops (profiler.summarize_profile's "
        "by_framework_op). Without a profiler the scopes are not entered "
        "and cost nothing.")
_define("goodput_alert_windows", "15s,60s", str,
        "Multi-window spec of the default input_starvation burn-rate rule "
        "(short,long; both must breach before the alert fires, the "
        "monitor_alerts.py burn semantics). Only read when "
        "goodput.install_starvation_alert builds the default rule.")
_define("alert_rules", "", str,
        "Declarative SLO alert rules for monitor_alerts.py, "
        "semicolon-separated. Grammar per rule: "
        "'name:threshold:STAT OP VALUE[:for=DUR]' over a counter/gauge, "
        "'name:ratio:NUM/DEN OP VALUE[:for=DUR]' over two counters, or "
        "'name:burn:HIST:pQQ OP VALUE:windows=W1,W2' multi-window burn "
        "rate over a histogram percentile (fires only when EVERY window "
        "breaches). OP is one of > >= < <=; durations accept s/m/h "
        "suffixes. Empty (default) disables the evaluator entirely.")
_define("alert_eval_interval_s", 5.0, float,
        "Period of the background alert evaluator thread (seconds). Each "
        "tick snapshots the monitor registry once and evaluates every "
        "FLAGS_alert_rules rule against it; <= 0 disables the background "
        "thread (rules still evaluate via AlertEngine.evaluate_once(), "
        "which tests drive with a fake clock).")
_define("alert_bundle_dir", "", str,
        "Directory for incident bundles: on each pending->firing "
        "transition the alert engine writes exactly one atomic JSON "
        "bundle correlating the rule, the full stats snapshot, breaching-"
        "bucket trace exemplars, the kept-trace ring, and the flight-"
        "recorder ring. Empty (default) = bundles disabled; alerts still "
        "fire and expose via /alertz and ALERTS exposition.")
_define("alert_bundle_max_spans", 512, int,
        "Cap on kept-trace-ring spans embedded in one incident bundle "
        "(newest kept spans win, after breaching-bucket exemplar traces "
        "are included first). Bounds bundle size on busy servers.")
_define("program_verify", "warn", str,
        "Static program verification (analysis/) before the executor or "
        "the serving engine prepares a run: 'off' = skip; 'warn' "
        "(default) = verify once per (program fingerprint, feeds, "
        "fetches) and surface the findings as one summarized warning; "
        "'error' = raise ProgramVerificationError on error-severity "
        "findings, with '{op_type}:{block}/{op_idx}' provenance, before "
        "the executor's cache records a miss. Shape and dtype inference "
        "runs each op's lowering on meta tensors: no data, no kernel.")
_define("graph_opt_level", 1, int,
        "Program-IR optimization before the run (analysis/passes): 0 = "
        "run the program as built; 1 (default) = dead-op elimination, "
        "constant folding and CSE on a verified clone; 2 adds "
        "elementwise-chain fusion (one fused_elementwise op replaying "
        "the chain), buffer reuse and the donation plan. The optimized "
        "program must re-verify clean (error semantics) before it "
        "replaces the original, and it is what the executor's cache is "
        "keyed on.")
_define("memory_budget_bytes", 0, int,
        "Device-memory budget of the static memory gate "
        "(analysis/memory.py). 0 (default) = the card's total memory "
        "(core.memory.device_memory_stats); the CPU reports none, so the "
        "gate never fires there. -1 = never apply a budget. A positive "
        "value is the budget in bytes. PTV050 fires when a program's "
        "estimated peak exceeds it, PTV051 when one tensor alone does.")
_define("memory_gate", "error", str,
        "The static memory gate (analysis/memory.py): 'off' = skip; "
        "'warn' = analyze once per (fingerprint, feed shapes, fetches, "
        "budget) and surface PTV05x findings as one summarized warning; "
        "'error' (default) = raise ProgramVerificationError on "
        "PTV050/PTV051 in Executor.run before the cache records a miss, "
        "and in ServingEngine.warmup before any ladder cell runs.")
_define("buffer_reuse", True, bool,
        "Enable the buffer-reuse rewrite (analysis/passes/reuse.py) at "
        "FLAGS_graph_opt_level >= 2: transient vars of one shape and "
        "dtype with disjoint liveness intervals are renamed onto one "
        "buffer, after each in-place state update is sunk to just past "
        "its last dependency.")
_define("sharding_verify", "warn", str,
        "The sharding gate (analysis/sharding.py, the PTV06x sibling of "
        "FLAGS_program_verify / FLAGS_memory_gate): 'off' = skip; 'warn' "
        "(default) = propagate the SpecLayout through the program graph "
        "once per (fingerprint, mesh, feed shapes, fetches) and surface "
        "PTV060-063 findings as one summarized warning; 'error' = raise "
        "ProgramVerificationError on PTV060 layout-inconsistent ops, in "
        "Executor.run before the cache records a miss and in "
        "ServingEngine.warmup before any ladder cell runs. The gate "
        "engages only when a layout is in scope (the sharded executor's "
        "SpecLayout, or FLAGS_sharded_mesh set); with no mesh it is a "
        "no-op. The same pass prices the implied collectives into a "
        "predicted collective_bytes_per_step.")
_define("sharded_exec", False, bool,
        "Sharded execution (parallel/layout.py): when a CompiledProgram "
        "runs data-parallel, attach a SpecLayout table over the "
        "FLAGS_sharded_mesh mesh of ranks: feeds split their batch over "
        "the data axis, and the optimizer moments and the weight update "
        "are ZeRO-sharded across the ranks (arxiv 2004.13336); each rank "
        "keeps its dim-0 shard, reduce-scatters the gradient and "
        "all-gathers the parameter. Off = replicated data parallelism. "
        "Traced: flipping it prepares a new run.", traced=True)
_define("sharded_mesh", "", str,
        "Mesh shape for FLAGS_sharded_exec as 'dp', 'dp,tp' or "
        "'dp,tp,fsdp' (e.g. '2' or '4,2'); axis 0 is the data axis. "
        "Empty = the parallel.get_mesh() registry mesh (every rank on a "
        "1-D data axis). Traced: a shape change prepares a new run.",
        traced=True)
