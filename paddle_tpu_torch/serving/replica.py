"""Standalone subprocess replica: one engine + HTTP front end per
process, on the card unless ``--cpu`` asks for the CPU.

    python -m paddle_tpu_torch.serving.replica --model-dir DIR \\
        --seq-buckets "" --port-file /tmp/r0.port
    python -m paddle_tpu_torch.serving.replica --weights w.npz \\
        --vocab 32000 --d-model 768 --n-heads 12 --n-layers 12 \\
        --d-ff 3072 --max-seq 512 --slots 8 --block-size 16 \\
        --port-file /tmp/r1.port

The JAX package's tools/serving_replica.py over this package's engines.
A router registers each running replica as ``Replica(url=...)``. Two
backends:

* --model-dir DIR: a saved inference model behind a warmed
  ServingEngine (/v1/predict). ``--seq-buckets ""`` serves a model whose
  feeds have no dynamic sequence axis (BERT-base at T 512).
* --weights FILE.npz: a paged GPT GenerationEngine (/v1/generate,
  /v1/kv/export, /v1/kv/adopt). The npz holds the parameter tensors
  under their training-graph names; the engine's startup program never
  runs, so the loaded weights survive and every replica process decodes
  from identical parameters.

Lifecycle: build -> warm (every executor cache entry) -> bind -> write
--port-file (atomically, after readiness) -> print one ``{"kind":
"replica_ready"}`` line -> serve until SIGTERM/SIGINT -> drain and exit
0. The signal handler only sets an event; draining happens on the main
thread.

``--kv-digest`` prints one ``{"kind": "kv_export" | "kv_adopt"}`` line a
transfer with the sha256 of the shipment's rows (export: the shipped
bytes; adopt: the rows the pool holds after adoption), so a caller can
hold the two sides of a hop to the same bytes. ``--trace-out FILE``
writes the span ring (FLAGS_enable_trace) as JSONL when the replica
exits.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

import numpy as np


def _place(args):
    import paddle_tpu_torch as ptt
    return ptt.CPUPlace() if args.cpu else ptt.CUDAPlace(0)


def build_gen_engine(args):
    """A paged GenerationEngine over the weights of `args.weights` on
    the replica's place (its startup never runs)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import GenerationEngine

    place = _place(args)
    cfg = gpt.gpt_small(vocab_size=args.vocab, d_model=args.d_model,
                        n_heads=args.n_heads, n_layers=args.n_layers,
                        d_ff=args.d_ff, max_seq_len=args.max_seq,
                        dropout=0.0, use_flash=False)
    exe = ptt.Executor(place)   # raises where the place has no device
    with np.load(args.weights) as data:
        scope = scope_from_numpy({n: data[n] for n in data.files},
                                 ptt.Scope(), place)
    # start() seeds only the decode state ("gen." names) and warms the
    # programs; the loaded weights are untouched
    return GenerationEngine(
        cfg, scope, exe=exe, max_slots=args.slots, max_seq=args.max_seq,
        default_timeout_ms=args.timeout_ms, paged=True,
        block_size=args.block_size or None,
        kv_pool_blocks=args.kv_pool_blocks or None,
        spec_decode=args.spec_decode or None,
        spec_k=args.spec_k or None)


def build_serving_engine(args):
    """A ServingEngine over the saved model in `args.model_dir`."""
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine

    config = AnalysisConfig(args.model_dir)   # the card unless --cpu
    if args.cpu:
        config.disable_gpu()
    seqs = tuple(int(s) for s in args.seq_buckets.split(",") if s.strip())
    return ServingEngine(
        EngineConfig(args.model_dir, max_batch_size=args.max_batch_size,
                     default_timeout_ms=args.timeout_ms,
                     seq_buckets=seqs or None, warmup=True),
        predictor=create_paddle_predictor(config))


_EMIT_LOCK = threading.Lock()


def _emit(rec):
    """Print one JSON record as one line. The kv hook runs on the HTTP
    server's request threads: a plain print writes the text and its
    newline apart, so two threads could put two records on one line."""
    with _EMIT_LOCK:
        sys.stdout.write(json.dumps(rec) + "\n")
        sys.stdout.flush()


def kv_digest_hook(route, gen, req, out):
    """ServingHTTPServer.kv_hook that prints a transfer's row digest."""
    from paddle_tpu_torch.serving import disagg, kv_wire
    if route == "export":
        rec = {"kind": "kv_export", "blocks": out["n_blocks"],
               "chain_tail": (out["chain_hashes"] or [None])[-1],
               "sha256": kv_wire.rows_digest(out["layers"])}
    else:
        hashes = [str(h) for h in req.get("chain_hashes", ())]
        d = disagg.resident_rows_digest(gen, hashes)
        rec = {"kind": "kv_adopt", "blocks": d["blocks"],
               "shipped": len(hashes),
               "chain_tail": hashes[-1] if hashes else None,
               "sha256": d["sha256"], "adopted": out["adopted"],
               "duplicate": out["duplicate"]}
    _emit(rec)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="standalone subprocess serving replica")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="0 (default) binds an ephemeral port")
    ap.add_argument("--port-file",
                    help="write the bound port here once READY "
                         "(written atomically after warmup + bind)")
    ap.add_argument("--model-dir",
                    help="saved inference model -> ServingEngine "
                         "(/v1/predict)")
    ap.add_argument("--weights",
                    help="npz of GPT parameters -> paged "
                         "GenerationEngine (/v1/generate + /v1/kv/*)")
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--n-heads", type=int, default=4)
    ap.add_argument("--n-layers", type=int, default=2)
    ap.add_argument("--d-ff", type=int, default=64)
    ap.add_argument("--max-seq", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=0)
    ap.add_argument("--kv-pool-blocks", type=int, default=0)
    ap.add_argument("--timeout-ms", type=float, default=10000.0)
    ap.add_argument("--max-batch-size", type=int, default=8)
    ap.add_argument("--seq-buckets", default="8,16,32",
                    help='comma-separated; "" = no sequence axis')
    ap.add_argument("--spec-decode", action="store_true")
    ap.add_argument("--spec-k", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card, CUDAPlace(0))")
    ap.add_argument("--kv-digest", action="store_true",
                    help="print each KV transfer's row sha256")
    ap.add_argument("--trace-out",
                    help="write the kept spans here (JSONL) on exit")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not args.model_dir and not args.weights:
        print("need --model-dir and/or --weights", file=sys.stderr)
        return 2

    from paddle_tpu_torch import trace
    from paddle_tpu_torch.serving import serve

    engine = build_serving_engine(args) if args.model_dir else None
    gen = build_gen_engine(args) if args.weights else None

    stop_evt = threading.Event()

    def _on_signal(signum, frame):
        stop_evt.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    # serve() warms the engines (every executor cache entry of the
    # process's lifetime) before binding, so the port's appearance IS
    # readiness
    srv = serve(engine, port=args.port, gen_engine=gen)
    if args.kv_digest:
        srv.kv_hook = kv_digest_hook
    port = srv.port
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(port))
        os.replace(tmp, args.port_file)  # atomic: readers never see ""
    _emit({"kind": "replica_ready", "pid": os.getpid(), "port": port,
           "url": f"http://{args.host}:{port}",
           "predict": engine is not None, "generate": gen is not None})

    while not stop_evt.wait(0.2):
        pass

    # SIGTERM-clean: finish in-flight work, then release everything
    srv.close(drain=True)
    if gen is not None:
        gen.stop(drain=True)
    if engine is not None:
        engine.stop(drain=True)
    if args.trace_out:
        trace.export_jsonl(args.trace_out, trace.drain_spans())
    _emit({"kind": "replica_exit", "pid": os.getpid()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
