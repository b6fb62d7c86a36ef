#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, one progress line each; any failure exits non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile the kernel source (csrc/flash_attention_fwd.cu) with
             nvcc for sm_90a.
3. kernels — hold each kernel against its plain PyTorch version on the
             card at the shapes the serving path gives it, and time the
             kernel, the plain version and one PyTorch library call that
             computes the same function (a yardstick only; the port never
             calls it).
4. serve   — build BERT-base (12 layers, d 768, 12 heads, d_ff 3072, vocab
             30522) with tokens [-1, 512] through the port, run its startup
             program on the card from a fixed seed, save it as an inference
             model and serve it through ServingEngine: concurrent requests
             of 1-3 rows, answers checked for shape and finiteness, no new
             executor cache entry after warmup, each kernel's launch count
             set to 0 just before the requests and read just after, and one
             answer checked against the same saved model run on the CPU
             through the plain versions.
5. buckets — after the serving run: per batch bucket (1, 2, 4, 8) the
             predictor's run time and the forward's card time, and at
             batch 8 a torch.profiler breakdown of device time by kernel
             class with the device's busy share.

The last two lines of standard output are one JSON object listing the
kernels (launches on the serving path, error, times, bound) and the
result line {"ok": true, "device": {...}}.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

SEED = 1234
T = 512                  # BERT-base sequence length
H, HD = 12, 64           # heads, head dim
MAX_BATCH = 8            # EngineConfig(max_batch_size=8)
N_REQUESTS = 16
N_THREADS = 4
# published H100 SXM peaks (NVIDIA data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12        # float32 outside the tensor cores
BF16_FLOPS = 989e12      # dense bf16 tensor cores


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase(tag, **kv):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call on the card, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(bh, t, d, causal, elsize):
    """Least time for the work: bytes (q, k, v read once, o and the
    float32 lse written once) over HBM rate vs operations over the peak
    rate of the input type; causal counts only the keys at or before
    each query. Returns (ms, "bytes" | "operations")."""
    nbytes = 4 * bh * t * d * elsize + bh * t * 4
    pairs = t * (t + 1) / 2 if causal else t * t
    flops = 4.0 * bh * pairs * d
    peak = F32_FLOPS if elsize == 4 else BF16_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else \
        (t_bytes, "bytes")


def kernel_phase(torch):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def qkv(bh, t, d, dtype):
        return [torch.randn((bh, t, d), generator=gen, device=dev)
                .to(dtype) for _ in range(3)]

    # (bh, T, d, dtype, causal): the serving path's batch buckets 8 and 1
    # (96 and 12 rows x heads) in both dtypes and masks, a ragged T, d=128
    cases = [(96, T, HD, torch.float32, False),
             (96, T, HD, torch.float32, True),
             (96, T, HD, torch.bfloat16, False),
             (96, T, HD, torch.bfloat16, True),
             (12, T, HD, torch.float32, False),
             (96, 300, HD, torch.float32, False),
             (96, 300, HD, torch.float32, True),
             (24, T, 128, torch.float32, False),
             (24, T, 128, torch.bfloat16, True)]
    main_err = None
    for bh, t, d, dtype, causal in cases:
        q, k, v = qkv(bh, t, d, dtype)
        # through the wrapper, in the [b, h, T, d] layout the model uses
        shape4 = (bh // H, H, t, d) if bh % H == 0 else (1, bh, t, d)
        o = fa.flash_attention(q.view(shape4), k.view(shape4),
                               v.view(shape4), causal=causal).view(q.shape)
        _, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        ref = fa.reference_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (o.float() - ref.float()).abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
        if causal:
            pos = torch.arange(t, device=dev)
            s = s.masked_fill(pos[:, None] < pos[None, :], float("-inf"))
        lse_err = (lse - torch.logsumexp(s, dim=-1)).abs().max().item()
        phase("kernel", case=f"bh{bh}_T{t}_d{d}_{str(dtype)[6:]}"
              f"{'_causal' if causal else ''}", max_abs_err=f"{err:.3e}",
              tol=tol, lse_err=f"{lse_err:.3e}")
        check(math.isfinite(err) and err <= tol,
              f"flash_attention disagrees with its plain version: "
              f"{err} > {tol}")
        check(lse_err <= 1e-3, f"lse disagrees: {lse_err}")
        if (bh, t, d, dtype, causal) == cases[0]:
            main_err = err

    # times at the serving path's shape: [96, 512, 64] float32
    bh, t, d, dtype, causal = cases[0]
    q, k, v = qkv(bh, t, d, dtype)
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
    plain_ms = cuda_ms(lambda: fa.reference_attention(q, k, v,
                                                      causal=causal))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=causal))
    bound_ms, bound_by = attention_bound_ms(bh, t, d, causal, 4)
    phase("kernel_time", shape=f"[{bh},{t},{d}] float32", ms=f"{ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
          bound_ms=f"{bound_ms:.4f}", bound_by=bound_by)
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention_fwd.cu",
            "replaces": "paddle_tpu/ops/pallas/flash_attention.py:63",
            "max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def serve_phase(torch, card):
    with tempfile.TemporaryDirectory(prefix="ptt_bert_") as model_dir:
        return _serve(torch, card, model_dir)


def _serve(torch, card, model_dir):
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine

    cfg = transformer.bert_base(use_flash=True, dropout=0.1,
                                attn_dropout=0.0)
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        tokens = ptt.layers.data("tokens", shape=[T], dtype="int64")
        hidden = transformer.encoder(tokens, cfg)
    scope = ptt.Scope()
    t0 = time.perf_counter()
    with ptt.scope_guard(scope):
        exe = ptt.Executor()  # the card
        exe.run(startup)
        ptt.io.save_inference_model(model_dir, ["tokens"], [hidden], exe,
                                    main_program=main)
    n_ops = len(main.global_block().ops)
    phase("serve_build", layers=cfg.n_layers, d_model=cfg.d_model,
          heads=cfg.n_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size, T=T,
          ops=n_ops, seconds=f"{time.perf_counter() - t0:.2f}")

    engine = ServingEngine(EngineConfig(max_batch_size=MAX_BATCH),
                           predictor=create_paddle_predictor(
                               AnalysisConfig(model_dir)))
    t0 = time.perf_counter()
    engine.start()
    warm = engine.cache_stats()
    phase("serve_warmup", shapes=len(engine.warmup_shapes()),
          misses=warm["misses"], seconds=f"{time.perf_counter() - t0:.2f}")

    rng = np.random.RandomState(SEED)
    reqs = [rng.randint(0, cfg.vocab_size, (int(rng.randint(1, 4)), T))
            .astype("int64") for _ in range(N_REQUESTS)]
    answers = [None] * N_REQUESTS
    latency = [None] * N_REQUESTS
    errors = []

    def client(idx):
        for i in idx:
            t_sub = time.perf_counter()
            try:
                answers[i] = engine.predict({"tokens": reqs[i]},
                                            timeout_ms=60000)[0]
            except Exception as e:  # recorded and re-raised below
                errors.append(e)
                return
            latency[i] = time.perf_counter() - t_sub

    threads = [threading.Thread(target=client,
                                args=(range(j, N_REQUESTS, N_THREADS),))
               for j in range(N_THREADS)]
    # the serving path's run: every count to 0 just before, read after
    flash_attention.launches = 0
    batches0 = engine.batches
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    wall = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads),
          "a client thread did not finish")
    launches = flash_attention.launches
    batches = engine.batches - batches0
    misses = engine.cache_stats()["misses"]
    engine.stop()
    if errors:
        raise errors[0]

    for x, y in zip(reqs, answers):
        check(y is not None and y.shape == (x.shape[0], T, cfg.d_model),
              f"answer shape {None if y is None else y.shape}")
        check(np.isfinite(y).all(), "non-finite answer")
    check(misses == warm["misses"],
          f"executor cache misses moved after warmup: {warm['misses']} "
          f"-> {misses}")
    check(batches > 0 and launches == cfg.n_layers * batches,
          f"flash_attention_fwd launches {launches} != {cfg.n_layers} x "
          f"{batches} batches")

    cpu_cfg = AnalysisConfig(model_dir)
    cpu_cfg.disable_gpu()
    cpu_out = create_paddle_predictor(cpu_cfg).run_dict(
        {"tokens": reqs[0]})[0]
    cpu_err = float(np.abs(cpu_out - answers[0]).max())
    check(cpu_err <= 2e-3, f"card vs CPU answer differs by {cpu_err}")

    lat = sorted(latency)
    phase("serve", requests=N_REQUESTS, rows=sum(r.shape[0] for r in reqs),
          batches=batches, launches=launches,
          misses_after_warmup=misses - warm["misses"],
          req_per_s=f"{N_REQUESTS / wall:.3f}",
          p50_ms=f"{lat[len(lat) // 2] * 1e3:.2f}",
          max_ms=f"{lat[-1] * 1e3:.2f}", cpu_max_abs_err=f"{cpu_err:.3e}",
          card=f"'{card}'")
    bucket_phase(torch, card, cfg, engine.predictor, exe, scope,
                 main.clone(for_test=True), hidden.name, rng)
    return {"flash_attention_fwd": launches}


def _model_flops(cfg, batch):
    """A forward's operations: 2 per multiply-add of every product,
    attention included."""
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.d_model // cfg.n_heads
    linear = cfg.n_layers * (4 * d * d + 2 * d * f)
    attn = cfg.n_layers * 4 * batch * cfg.n_heads * T * T * dh
    return 2.0 * batch * T * linear + attn


def _kernel_class(name):
    if "fwd_kernel" in name:
        return "flash_attention_fwd"
    if any(s in name.lower() for s in ("gemm", "cutlass", "xmma", "matmul")):
        return "matmul"
    return "other"


def bucket_phase(torch, card, cfg, predictor, exe, scope, prog, fetch, rng):
    """Per ladder bucket: the predictor's run (feed copy, forward, fetch
    to numpy; median of ITERS on the host clock) and the forward alone
    (tensors in and out on the card; CUDA events). At batch 8,
    torch.profiler over ITERS forwards: device time by kernel class and
    the device's busy share of the traced wall time."""
    import statistics
    from torch.profiler import ProfilerActivity, profile

    iters = 10

    def forward(feed_t):
        return exe.run(prog, feed={"tokens": feed_t}, fetch_list=[fetch],
                       scope=scope, return_numpy=False)

    for b in (1, 2, 4, MAX_BATCH):
        toks = rng.randint(0, cfg.vocab_size, (b, T)).astype("int64")
        predictor.run_dict({"tokens": toks})
        runs = []
        for _ in range(iters):
            t0 = time.perf_counter()
            predictor.run_dict({"tokens": toks})
            runs.append((time.perf_counter() - t0) * 1e3)
        feed_t = torch.from_numpy(toks).cuda()
        fwd_ms = cuda_ms(lambda: forward(feed_t), iters=iters, warmup=1)
        flops = _model_flops(cfg, b)
        phase("bucket", batch=b, run_ms=f"{statistics.median(runs):.3f}",
              forward_ms=f"{fwd_ms:.3f}", model_tflop=f"{flops / 1e12:.4f}",
              tflops=f"{flops / fwd_ms / 1e9:.2f}", card=f"'{card}'")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            forward(feed_t)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_class = {"flash_attention_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            by_class[_kernel_class(ev.key)] += dev_us / 1e3
    busy = sum(by_class.values())
    # no device time recorded means the profiler could not trace the card
    phase("profile", batch=MAX_BATCH, forwards=iters,
          wall_ms=f"{wall_ms:.3f}",
          busy_share=f"{busy / wall_ms:.4f}" if busy else "not measured",
          **{f"{k}_ms_per_forward": f"{v / iters:.3f}"
             for k, v in by_class.items()}, card=f"'{card}'")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401
    from paddle_tpu_torch.ops.cuda import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _, log = build.build("flash_attention_fwd")
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          found_built=not log)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  flash_attention_fwd: {line.strip()}", flush=True)

    record = kernel_phase(torch)
    launches = serve_phase(torch, card)
    record["launches"] = launches[record["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: record[k] for k in keys}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
