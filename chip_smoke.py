#!/usr/bin/env python3
"""Drive paddle_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --mutants    # the kernels' mutation check
    python3 chip_smoke.py --compare DIR  # time the wgmma kernels (bf16
                                         # and float32) of the checkout at
                                         # DIR and of this one in turns
                                         # (DIR, this, this, DIR) on one
                                         # card
    python3 chip_smoke.py --ablations  # time the wgmma kernels with one
                                       # part of their work dropped

Phases, one progress line each; any failure exits non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile the kernel sources (csrc/flash_attention_fwd.cu,
             csrc/flash_attention_bwd.cu) with nvcc for sm_90a, one nvcc
             per source, started together; print each kernel instance's
             registers and fail if one spills.
3. kernels — hold the forward kernel against its plain PyTorch version on
             the card at the shapes the serving and both training paths
             give it (and ragged T at the tile edges, T 1024, d 32 and
             128, bh 12; float32 O and LSE within 1e-4, bfloat16 by
             relative error and differing share),
             and time it at the serving shape beside the plain version and
             one PyTorch library call that computes the same function (a
             yardstick only; the port never calls it).
   kernels (backward) — hold the dq and dk/dv kernels against their plain
             versions (the training shapes [384, 512, 64] bf16 and
             [192, 512, 64] f32, and in each dtype causal, ragged T in
             both masks at the kernels' tile edges, T 1024 causal, d 128
             in both masks, d 32, bh 12; float32 within 1e-4), then time
             all three kernels at the training shape in bf16 beside
             their plain versions, SDPA's forward and the backward of
             SDPA (one call for dq, dk and dv)
             as yardsticks, with the achieved TFLOP/s, and the port's
             whole backward (FlashAttentionFunction's: delta, dq, dk/dv)
             beside SDPA's, the same work; the two float32
             backward kernels at [384, 512, 64] and [192, 512, 64] beside
             float32 SDPA's backward, and at [192, 512, 64] the float32
             forward beside float32 SDPA's forward, each with its 3xTF32
             bound and its CUDA-core bound; and the three bf16 kernels at
             NMT's [512, 256, 64] in both masks.
4. serve   — build BERT-base (12 layers, d 768, 12 heads, d_ff 3072, vocab
             30522) with tokens [-1, 512] through the port, run its startup
             program on the card from a fixed seed, save it as an inference
             model and serve it through ServingEngine: concurrent requests
             of 1-3 rows, answers checked for shape and finiteness, no new
             executor cache entry after warmup, each kernel's launch count
             set to 0 just before the requests and read just after, and one
             answer checked against the same saved model run on the CPU
             through the plain versions. Then the same requests through a
             new engine with the monitor, tracing and goodput on
             ([serve_hooks]): the same answers and gates, the stats the
             JAX package's engine records (SERVE_STATS), each request's
             and batch's span tree, the goodput ledger summing to its wall
             clock, and requests/s with the hooks off and on.
   serve_gates — (after serve_hooks) the same saved model through a
             new ServingEngine with FLAGS_program_verify=error and the
             gate memos empty: warmup's analysis.* stats show one verify,
             one optimize and one memory plan per ladder cell, no cache
             miss after warmup, the answers within SERVE_GATE_TOL of
             [serve]'s, the float32 forward 12 times a batch; then a
             budget of half the planner's estimate for the largest cell
             refuses warmup with PTV050, and a copy of the program with
             an undeclared read refuses Executor.run with PTV010, each
             with the cache misses and the card's allocated bytes
             unchanged.
5. buckets — after the serving run: per batch bucket (1, 2, 4, 8) the
             predictor's run time and the forward's card time, and at
             batch 8 a torch.profiler breakdown of device time by kernel
             class with the device's busy share (the float32 forward must
             run fwd_kernel_tf32wg 12 times a forward, and the scalar
             fwd_kernel never).
6. train   — BERT-base training at full width through build_train (batch
             32, T 512, bf16 AMP, AdamW lr 1e-4, dropout 0.1): startup on
             the card from a fixed seed, 3 warm-up and 10 timed steps with
             labels = tokens; losses finite and falling, each kernel
             launched 12 times per timed step (counts set to 0 just
             before, read just after), no executor cache miss after the
             first step; median step time, the host's median time to
             enqueue a step, tokens/s, MFU, and a torch.profiler split of
             one step by kernel class with each flash kernel's symbol and
             launches (the bf16 step must run fwd_kernel_wgmma,
             dq_kernel_wgmma and dkv_kernel_wgmma 12 times each, and no
             other flash kernel).
7. train_f32 — the same training in float32 at batch 16 (float32
             activations take twice AMP's memory), 2 warm-up and 5 timed
             steps, the same gates; MFU against the CUDA cores' float32
             peak, peak memory, and the profiled step must run
             fwd_kernel_tf32wg, dq_kernel_tf32wg and dkv_kernel_tf32wg 12
             times each and no other flash kernel.
   compiled_train — [train]'s step through
             CompiledProgram(main).with_data_parallel(loss_name=...) at
             FLAGS_graph_opt_level 0, 1 and 2, 3 steps each from one
             startup state under torch's deterministic algorithms: losses
             and final state at levels 1 and 2 equal to level 0's, each
             flash kernel 12 times a step, no cache miss after the first
             step; per level the passes' op counts, fused groups, renamed
             vars, sunk updates and donation plan, each gate's first-run
             host seconds, the planner's peak estimate beside the
             measured peak, host ms a step and one profiled step's device
             ms.
   Every training run through run_steps also prints [<tag>_plan]: the
             static memory planner's peak estimate for its program and
             feed beside the measured peak (no bar).
8. train_cpu_check — the same model at batch 1, dropout 0, in float32
             and in bf16 AMP: one step on the card and one on the CPU
             (plain versions) from the same startup values; the loss and
             three parameters' gradients must agree, and attention must
             run in bf16 under AMP; the float32 card step must launch each
             kernel 12 times.
9. bert_recipe — BERT-base MLM pretraining as bench.py's MLM step (b32,
             T512, 80 masked positions, bf16 AMP, dropout 0.1) under
             BERT's published recipe: AdamW (weight decay 0.01, epsilon
             1e-6), 1e-4 warmed up over 10k steps then decayed linearly
             to 0 at 1M, a global-norm clip of 1.0 (RECIPES["bert"]); the
             step counter set so that 3 warm-up and 10 timed steps read
             9995-10007. run_steps' gates, losses need not fall; each
             step's rate equal to the closed form (recipe_lr) within 1e-6
             relative across the end of warmup (0.995e-4 at 10000), the
             global norm finite and positive, parameters moved; the op
             count (1632) and host ms beside [train]'s, and the profiled
             step's device ms by part (schedule, regularizer and clip,
             update, model).
10. bert_lamb — the same with Lamb (weight decay 0.01) under NVIDIA's
             phase-1 LAMB recipe (6e-3, warmup 2000 of 7038 steps,
             power 0.5; RECIPES["lamb"]), the steps across step 2000.
11. recipe_cpu_check — BERT-base at batch 1, float32, dropout 0: two
             AdamW recipe steps from counter 9999 and one LAMB step at
             2000, each on the card and on the CPU from the same startup
             values: loss and global norm within 1e-4, the rates equal
             and on the closed form, every clipped gradient within 1e-3
             (Frobenius), every parameter's update within
             RECIPE_UPDATE_RTOL.
12. gpt_train — GPT-small (12 layers, d 768, 12 heads, d_ff 3072, vocab
             32000) through models/gpt.build_train at bench.py's GPT step:
             batch 32, seq_len 512 (the in-graph shift leaves T 511,
             causal), bf16 AMP, AdamW lr 3e-4, dropout 0.1; 3 warm-up and
             10 timed steps with the same gates as train (each bf16 kernel
             12 times a step at [384, 511, 64] causal); MFU from bench.py's
             causal count.
13. gpt_cpu_check — the same GPT at batch 1, dropout 0, bf16 AMP: one
             step on the card against one on the CPU, under train_cpu_check's
             AMP limits.
14. gpt_generate — from the trained GPT scope, in float32 with the same
             weights: serial greedy kv_generate through the slab decode step
             (batch 1, max_seq 512) for 8 prompts of 1 to 300 tokens and 32
             new tokens each, then the same 8 prompts submitted at once to a
             paged GenerationEngine (8 slots, block 16, chunked prefill)
             whose steps engine_generate sees through; the streams must be
             equal, the engine's decode steps' logits within 1e-4 of the
             slab's, and no flash kernel launched.
15. gen_serve — the same scope served through GenerationEngine (8 slots,
             max_seq 512, paged KV in blocks of 16), spec decode off and
             then on: 20 concurrent requests (gen_requests below) whose
             greedy streams must equal serial kv_generate and whose
             spec-on streams must equal the spec-off ones, with prefix
             hits, a verify step, no cache entry after warmup, no block
             held after stop, no flash launch, the breaker closed, the
             engine's stats, and bounded memory; then a run under
             injected transient faults that must retry and give the same
             streams. Prints TTFT, inter-token time, tokens/s and each
             step's host and card time.
16. resnet_train — ResNet-50 (models/resnet.build_train) at bench.py's
             step: batch 64, 3x224x224, 1000 classes, bf16 AMP, Momentum
             lr 0.1, momentum 0.9, the feed from RandomState(0); 3
             warm-up and 10 timed steps: images/s, MFU (3 x
             flops_per_image a training image), peak memory, device ms by
             class (conv, matmul, norm, other); finite losses, no flash
             launch, no cache miss after the first step, every running
             mean and variance moved and finite.
17. resnet_cpu_check — the same ResNet-50 at batch 2, one step on the
             card and one on the CPU from the same startup values, in
             float32 and bf16 AMP: the loss, every parameter's gradient
             and every batch_norm's running statistics (RESNET_*_BARS).
18. resnet_recipe — ResNet-50 at bench.py's b64 AMP step under
             PaddlePaddle/models' recipe: Momentum 0.9 with L2 decay 1e-4
             and piecewise_decay 0.1 / 0.01 / 0.001 / 0.0001 at epochs
             30, 60, 90 (5005 steps an epoch at batch 256); 3 warm-up and
             5 timed steps from 4 before the first boundary: each rate
             on the closed form (0.055 at the boundary), the running
             statistics moved and finite, ops and host ms beside
             [resnet_train]'s.
19. lenet_train — LeNet (models/lenet convolutional_neural_network) as
             examples/train_mnist.py trains it: batch 128, Adam lr 1e-3,
             float32; images/s and step time, then one step card vs CPU.
20. nmt_train — Transformer-big NMT (models/nmt.build_train) at bench.py's
             step: 6+6 layers, d 1024, 16 heads, d_ff 4096, vocab 32000,
             batch 32, source and target 256, bf16 AMP, dropout 0.1,
             AdamW lr 1e-4; 3 warm-up and 10 timed steps: tokens/s, MFU
             from flops_per_step, each bf16 flash kernel 12 times a step
             at [512, 256, 64] (cross-attention takes the plain path);
             then one batch-1 step with dropout 0 card vs CPU under the
             AMP limits.
21. http_serve — (after gen_serve, on the serve phase's saved BERT-base
             and the trained GPT-small) one ServingHTTPServer over a
             ServingEngine and a GenerationEngine: the serve requests to
             /v1/predict and the gpt_generate prompts to /v1/generate
             from 4 threads, answers held to the engines' own and to the
             serial streams, the float32 forward 12 times a forward,
             /healthz, a 400, a /v1/kv/export shipment that a second
             paged engine adopts and decodes the serial stream from, and
             a threshold rule in FLAGS_alert_rules that must fire (ALERTS
             on /metrics, /alertz, one incident bundle); req/s and
             p50/p99 over HTTP beside the direct numbers.
22. deeplab_train — DeepLabv3+ (models/deeplab.build_train) at bench.py's
             step: batch 8, 3x513x513, 19 classes, bf16 AMP, Momentum
             lr 1e-3, momentum 0.9; 3 warm-up and 10 timed steps:
             images/s, MFU, peak memory, device ms by class; every
             running statistic moved and finite.
23. profiler — profiler.profiler() around two deeplab_train steps: the
             summary's device time inside op scopes within 10% of
             twice the profiled step's (profiler_gate; both sides'
             kernels outside every scope, the feed's copies, printed
             apart), classes adding up, the conv2d op scopes named, a
             chrome trace written.
24. deeplab_cpu_check — DeepLabv3+ at batch 1, 3x65x65 (one value a
             channel in the image-pooling branch's batch_norm), card vs
             CPU in float32 and AMP from the branch-scaled state.
25. guard_train — TrainerGuard around LeNet (batch 128, Adam): a NaN
             batch rolled back, a preemption checkpointed, a fresh
             guard's resume, resumed losses against an uninterrupted
             run's.
26. dygraph_bert — BERT-base written as a dygraph Layer
             (make_dygraph_bert: Embedding, Linear, LayerNorm, Dropout
             0.1, and reshape, transpose, flash_attention and
             softmax_with_cross_entropy through the layer dispatch) at
             batch 16, T 512, float32, trained eagerly on the card:
             loss.backward(), AdamW (weight decay 0.01) with a dygraph
             PolynomialDecay under the global-norm clip of 1.0; 2 warm-up
             and 5 timed steps, then one profiled: host and device ms,
             tokens/s, each step's peak memory (flat within 5% of step
             2's: no tape keeps a step's activations), the ratio of the
             peak to [train_f32]'s static step, each float32 flash
             kernel 12 times a step, two AdamW moments a parameter.
27. dygraph_trace — TracedLayer.trace of the trained encoder in eval()
             at batch 8: the captured Program on the card's Executor
             against the eager output (2e-3), 12 float32 forwards a call,
             save_inference_model and load_inference_model in a fresh
             scope, and a traced op on the input alone that must follow
             a second input.
28. dygraph_cpu_check — the same model at batch 1, dropout 0, on the
             card and on the CPU from one state dict: the loss, every
             gradient and, after two AdamW steps, every update, under
             [recipe_cpu_check]'s bars; the flash backward runs on the
             eager autograd path.
29. dygraph_resnet — ResNet-50 as a dygraph Layer (make_dygraph_resnet)
             at batch 64, 3x224x224, float32, under Momentum 0.9, L2 1e-4
             and a dygraph PiecewiseDecay: 2 + 5 steps, then eval() on
             the batch: images/s, flat peak memory, the running
             statistics moved and read by eval(), no optimizer state for
             them.
30. dygraph_layers — each of the 18 dygraph.nn layers forward and
             backward on the card against the CPU port from one state
             dict (1e-4), NCE against its formula on the card's own
             negatives, Dropout's kept share.
31. loader_bert — [train]'s BERT-base step fed by
             fluid.io.DataLoader.from_generator (capacity 2,
             set_batch_generator, a fresh RandomState(step) batch a
             step), 3 + 10 steps with goodput on: run_steps' gates,
             reader.batches, the goodput ledger summing to its wall
             clock, and losses equal to the same arrays fed directly
             from the same startup state (torch's deterministic
             algorithms on); host and device ms beside [train]'s, the
             input wait's p50 and max.
32. loader_starved — the same loader for 4 steps under a reader stall
             of twice loader_bert's host step (slow_step:site=reader):
             input_wait the largest goodput category, every step
             starved.
33. reader_resnet — ResNet-50 at bench.py's b64 AMP step over a
             py_reader (read_file(double_buffer(py_reader))), fed by
             io.batch(xmap_readers(normalize, ImageNet-shaped uint8
             samples, 4, 16, order=True), 64): finite losses, one cache
             entry, the first batch equal to np.stack of its samples;
             host and device ms beside [resnet_train]'s, input wait p50.
34. mnist_book — examples/train_mnist.py's path: LeNet b128 on
             datasets.mnist through reader_decorator.shuffle, io.batch
             and DataLoader, 200 steps over 4 epochs; metrics.Accuracy
             over the last 50 steps > 0.7; io.save / io.load and
             save_params / load_params into fresh scopes give the
             continuing run's losses within 1e-6.
35. data_layers — the new tensor layers, op types and adaptive pool2d
             (with gradients) on the card against the CPU port (floats
             1e-6, integers exact), Bilinear and NumpyArray equal, the
             truncated normal inside 2 standard deviations and MSRA by
             bound and moments, save_combine / load_combine round trip.
36. se_resnext_train — SE-ResNeXt-50 32x4d (models/se_resnext.py's
             defaults, 224x224, 1000 classes) at b32 float32, Momentum
             0.9 at lr 0.1, 2 + 5 steps: images/s, MFU against the
             float32 peak, device ms by class and the grouped
             convolutions apart, each step's peak within 5% of step 2's,
             the running statistics moved and finite.
37. se_resnext_cpu_check — the JAX test's SE-ResNeXt (32x32, stages
             (1, 1), cardinality 4, base 32), b4, dropout off, one step
             on the card and on the CPU from one carried startup: loss,
             gradients and updates within SE_RESNEXT_BARS.
38. bert_large_train — BERT-large (24 layers, d 1024) MLM
             pretraining, b16 T512, 80 masked positions, bf16 AMP,
             AdamW, 2 + 5 steps: tokens/s, MFU with the LM head at the
             masked positions only, each flash kernel 24 times a step,
             peak memory flat within 5%, the kernels' ms at [256, 512,
             64].
39. book_models — word2vec (2073 words, b100) on seeded n-grams and the
             recommender (b256) on datasets.movielens through io.batch
             and DataFeeder, 100 SGD steps each: the loss falls, the
             first 3 losses within 1e-4 of the CPU's.
40. dense_layers — each of the slice's 109 op types as a one-op
             program (dense_op_cases, with gradients) on the card
             against the CPU (floats 1e-5, the rest exactly; the random
             ops by range and frequency); fails if a type did not run.
41. router_serve — (last, with the next three, after grad_merge;
             [serve]'s saved BERT-base and the trained GPT-small's
             weights kept for them) a RouterHTTP over a Router over two
             in-process Replica(engine=ServingEngine) on that BERT-base: the
             serve requests over HTTP from 4 threads (answers within
             2e-3 of [serve]'s, 12 forward launches a forward, both
             replicas served, no cache entry after warmup; req/s and
             p50/p99 beside [serve]'s and [http_serve]'s), then three
             drills with traffic flowing and zero failed requests:
             preempt and resume r0, stop r0 (re-dispatched, probed out),
             hot_swap r1 for a standby (drained, no cache entry after its
             warmup).
42. kv_wire — a bfloat16 and a float32 pool on the card packed and
             unpacked by serving/kv_wire.py: rows bit-equal, JSON equal
             to the same pools' on the CPU.
43. router_hop — one `python -m paddle_tpu_torch.serving.replica
             --model-dir` process on the card behind the router as
             Replica(url=...): answers within 2e-3 of the in-process
             ones, each replica http.request span parented under the
             router's router.dispatch span (one trace over both
             processes), SIGTERM drains and exits 0.
44. disagg_gen — three `--weights` replica processes on the card (the
             trained GPT-small written to an npz: one prefill, two
             decode replicas, paged, block 16, 8 slots) behind a Router
             with FLAGS_router_disagg on; each gpt_generate prompt twice,
             greedy: streams equal to serial, a prefix reused, no cache
             entry after warmup, each adoption's row sha256 equal to the
             export's; with the prefill replica stopped a resent prompt
             falls back to a local prefill with the same stream.

In [gen_serve] a sampled stream with spec decode on may part from its
spec-off stream at one draw that rounding explains (spec_flip_gate: the
two logits rows within 1e-4, the draw's uniform between their CDFs);
nothing after that draw is compared, and the flips and margins print.

The last two lines of standard output are one JSON object listing the
kernels (launches on the serving and training paths, error, times,
bound; the bf16 entries count the BERT (build_train, both recipes, the
DataLoader-fed run and [compiled_train]'s three levels), GPT, NMT and
BERT-large training runs and carry the GPT path's [384, 511, 64] causal
shape under `causal_*` keys, NMT's [512, 256, 64] under `nmt_*`
(encoder) and `nmt_causal_*` (decoder) keys and BERT-large's [256, 512,
64] under `bert_large_*`; the float32 instances as entries of their
own, with the serving (direct, [serve_gates], over HTTP and through
[router_serve]'s router), float32 training and float32 check-step
launches, the recipe check's and the
dygraph BERT's, its check's and its traced call's included), a [done]
line with the run's length before them, and the result line
{"ok": true, "device": {...}}.
"""
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import NamedTuple

SEED = 1234
T = 512                  # BERT-base sequence length
H, HD = 12, 64           # heads, head dim
MAX_BATCH = 8            # EngineConfig(max_batch_size=8)
N_REQUESTS = 16
N_THREADS = 4
HOOK_PAIRS = 5           # hooks off/on passes that time the hooks' cost
# published H100 SXM peaks (NVIDIA data sheet, 700 W)
TRAIN_SHAPE = (384, T, HD)  # b32 x 12 heads, the training path's shape
F32_TRAIN_SHAPE = (192, T, HD)  # b16 x 12 heads, the float32 training path
GPT_SEQ = 512            # GPT-small's bench step: seq_len 512, batch 32
GPT_BATCH = 32
GPT_SHAPE = (GPT_BATCH * H, GPT_SEQ - 1, HD)  # causal, after the shift
# generation from the trained GPT: prompt lengths, new tokens a prompt,
# the paged step's block size
GEN_PROMPT_LENS = (1, 2, 17, 64, 129, 200, 255, 300)
GEN_NEW = 32
GEN_BLOCK = 16
GEN_LOGIT_TOL = 1e-4
# Transformer-big NMT, bench.py's step: batch 32, source and target 256,
# 16 heads of 64: the flash kernels at [512, 256, 64], the encoder's
# unmasked and the decoder's causal
NMT_BATCH, NMT_LEN, NMT_HEADS = 32, 256, 16
NMT_SHAPE = (NMT_BATCH * NMT_HEADS, NMT_LEN, HD)
# BERT-large MLM pretraining: batch 16, T 512, 16 heads of 64: the flash
# kernels at [256, 512, 64]
BERT_LARGE_BATCH, BERT_LARGE_HEADS = 16, 16
BERT_LARGE_SHAPE = (BERT_LARGE_BATCH * BERT_LARGE_HEADS, T, HD)
# ResNet-50, bench.py's step: batch 64, 3x224x224, 1000 classes; the
# card-vs-CPU check step at batch 2; LeNet as examples/train_mnist.py
# trains it, at batch 128
RESNET_BATCH, RESNET_CHECK_BATCH, LENET_BATCH = 64, 2, 128
RESNET_IMAGE, RESNET_CLASSES = (3, 224, 224), 1000
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12        # float32 outside the tensor cores
TF32_FLOPS = 494.7e12    # dense TF32 tensor cores
BF16_FLOPS = 989e12      # dense bf16 tensor cores
# float32 kernels vs their plain versions, max|kernel - plain| (O, and
# the forward's LSE too). On the H100 the 3xTF32 forward reads at most
# 5.1e-6 (LSE 4.3e-6) and the 3xTF32 dQ, dK and dV at most 8.0e-5 (dV at
# T 1024 causal, where max|plain| is 5.5); the forward's S by one TF32
# product reads 3.2e-4 to 1.2e-3 (up to d 64), every product by one 2.8e-4
# to 1.5 in the forward and 3.8e-4 to 3.9e-3 in the backward (dQ at d 32
# causal up to 2.9); the backward's transposed tiles with a zero lo read
# 1.4e-4 to 1.8e-3, transposed tiles in natural key order 0.75 or more;
# keys past T unmasked in the forward 0.11 at T 129, its diagonal unmasked
# 3.8, its O not rescaled 1.5 or more, the diagonal unmasked in dQ or
# dK/dV 1.3e3 or more (MUTANTS below; PERF.md).
F32_TOL = 1e-4
# bfloat16 kernels vs their plain versions: max|kernel - plain| /
# max(1, max|plain|), and the share of elements that differ at all.
# Backward: on the H100 the sound tensor-core kernels read at most 2.8e-3
# and 2.4e-3 (they sum in another order than the plain versions); a
# kernel that skips one bf16 rounding of P or dS, rounds toward zero, or
# takes dS from the rounded P reads 2.7e-3 to 1.4e-2 and 0.41 to 0.83
# (dQ with dS from the rounded P: 3.9e-3 to 1.0e-2 and 0.52 to 0.55), one
# that leaves the dQ diagonal unmasked 1.4e2 and 0.97 (MUTANTS below;
# PERF.md).
BF16_BWD_TOL = 5e-3
BF16_BWD_DIFF_SHARE = 1e-2
# Forward, against its plain version on float32 copies of the inputs (the
# TPU kernel's float32 scores): the sound kernel reads at most 4.4e-3 and
# 0.396, a kernel that leaves keys past T unmasked 2.4e-2 and 0.998 (0.23
# at T 129), one that skips the rescale by alpha 0.52 and 0.65 or more,
# one that unmasks the causal diagonal 1.05 (MUTANTS below; PERF.md).
BF16_FWD_TOL = 1e-2
BF16_FWD_DIFF_SHARE = 0.6
# one bf16 AMP training step, card vs CPU: the loss, and each gradient's
# Frobenius gap over its norm (measured on the H100: 1.2e-5 and at most
# 8.1e-3, bf16 rounding at different points of the two devices' products)
SERVE_GATE_TOL = 1e-4      # [serve_gates] vs [serve]: other batchings
AMP_LOSS_RTOL = 1e-4
AMP_GRAD_RTOL = 2e-2


# bf16 kernel cases (bh, T, d, causal) at the ragged edges of
# the 128-row tiles of the forward and dK/dV kernels: one past a tile
# (129), inside the second tile (200), one short of two tiles (255), in
# both masks, and ragged causal cases at d 32 and 128 (a 64-byte
# swizzle; two boxes a row)
RAGGED_BF16 = [(96, 129, HD, False), (96, 129, HD, True),
               (96, 200, HD, False), (96, 200, HD, True),
               (96, 255, HD, False), (96, 255, HD, True),
               (48, 255, 32, True), (24, 200, 128, True)]
# float32 kernel cases at the same edges: the float32 forward's and dQ's
# 128-row query tiles (64 at d 128) and 32-key ring stages (dQ's 16 at d
# 128), the float32 dK/dV's 128-key tiles (64 at d 128) and 16-query ring
# stages
RAGGED_F32 = [(96, 129, HD, False), (96, 129, HD, True),
              (96, 200, HD, False), (96, 200, HD, True),
              (96, 255, HD, False), (96, 255, HD, True),
              (48, 255, 32, True), (24, 200, 128, True)]


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


# per attention kernel: [bh, T, d] tensors read and written, float32 [bh,
# T] rows moved (lse, delta), operations per (query, key) pair per head dim
KERNEL_WORK = {
    "flash_attention_fwd": (3, 1, 1, 4),      # q k v -> o, lse
    "flash_attention_bwd_dq": (4, 1, 2, 6),   # q k v dO lse delta -> dq
    "flash_attention_bwd_dkv": (4, 2, 2, 8),  # ... -> dk, dv
}


def attention_flops(kernel, bh, t, d, causal):
    """Operations of one kernel's work; causal counts only the keys at or
    before each query."""
    pairs = t * (t + 1) / 2 if causal else t * t
    return float(KERNEL_WORK[kernel][3]) * bh * pairs * d


def attention_bound_ms(kernel, bh, t, d, causal, elsize):
    """Least time for one kernel's work: bytes (each input read once,
    each output written once) over HBM rate vs operations over the peak
    rate of the units that run them: the bf16 tensor cores for bfloat16;
    for float32, three TF32 products per product (3xTF32) on the TF32
    tensor cores. Returns (ms, "bytes" | "operations")."""
    n_read, n_write, n_rows, _ = KERNEL_WORK[kernel]
    nbytes = (n_read + n_write) * bh * t * d * elsize + n_rows * bh * t * 4
    flops = attention_flops(kernel, bh, t, d, causal)
    flops, peak = (flops, BF16_FLOPS) if elsize == 2 else \
        (3 * flops, TF32_FLOPS)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else \
        (t_bytes, "bytes")


def cuda_core_bound_ms(kernel, bh, t, d, causal):
    """A float32 kernel's operations at the CUDA cores' float32 peak: the
    bound of a scalar kernel, printed beside the 3xTF32 bound."""
    return attention_flops(kernel, bh, t, d, causal) / F32_FLOPS * 1e3


def kernel_phase(torch):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def qkv(bh, t, d, dtype):
        return [torch.randn((bh, t, d), generator=gen, device=dev)
                .to(dtype) for _ in range(3)]

    f32, bf16 = torch.float32, torch.bfloat16
    ragged = [(bh, t, d, bf16, c) for bh, t, d, c in RAGGED_BF16] + \
        [(bh, t, d, f32, c) for bh, t, d, c in RAGGED_F32]
    # (bh, T, d, dtype, causal): the serving path's batch buckets 8 and 1
    # (96 and 12 rows x heads) in both dtypes and masks, ragged T, T=1024
    # (many tiles through the kernels' ring), d=32 and d=128, and the
    # training paths' shapes: bfloat16, float32, GPT's ragged causal and
    # NMT's [512, 256, 64] in both masks
    cases = [(96, T, HD, f32, False), (96, T, HD, f32, True),
             (96, T, HD, bf16, False), (96, T, HD, bf16, True),
             (12, T, HD, f32, False), (12, T, HD, bf16, False),
             (96, 300, HD, f32, False), (96, 300, HD, f32, True),
             (96, 300, HD, bf16, False), (96, 300, HD, bf16, True),
             (12, 1024, HD, f32, True), (12, 1024, HD, bf16, True),
             (48, T, 32, f32, False), (48, T, 32, bf16, False),
             (24, T, 128, f32, False), (24, T, 128, f32, True),
             (24, T, 128, bf16, False), (24, T, 128, bf16, True),
             (*TRAIN_SHAPE, bf16, False), (*F32_TRAIN_SHAPE, f32, False),
             (*GPT_SHAPE, bf16, True), (*NMT_SHAPE, bf16, False),
             (*NMT_SHAPE, bf16, True), (*BERT_LARGE_SHAPE, bf16, False),
             *ragged]
    # each training path's shape: max|kernel - plain|, by PATH_CASES key
    train_errs = {}
    for bh, t, d, dtype, causal in cases:
        q, k, v = qkv(bh, t, d, dtype)
        # through the wrapper, in the [b, h, T, d] layout the model uses
        shape4 = (bh // H, H, t, d) if bh % H == 0 else (1, bh, t, d)
        o = fa.flash_attention(q.view(shape4), k.view(shape4),
                               v.view(shape4), causal=causal).view(q.shape)
        _, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        # the plain version on float32 copies: scores in float32, as the
        # TPU kernel takes them (on bf16 inputs the plain version's score
        # product comes back rounded to bf16)
        ref, ref_lse = fa.flash_attention_fwd_reference(
            q.float(), k.float(), v.float(), causal=causal)
        torch.cuda.synchronize()
        rel, err, share = _rel_err(o, ref.to(dtype))
        lse_err = (lse - ref_lse).abs().max().item()
        case = f"bh{bh}_T{t}_d{d}_{str(dtype)[6:]}" \
            f"{'_causal' if causal else ''}"
        if dtype == f32:
            phase("kernel", case=case, max_abs_err=f"{err:.3e}", tol=F32_TOL,
                  lse_err=f"{lse_err:.3e}")
            check(math.isfinite(err) and err <= F32_TOL and
                  lse_err <= F32_TOL,
                  f"flash_attention disagrees with its plain version: "
                  f"{err} or lse {lse_err} > {F32_TOL}")
        else:
            phase("kernel", case=case, rel_err=f"{rel:.3e}",
                  diff_share=f"{share:.3e}", max_abs_err=f"{err:.3e}",
                  tol=BF16_FWD_TOL, share_tol=BF16_FWD_DIFF_SHARE,
                  lse_err=f"{lse_err:.3e}")
            check(math.isfinite(rel) and rel <= BF16_FWD_TOL and
                  share <= BF16_FWD_DIFF_SHARE,
                  f"bfloat16 flash_attention disagrees with its plain "
                  f"version: rel {rel} > {BF16_FWD_TOL} or differing share "
                  f"{share} > {BF16_FWD_DIFF_SHARE}")
        check(lse_err <= 1e-3, f"lse disagrees: {lse_err}")
        key = _path_key(torch, bh, t, d, dtype, causal)
        if key:
            train_errs[key] = err

    # times at the serving path's shape: [96, 512, 64] float32 (the
    # training shape's are bwd_kernel_phase's)
    bh, t, d, dtype, causal = cases[0]
    q, k, v = qkv(bh, t, d, dtype)
    ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
    plain_ms = cuda_ms(lambda: fa.reference_attention(q, k, v,
                                                      causal=causal))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=causal))
    bound_ms, bound_by = attention_bound_ms("flash_attention_fwd", bh, t,
                                            d, causal, 4)
    flops = attention_flops("flash_attention_fwd", bh, t, d, causal)
    core_ms = cuda_core_bound_ms("flash_attention_fwd", bh, t, d, causal)
    phase("kernel_time", kernel="flash_attention_fwd",
          shape=f"[{bh},{t},{d}] float32", ms=f"{ms:.4f}",
          tflops=f"{flops / ms / 1e9:.1f}", plain_ms=f"{plain_ms:.4f}",
          library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
          bound_by=bound_by, cuda_core_bound_ms=f"{core_ms:.4f}")
    return train_errs


def _rel_err(got, want):
    """max|got - want| / max(1, max|want|), max|got - want|, and the share
    of elements where got and want differ at all."""
    delta = (got.float() - want.float()).abs()
    diff = delta.max().item()
    return (diff / max(1.0, want.float().abs().max().item()), diff,
            (delta > 0).float().mean().item())


def _path_key(torch, bh, t, d, dtype, causal):
    """The training path whose attention shape a kernel case is (the key
    of its records), or None: bf16 BERT, float32 BERT, bf16 GPT at its
    ragged causal T, bf16 NMT's encoder (nmt) and decoder (nmt_causal)
    self-attention, or bf16 BERT-large (bert_large)."""
    return {(*TRAIN_SHAPE, torch.bfloat16, False): "bfloat16",
            (*BERT_LARGE_SHAPE, torch.bfloat16, False): "bert_large",
            (*F32_TRAIN_SHAPE, torch.float32, False): "float32",
            (*GPT_SHAPE, torch.bfloat16, True): "bfloat16_causal",
            (*NMT_SHAPE, torch.bfloat16, False): "nmt",
            (*NMT_SHAPE, torch.bfloat16, True): "nmt_causal"}.get(
                (bh, t, d, dtype, causal))


def _inputs(torch, fa, gen, bh, t, d, dtype, causal):
    """Seeded q, k, v, dO on the card with the plain forward's LSE and
    delta = rowsum(dO * O): a backward kernel's arguments."""
    q, k, v, do = [torch.randn((bh, t, d), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4)]
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, lse, delta


def time_kernels(torch, fa, gen, shape, dtype, names, causal=False,
                 errs=None):
    """[kernel_time] lines at `shape` in `dtype` and mask: each kernel
    in `names` (wrappers of the module `fa`) beside its plain version and
    SDPA with the same mask (the forward, or its backward: one call for
    dq, dk and dv); float32 lines also print the CUDA-core bound beside
    the 3xTF32 one. With both backward kernels, one more line times
    FlashAttentionFunction's whole backward (delta = rowsum(dO O), dq,
    dk/dv: the work of SDPA's one backward call) beside SDPA's backward
    and the two kernels' sum. Returns a record per kernel, with its error
    from `errs` (by _path_key) where the shape is a training path's."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16 = torch.bfloat16
    errs = errs or {}
    bh, t, d = shape
    args = _inputs(torch, fa, gen, bh, t, d, dtype, causal)
    q, k, v, do = args[:4]
    calls = {
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(*args, causal=causal),
            lambda: fa.flash_attention_bwd_dq_reference(
                *args, causal=causal)),
        "flash_attention_bwd_dkv": (
            lambda: fa.flash_attention_bwd_dkv(*args, causal=causal),
            lambda: fa.flash_attention_bwd_dkv_reference(
                *args, causal=causal)),
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, causal=causal),
            lambda: fa.flash_attention_fwd_reference(q, k, v,
                                                     causal=causal)),
    }
    times = {n: (cuda_ms(calls[n][0]), cuda_ms(calls[n][1]))
             for n in names}
    # yardsticks in the [b, h, T, d] layout SDPA's flash backend takes
    shape4 = (bh // H, H, t, d) if bh % H == 0 else (1, bh, t, d)
    q4, k4, v4 = (x.view(shape4).detach().requires_grad_() for x in
                  (q, k, v))
    library = {}
    if set(names) & set(BWD_KERNELS):
        out4 = sdpa(q4, k4, v4, is_causal=causal)
        library = dict.fromkeys(BWD_KERNELS, cuda_ms(
            lambda: torch.autograd.grad(out4, (q4, k4, v4),
                                        do.view(shape4),
                                        retain_graph=True)))
    if "flash_attention_fwd" in names:
        with torch.no_grad():
            library["flash_attention_fwd"] = cuda_ms(
                lambda: sdpa(q4, k4, v4, is_causal=causal))
    if set(BWD_KERNELS) <= set(names):
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        out = fa.FlashAttentionFunction.apply(qg, kg, vg, causal,
                                              1.0 / math.sqrt(d))
        whole_ms = cuda_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), do, retain_graph=True))
        phase("kernel_time", kernel="FlashAttentionFunction.backward",
              shape=f"[{bh},{t},{d}] {str(dtype)[6:]}"
              f"{' causal' if causal else ''}", ms=f"{whole_ms:.4f}",
              dq_plus_dkv_ms=f"{sum(times[n][0] for n in BWD_KERNELS):.4f}",
              library_ms=f"{library[BWD_KERNELS[0]]:.4f}")
    records = {}
    elsize = torch.finfo(dtype).bits // 8
    for name, (ms, plain_ms) in times.items():
        bound_ms, bound_by = attention_bound_ms(name, bh, t, d, causal,
                                                elsize)
        flops = attention_flops(name, bh, t, d, causal)
        core = {} if dtype == bf16 else {"cuda_core_bound_ms": (
            f"{cuda_core_bound_ms(name, bh, t, d, causal):.4f}")}
        phase("kernel_time", kernel=name,
              shape=f"[{bh},{t},{d}] {str(dtype)[6:]}"
              f"{' causal' if causal else ''}", ms=f"{ms:.4f}",
              tflops=f"{flops / ms / 1e9:.1f}",
              plain_ms=f"{plain_ms:.4f}",
              library_ms=f"{library[name]:.4f}",
              bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, **core)
        records[name] = {
            "shape": f"[{bh},{t},{d}]{' causal' if causal else ''}",
            "ms": ms, "plain_ms": plain_ms, "library_ms": library[name],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": errs.get(_path_key(
                torch, bh, t, d, dtype, causal), {}).get(name)}
    return records


def bwd_kernel_phase(torch):
    """Each backward kernel against its plain version on the card, then
    times at the training shape [384, 512, 64] bfloat16: the two
    backward kernels, their plain versions and the backward of
    scaled_dot_product_attention (one call for dq, dk and dv; a
    yardstick the port never calls), and the forward kernel, its plain
    version and SDPA's forward in bfloat16; then the two backward
    kernels in float32 beside float32 SDPA's backward, at the same shape
    and at the float32 training path's [192, 512, 64], where the float32
    forward is timed too; then all three bf16 kernels at GPT's causal
    [384, 511, 64] beside causal SDPA, and at [24, 512, 128] in both
    masks, at NMT's [512, 256, 64] in both, and at BERT-large's
    [256, 512, 64]. Returns the records per training path (_path_key):
    bfloat16 and float32 BERT, bfloat16_causal GPT, nmt and nmt_causal,
    bert_large."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)

    bf16, f32 = torch.bfloat16, torch.float32
    ragged = [(bh, t, d, bf16, c) for bh, t, d, c in RAGGED_BF16] + \
        [(bh, t, d, f32, c) for bh, t, d, c in RAGGED_F32]
    # (bh, T, d, dtype, causal): the training shapes in both dtypes and
    # causal, GPT's ragged causal shape, NMT's in both masks, a ragged T
    # in both masks, T=1024 causal, d=128 in both masks, d=32 and bh=12
    # (one sequence's heads), in each dtype
    cases = [(*TRAIN_SHAPE, bf16, False), (*TRAIN_SHAPE, f32, False),
             (*TRAIN_SHAPE, bf16, True), (96, 300, HD, f32, True),
             (96, 300, HD, bf16, False), (96, 300, HD, bf16, True),
             (12, 1024, HD, bf16, True), (24, T, 128, f32, False),
             (24, T, 128, bf16, False), (24, T, 128, bf16, True),
             (48, T, 32, f32, True), (48, T, 32, bf16, False),
             (12, T, HD, bf16, False), (96, 300, HD, f32, False),
             (12, 1024, HD, f32, True), (24, T, 128, f32, True),
             (12, T, HD, f32, False), (*F32_TRAIN_SHAPE, f32, False),
             (*GPT_SHAPE, bf16, True), (*NMT_SHAPE, bf16, False),
             (*NMT_SHAPE, bf16, True), (*BERT_LARGE_SHAPE, bf16, False),
             *ragged]
    # each path's shape: max|kernel - plain| per kernel, by _path_key
    errs = {}
    for bh, t, d, dtype, causal in cases:
        args = _inputs(torch, fa, gen, bh, t, d, dtype, causal)
        dq = fa.flash_attention_bwd_dq(*args, causal=causal)
        dk, dv = fa.flash_attention_bwd_dkv(*args, causal=causal)
        rq = fa.flash_attention_bwd_dq_reference(*args, causal=causal)
        rk, rv = fa.flash_attention_bwd_dkv_reference(*args, causal=causal)
        torch.cuda.synchronize()
        got = {"dq": _rel_err(dq, rq), "dk": _rel_err(dk, rk),
               "dv": _rel_err(dv, rv)}
        # float32: max|kernel - plain|; bfloat16: over max(1, max|plain|)
        tol, at = (F32_TOL, 1) if dtype == f32 else (BF16_BWD_TOL, 0)
        phase("kernel_bwd", case=f"bh{bh}_T{t}_d{d}_{str(dtype)[6:]}"
              f"{'_causal' if causal else ''}",
              **{f"{n}_err": f"{e[at]:.3e}" for n, e in got.items()},
              **{f"{n}_diff_share": f"{e[2]:.3e}" for n, e in got.items()},
              tol=tol)
        check(all(math.isfinite(e[at]) and e[at] <= tol
                  for e in got.values()),
              f"a backward kernel disagrees with its plain version: "
              f"{ {n: e[at] for n, e in got.items()} } > {tol}")
        if dtype == bf16:
            check(all(e[2] <= BF16_BWD_DIFF_SHARE for e in got.values()),
                  f"a bfloat16 backward kernel differs from its plain "
                  f"version in more than {BF16_BWD_DIFF_SHARE} of the "
                  f"elements: { {n: e[2] for n, e in got.items()} }")
        key = _path_key(torch, bh, t, d, dtype, causal)
        if key:
            errs[key] = {"flash_attention_bwd_dq": got["dq"][1],
                         "flash_attention_bwd_dkv": max(got["dk"][1],
                                                        got["dv"][1])}

    def timed(shape, dtype, names, causal=False):
        return time_kernels(torch, fa, gen, shape, dtype, names, causal,
                            errs)

    records = {"bfloat16": timed(TRAIN_SHAPE, bf16, ALL3)}
    # the float32 backward at the bf16 shape (the earlier PRs' yardstick
    # shape), then all three float32 kernels at the float32 training path's
    timed(TRAIN_SHAPE, f32, BWD_KERNELS)
    records["float32"] = timed(F32_TRAIN_SHAPE, f32, ALL3)
    records["bfloat16_causal"] = timed(GPT_SHAPE, bf16, ALL3, causal=True)
    # NMT's self-attention: the encoder's unmasked, the decoder's causal
    records["nmt"] = timed(NMT_SHAPE, bf16, ALL3)
    records["nmt_causal"] = timed(NMT_SHAPE, bf16, ALL3, causal=True)
    records["bert_large"] = timed(BERT_LARGE_SHAPE, bf16, ALL3)
    # d 128 in both masks (the bf16 kernels' widest instance)
    for causal in (False, True):
        timed(D128_SHAPE, bf16, ALL3, causal=causal)
    return records


def serve_phase(torch, card, model_dir):
    """[serve], [serve_hooks] and [bucket] over BERT-base saved into
    `model_dir` (kept for [http_serve]). Returns the flash launches of
    the serving run, its requests and answers, and its requests/s and
    latency percentiles."""
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
    _zero_launch_counts()
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
    p50, p99 = _percentiles(lat)
    direct = {"req_per_s": N_REQUESTS / wall, "p50_ms": p50 * 1e3,
              "p99_ms": p99 * 1e3}
    phase("serve", requests=N_REQUESTS, rows=sum(r.shape[0] for r in reqs),
          batches=batches, launches=launches,
          misses_after_warmup=misses - warm["misses"],
          req_per_s=f"{N_REQUESTS / wall:.3f}",
          p50_ms=f"{lat[len(lat) // 2] * 1e3:.2f}",
          max_ms=f"{lat[-1] * 1e3:.2f}", cpu_max_abs_err=f"{cpu_err:.3e}",
          card=f"'{card}'")
    serve_hooks_phase(card, model_dir, reqs, answers, cfg.n_layers,
                      N_REQUESTS / wall)
    bucket_phase(torch, card, cfg, engine.predictor, exe, scope,
                 main.clone(for_test=True), hidden.name, rng)
    return {"flash_attention_fwd": launches}, reqs, answers, direct


# what the JAX package's serving engine, batcher and executor record for
# one serving run with the monitor, tracing and goodput on
# (tests/test_torch_serving.py holds these names to the JAX engine's),
# and the device-memory gauges the executor samples on a card
SERVE_STATS = {
    "counters": (
        "serving.requests", "serving.batches", "serving.warmup_shapes",
        "executor.compile_cache_hit", "executor.compile_cache_miss",
        "executor.feed_bytes", "executor.feed_host_bytes",
        "exec.feed_presharded", "executor.flight_records",
        "trace.spans_started", "trace.spans_kept",
        "goodput.serving_busy_seconds", "goodput.serving_idle_seconds"),
    "gauges": (
        "serving.queue_depth", "executor.compile_cache_size",
        "executor.compile_cache_capacity", "trace.ring_spans",
        "goodput.wall_seconds", "goodput.fraction",
        "goodput.device_compute_seconds", "goodput.fetch_sync_seconds"),
    "histograms": (
        "serving.e2e_ms", "serving.queue_wait_ms", "serving.batch_size",
        "serving.pad_waste_frac", "serving.warmup_seconds",
        "executor.step_seconds", "executor.fetch_block_seconds",
        "executor.compile_first_step_seconds",
        "executor.compile_build_seconds", "executor.feed_stage_seconds"),
}
MEMORY_GAUGES = ("memory.device_bytes_in_use", "memory.device_peak_bytes",
                 "memory.device_bytes_limit")

def _hooks(on):
    """The monitor, every trace and goodput on (or back to off), with
    the registries emptied."""
    from paddle_tpu_torch import goodput, monitor, trace
    from paddle_tpu_torch.core.flags import set_flags
    set_flags({"FLAGS_enable_monitor": on, "FLAGS_enable_trace": on,
               "FLAGS_trace_sample": 1.0 if on else 0.05,
               "FLAGS_enable_goodput": on})
    monitor.reset_stats()
    trace.reset()
    goodput.reset()


def _missing_stats(snap, want):
    return [n for kind, names in want.items() for n in names
            if n not in snap[kind]]


def serve_hooks_phase(card, model_dir, reqs, answers, n_layers,
                      req_per_s_off):
    """The serving run again, on a new engine over the same saved model
    with the monitor, tracing (every trace kept) and goodput on from its
    warmup: the same answers, no cache entry after warmup, each kernel
    launch counted, and the hooks' output gated: the stats in
    SERVE_STATS and the device-memory gauges are recorded, each
    request's span tree is serving.request -> queue and execute, each
    batch span has the executor's feed, dispatch and fetch children, and
    the goodput ledger's categories sum to its wall clock. Prints
    requests/s with the hooks off (the run before) and on; the host
    clock varies too much between calls for a gate on the two. Then
    HOOK_PAIRS alternating passes with the hooks off and on, on one
    engine, give each setting's median requests/s and range."""
    import statistics

    import numpy as np
    from paddle_tpu_torch import goodput, monitor, trace
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine

    _hooks(True)
    try:
        goodput.start_run("serve")
        engine = ServingEngine(EngineConfig(max_batch_size=MAX_BATCH),
                               predictor=create_paddle_predictor(
                                   AnalysisConfig(model_dir)))
        engine.start()
        warm = engine.cache_stats()["misses"]
        _zero_launch_counts()
        batches0 = engine.batches
        got, wall = _serve_pass(engine, reqs)
        launches = flash_attention.launches
        batches = engine.batches - batches0
        misses = engine.cache_stats()["misses"]
        health = engine.health()
        engine.stop()
        snap = goodput.end_run()
        stats = monitor.get_stats_snapshot()
        spans = trace.drain_spans()
    finally:
        _hooks(False)
    # batches may form differently between the two runs
    err = max(float(np.abs(a - b).max()) for a, b in zip(got, answers))
    check(err <= 2e-3, f"hooked answers differ from the run without hooks "
          f"by {err}")
    check(misses == warm, f"executor cache misses moved after warmup: "
          f"{warm} -> {misses}")
    check(batches > 0 and launches == n_layers * batches,
          f"flash_attention_fwd launches {launches} != {n_layers} x "
          f"{batches} batches")
    check(health["state"] == "ready" and health["breaker"] == "closed",
          f"engine health {health}")
    missing = _missing_stats(stats, SERVE_STATS) + \
        [n for n in MEMORY_GAUGES if n not in stats["gauges"]]
    check(not missing, f"stats not recorded: {missing}")
    by_id = {sp["span_id"]: sp for sp in spans}
    kids = {}
    for sp in spans:
        parent = by_id.get(sp["parent_id"])
        if parent is not None:
            kids.setdefault(parent["span_id"], set()).add(sp["name"])
    roots = [sp for sp in spans if sp["name"] == "serving.request"]
    bspans = [sp for sp in spans if sp["name"] == "serving.batch"]
    check(len(roots) == len(reqs) and all(
        kids.get(r["span_id"]) == {"queue", "execute"} for r in roots),
        f"request span trees: {len(roots)} of {len(reqs)} requests with "
        f"children {[sorted(kids.get(r['span_id'], ())) for r in roots]}")
    want = {"executor.feed", "executor.dispatch", "executor.fetch"}
    check(len(bspans) == batches and all(
        kids.get(b["span_id"]) == want for b in bspans),
        f"batch span trees: {len(bspans)} spans for {batches} batches")
    check(goodput.check_invariant(snap),
          f"goodput categories do not sum to the wall clock: {snap}")
    off, on = _hooks_cost(model_dir, reqs)
    h = stats["histograms"]
    phase("serve_hooks", requests=len(reqs), batches=batches,
          launches=launches, misses_after_warmup=misses - warm,
          req_per_s_hooks_off=f"{req_per_s_off:.3f}",
          req_per_s_hooks_on=f"{len(reqs) / wall:.3f}",
          pairs=HOOK_PAIRS,
          req_per_s_off_median=statistics.median(off),
          req_per_s_off_range=f"{min(off)}-{max(off)}",
          req_per_s_on_median=statistics.median(on),
          req_per_s_on_range=f"{min(on)}-{max(on)}",
          e2e_p50_ms=f"{h['serving.e2e_ms']['p50']:.2f}",
          spans=len(spans), goodput_wall_s=snap["wall_s"],
          goodput_sum_frac_err=snap["sum_frac_err"],
          device_bytes_in_use=stats["gauges"].get(MEMORY_GAUGES[0]),
          card=f"'{card}'")


def _serve_pass(engine, reqs):
    """Send `reqs` to `engine` from N_THREADS threads, each waiting for
    its answer before it sends its next request. Returns the answers and
    the wall time; raises the first request's failure."""
    got, errors = [None] * len(reqs), []

    def client(idx):
        for i in idx:
            try:
                got[i] = engine.predict({"tokens": reqs[i]},
                                        timeout_ms=60000)[0]
            except Exception as e:  # recorded and re-raised below
                errors.append(e)
                return

    threads = [threading.Thread(target=client,
                                args=(range(j, len(reqs), N_THREADS),))
               for j in range(N_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    wall = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads),
          "a client thread did not finish")
    if errors:
        raise errors[0]
    return got, wall


def _hooks_cost(model_dir, reqs):
    """Requests/s of HOOK_PAIRS alternating passes of `reqs` on one
    engine over the saved model, the hooks off then on in each pair,
    after one untimed pass: ([off req/s], [on req/s])."""
    from paddle_tpu_torch import goodput
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine

    engine = ServingEngine(EngineConfig(max_batch_size=MAX_BATCH),
                           predictor=create_paddle_predictor(
                               AnalysisConfig(model_dir)))
    engine.start()
    rates = {False: [], True: []}
    try:
        _serve_pass(engine, reqs)  # untimed: the engine's first batches
        for _ in range(HOOK_PAIRS):
            for on in (False, True):
                _hooks(on)
                if on:
                    goodput.start_run("serve")
                rates[on].append(round(len(reqs) / _serve_pass(engine,
                                                               reqs)[1], 3))
    finally:
        _hooks(False)
        engine.stop()
    return rates[False], rates[True]


def _model_flops(cfg, batch):
    """A forward's operations: 2 per multiply-add of every product,
    attention included."""
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.d_model // cfg.n_heads
    linear = cfg.n_layers * (4 * d * d + 2 * d * f)
    attn = cfg.n_layers * 4 * batch * cfg.n_heads * T * T * dh
    return 2.0 * batch * T * linear + attn


# the tensor-core kernels the bf16 training step must run, the one the
# float32 serving forward must run, and the three the float32 training
# step must run
BF16_KERNEL_SYMBOLS = ("fwd_kernel_wgmma", "dq_kernel_wgmma",
                       "dkv_kernel_wgmma")
F32_FWD_SYMBOL = "fwd_kernel_tf32wg"
F32_KERNEL_SYMBOLS = (F32_FWD_SYMBOL, "dq_kernel_tf32wg", "dkv_kernel_tf32wg")


def _symbol_launches(per_name, pattern):
    """Launches of the kernels whose profiler name matches `pattern` (a
    regular expression; a symbol matches itself)."""
    import re
    return sum(n for (_, name), (_, n) in per_name.items()
               if re.search(pattern, name))


def _print_flash_symbols(per_name):
    """The flash kernels' symbols from device_kernels's table: which
    design ran, and how often."""
    from paddle_tpu_torch.profiler import KERNEL_CLASSES
    for (cls, name), (ms, n) in sorted(per_name.items()):
        if cls in KERNEL_CLASSES.values():
            print(f"  flash: {n} launches  {ms:.3f} ms  {name[:100]}",
                  flush=True)


def _device_ms_by_class(per_name, classes):
    """Device milliseconds per kernel class from device_kernels's table,
    and the unlinked launches' milliseconds; a class not in `classes`
    (unlinked too) counts as other."""
    by_class = dict.fromkeys(classes, 0.0)
    unlinked = 0.0
    for (cls, _), (ms, _) in per_name.items():
        by_class[cls if cls in by_class else "other"] += ms
        unlinked += ms if cls == "unlinked" else 0.0
    return by_class, unlinked


def bucket_phase(torch, card, cfg, predictor, exe, scope, prog, fetch, rng):
    """Per ladder bucket: the predictor's run (feed copy, forward, fetch
    to numpy; median of ITERS on the host clock) and the forward alone
    (tensors in and out on the card; CUDA events). At batch 8,
    torch.profiler over ITERS forwards: device time by kernel class and
    the device's busy share of the traced wall time."""
    import statistics
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.profiler import device_kernels

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
    per_name = device_kernels(prof)
    by_class, unlinked = _device_ms_by_class(
        per_name, ("flash_attention_fwd", "matmul", "other"))
    busy = sum(by_class.values())
    # no device time recorded means the profiler could not trace the card
    phase("profile", batch=MAX_BATCH, forwards=iters,
          wall_ms=f"{wall_ms:.3f}",
          busy_share=f"{busy / wall_ms:.4f}" if busy else "not measured",
          **{f"{k}_ms_per_forward": f"{v / iters:.3f}"
             for k, v in by_class.items()},
          unlinked_ms_per_forward=f"{unlinked / iters:.3f}",
          card=f"'{card}'")
    _print_flash_symbols(per_name)
    if busy:
        # the float32 forward runs the 3xTF32 kernel, never the scalar one
        n = _symbol_launches(per_name, F32_FWD_SYMBOL)
        check(n == cfg.n_layers * iters, f"{F32_FWD_SYMBOL} ran {n} times "
              f"in {iters} profiled forwards, not {cfg.n_layers * iters}")
        # the scalar kernel's name, demangled or mangled
        n = _symbol_launches(per_name, r"fwd_kernel[<I]")
        check(n == 0, f"the scalar fwd_kernel ran {n} times")


# the training runs, by amp: (batch, warm-up steps, timed steps, the
# kernels the profiled step must run, phase tag). bf16 AMP at bench.py's
# default BERT-base step; float32 at batch 16, as float32 activations
# take twice AMP's memory
TRAIN_RUNS = {True: (32, 3, 10, BF16_KERNEL_SYMBOLS, "train"),
              False: (16, 2, 5, F32_KERNEL_SYMBOLS, "train_f32")}
BWD_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
FWD = ("flash_attention_fwd",)
ALL3 = (*BWD_KERNELS, *FWD)
D128_SHAPE = (24, T, 128)
F32_D128_SHAPE = (48, T, 128)


def model_flops_per_token(cfg, seq_len):
    """Matmul operations per token, forward and backward (3x forward):
    dense 6*N_mat + attention 12*L*T*d, the LM head at every position
    (bench.py's count for the full-T objective)."""
    d, n_layers = cfg.d_model, cfg.n_layers
    n_mat = (n_layers * (4 * d * d + 2 * d * cfg.d_ff)
             + cfg.vocab_size * d)
    return 6 * n_mat + 12 * n_layers * seq_len * d


def _launch_counts():
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    return {"flash_attention_fwd": fa.flash_attention.launches,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq.launches,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv.launches}


def _zero_launch_counts():
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    for fn in (fa.flash_attention, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv):
        fn.launches = 0


def _build_train(ptt, transformer, cfg, batch, amp):
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss, _ = transformer.build_train(cfg, batch, T, lr=1e-4, amp=amp)
    return main, startup, loss


def train_phase(torch, card, amp=True):
    """BERT-base training at full width through the port's entry points:
    build_train (bf16 AMP or float32, AdamW at lr 1e-4, dropout 0.1), the
    startup program on the card, then TRAIN_RUNS[amp]'s warm-up and
    timed steps on seeded random tokens with labels = tokens (run_steps).
    Returns (the timed steps' launches, {ops, host_ms, device_ms}).
    MFU is against the peak of the units the step's products run on: the
    bf16 tensor cores under AMP, the CUDA cores' float32 peak in float32
    (cuBLAS takes full float32 products: allow_tf32 stays False)."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer

    batch, warmup, steps, symbols, tag = TRAIN_RUNS[amp]
    cfg = transformer.bert_base(dropout=0.1, attn_dropout=0.0,
                                use_flash=True)
    t0 = time.perf_counter()
    main, startup, loss = _build_train(ptt, transformer, cfg, batch, amp)
    scope = ptt.Scope()
    exe = ptt.Executor()  # the card
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    phase(f"{tag}_build", layers=cfg.n_layers, d_model=cfg.d_model,
          heads=cfg.n_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
          batch=batch, T=T, amp=amp, ops=len(main.global_block().ops),
          seconds=f"{time.perf_counter() - t0:.2f}")
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (batch, T)).astype("int64")
    run = run_steps(torch, card, tag, exe, main, scope,
                    {"tokens": toks, "labels": toks}, loss, cfg.n_layers,
                    warmup, steps, symbols, batch * T,
                    model_flops_per_token(cfg, T),
                    BF16_FLOPS if amp else F32_FLOPS,
                    parts=_step_parts(main) if amp else None)
    return run.launches, {"ops": len(main.global_block().ops),
                          "host_ms": run.host_ms,
                          "device_ms": run.device_ms,
                          "peak_gb": run.peak_gb}


class Run(NamedTuple):
    """What run_steps measured: the timed steps' launches, the profiled
    step's device ms, the median host ms to enqueue a timed step, and
    per step (warm-up, timed, profiled) the values of `fetch`, and the
    timed steps' peak memory in GB; the losses of the warm-up and timed
    steps, the profiled step's device ms outside every op scope (the
    feed's copies), and each step's own peak memory in GB (warm-up,
    timed, profiled)."""
    launches: dict
    device_ms: float
    host_ms: float
    fetched: list
    peak_gb: float
    losses: list
    outside_ms: float
    peaks: list


def planned_plan(main, feed, fetch, layout=None):
    """The static memory planner's plan for the program the executor runs
    for `main` at `feed` (the optimized one, at the feed's shapes, per
    rank under `layout`): memo hits of the gates the run passed. Its
    `device_peak_bytes` is what the gate prices."""
    from paddle_tpu_torch import Executor
    from paddle_tpu_torch.analysis import memory_gate, optimize_gate
    fetch = [getattr(v, "name", v) for v in fetch]
    # as Executor.run sees it: ragged feeds padded, lengths added
    feed, _ = Executor._expand_lod_feeds(main, feed)
    sig = Executor.feed_signature(main.global_block(), feed)
    prog, _ = optimize_gate(main, feed_names=sig.keys(), fetch_names=fetch)
    return memory_gate(prog, feed_shapes=sig, fetch_names=fetch,
                       layout=layout)


# The planner's device peak against the program's measured peak
# (plan_gate): at least the measured peak (the gate never admits what
# the card cannot hold) and at most PLAN_EXCESS x measured plus the GEMM
# workspaces it charges (fixed bytes, which a 52 MB program like LeNet's
# cannot amortize). The card run read planned less workspaces at
# 1.0135-1.0779 of measured over every line (PERF.md §6, run 21Z): 1.15
# sits above that and below a charge of the autograd records counted
# twice (1.205 on BERT's line).
PLAN_EXCESS = 1.15


def scope_device_bytes(torch, scope):
    """Bytes of the scope's tensors on the card (each storage once)."""
    seen, total = set(), 0
    for v in scope._vars.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            st = v.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
    return total


def plan_gate(tag, plan, measured_gb, foreign_gb, card):
    """The [tag] line: the planner's device peak, its parts and the
    program's measured peak (torch.cuda.max_memory_allocated less what
    other code held on the card when the step began, `foreign_gb`);
    fails unless measured <= planned <= PLAN_EXCESS x measured + the
    planned GEMM workspaces."""
    est = plan.device_peak_bytes / 1e9
    ws = plan.device_charges.get("workspaces", 0) / 1e9
    ratio = est / measured_gb if measured_gb > 0 else float("inf")
    excess = (est - ws) / measured_gb if measured_gb > 0 \
        else float("inf")
    ceiling = PLAN_EXCESS * measured_gb + ws
    phase(tag, est_peak_gb=f"{est:.3f}",
          plan_peak_gb=f"{plan.peak_bytes / 1e9:.3f}",
          **{f"{k}_gb": f"{v / 1e9:.3f}"
             for k, v in plan.device_charges.items()},
          measured_peak_gb=f"{measured_gb:.3f}",
          foreign_gb=f"{foreign_gb:.3f}",
          est_over_measured=f"{ratio:.4f}",
          est_less_workspaces_over_measured=f"{excess:.4f}",
          bar=f"1.0-{PLAN_EXCESS}xmeasured+workspaces",
          ceiling_gb=f"{ceiling:.3f}", card=f"'{card}'")
    check(1.0 <= ratio and est <= ceiling,
          f"[{tag}] planner peak {est:.3f} GB outside [{measured_gb:.3f}, "
          f"{ceiling:.3f}] (measured, {PLAN_EXCESS} x measured + "
          f"workspaces)")
    return ratio


def run_steps(torch, card, tag, exe, main, scope, feed, loss, n_layers,
              warmup, steps, symbols, tokens_per_step, flops_per_token,
              peak, unit="tokens", must_fall=True,
              classes=("matmul", "flash_attention_fwd", *BWD_KERNELS,
                       "other"), fetch=(), parts=None, plan_tag=None):
    """A training run's warm-up and timed steps: losses finite (and
    falling, with `must_fall`), each flash kernel launched `n_layers`
    times a timed step (every count set to 0 just before the timed steps
    and read just after; 0 for a model without attention), no executor
    cache miss after the first step; the [tag] line (median step time,
    host enqueue, `unit`s (tokens or images) a second, model TFLOP/s and
    MFU against `peak`, peak memory). Then one step under
    torch.profiler, split by kernel class (`classes`): each of `symbols`
    must run `n_layers` times, and no other flash kernel. With `parts`
    ({name: op indices}, _step_parts), the [tag_parts] line splits the
    profiled step's device ms, and the host ms of the ops' scopes (their
    enqueue, under the profiler), by those parts of the program. Each step also fetches the vars of `fetch` (as
    float64 numpy). `feed` is a feed dict, or a function that returns
    each step's feed (a DataLoader's next batch), called before the
    step's clock starts. `plan_tag` names the [tag_plan] line
    otherwise. Returns a Run."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.profiler import KERNEL_CLASSES, device_kernels

    next_feed = feed if callable(feed) else lambda: feed

    def step():
        """One step: (loss, host ms to enqueue it, ms until the loss is on
        the host). exe.run returns the loss tensor before the card is
        done; reading it waits for the card."""
        step_feed = next_feed()
        last_feed[0] = step_feed
        torch.cuda.synchronize()
        foreign = torch.cuda.memory_allocated() - \
            scope_device_bytes(torch, scope)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = exe.run(main, feed=step_feed, fetch_list=[loss, *fetch],
                      scope=scope, return_numpy=False)
        t_host = time.perf_counter()
        value = float(out[0])
        t_end = time.perf_counter()
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        program_peaks.append(
            ((torch.cuda.max_memory_allocated() - foreign) / 1e9,
             foreign / 1e9))
        fetched.append([x.double().cpu().numpy() for x in out[1:]])
        return value, (t_host - t0) * 1e3, (t_end - t0) * 1e3

    fetched, peaks, program_peaks, last_feed = [], [], [], [None]

    losses = [step()[0]]
    misses_after_first = exe.cache_stats()["misses"]
    losses += [step()[0] for _ in range(warmup - 1)]
    # the training path's run: every count to 0 just before, read after
    _zero_launch_counts()
    host_times, times = [], []
    for _ in range(steps):
        value, host_ms, step_ms = step()
        losses.append(value)
        host_times.append(host_ms)
        times.append(step_ms)
    launches = _launch_counts()
    peak_gb = max(peaks[warmup:])
    misses = exe.cache_stats()["misses"]

    check(all(math.isfinite(x) for x in losses),
          f"non-finite training loss: {losses}")
    check(not must_fall or losses[-1] < losses[0],
          f"loss did not fall: {losses[0]} -> {losses[-1]}")
    for name, n in launches.items():
        check(n == n_layers * steps,
              f"{name} launches {n} != {n_layers} x {steps} steps")
    check(misses == misses_after_first,
          f"executor cache misses after the first step: "
          f"{misses_after_first} -> {misses}")

    step_ms = statistics.median(times)
    host_ms = statistics.median(host_times)
    tok_s = tokens_per_step / (step_ms / 1e3)
    phase(tag, steps=steps, step_ms_median=f"{step_ms:.3f}",
          step_ms_min=f"{min(times):.3f}", step_ms_max=f"{max(times):.3f}",
          host_ms_median=f"{host_ms:.3f}",
          **{f"{unit}_per_step": tokens_per_step,
             f"{unit}_per_s": f"{tok_s:.1f}",
             f"model_mflop_per_{unit[:-1]}": f"{flops_per_token / 1e6:.2f}"},
          model_tflops=f"{flops_per_token * tok_s / 1e12:.2f}",
          mfu=f"{flops_per_token * tok_s / peak:.4f}",
          loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}",
          launches_per_step=launches["flash_attention_fwd"] // steps,
          losses=",".join(f"{x:.4f}" for x in losses),
          peak_mem_gb=f"{peak_gb:.2f}", card=f"'{card}'")
    prog_gb, foreign_gb = max(program_peaks[warmup:])
    plan_gate(plan_tag or f"{tag}_plan",
              planned_plan(main, last_feed[0], [loss, *fetch]),
              prog_gb, foreign_gb, card)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name = device_kernels(prof)
    by_class, unlinked = _device_ms_by_class(per_name, classes)
    busy = sum(by_class.values())
    phase(f"{tag}_profile", steps=1, wall_ms=f"{wall_ms:.3f}",
          busy_share=f"{busy / wall_ms:.4f}" if busy else "not measured",
          **{f"{k}_ms": f"{v:.3f}" for k, v in by_class.items()},
          unlinked_ms=f"{unlinked:.3f}", device_ms=f"{busy:.3f}",
          card=f"'{card}'")
    _print_flash_symbols(per_name)
    from paddle_tpu_torch.profiler import extract_op_scope, summarize_profile
    table = summarize_profile(prof).get("by_framework_op", {})
    # device ms outside every op scope: the feed's copies to the card
    outside_ms = busy - sum(row["device_us"] for key, row in table.items()
                            if key != "(unattributed)") / 1e3
    if parts:
        by_part = dict.fromkeys(parts, 0.0)
        host = dict.fromkeys(parts, 0.0)
        for row in table.values():
            for name, ids in parts.items():
                if row["op"] in ids:
                    by_part[name] += row["device_us"] / 1e3
        # each op scope's host interval on the executor's thread: the
        # op's enqueue, under the profiler's own cost
        for ev in prof.events():
            scope = extract_op_scope(ev.name)
            if scope is None or ev.name != "%s:%d/%d" % scope or \
                    not str(ev.device_type).endswith("CPU"):
                continue
            for name, ids in parts.items():
                if scope[2] in ids:
                    host[name] += (ev.time_range.end -
                                   ev.time_range.start) / 1e3
        phase(f"{tag}_parts", **{f"{k}_ops": len(v) for k, v in
                                 parts.items()},
              **{f"{k}_ms": f"{v:.3f}" for k, v in by_part.items()},
              outside_ops_ms=f"{outside_ms:.3f}",
              **{f"{k}_host_ms": f"{v:.3f}" for k, v in host.items()})
    if busy:
        for sym in symbols:
            n = _symbol_launches(per_name, sym)
            check(n == n_layers, f"{sym} ran {n} times in the profiled "
                  f"step, not {n_layers}")
        # no other flash kernel (another design, or a scalar one) ran
        n = sum(n for (cls, _), (_, n) in per_name.items()
                if cls in KERNEL_CLASSES.values())
        check(n == len(symbols) * n_layers,
              f"{n} flash kernel launches in the profiled step, not "
              f"{len(symbols)} x {n_layers} of {symbols}")
    for cls, n in (("conv", 4), ("norm", 4), ("matmul", 4), ("other", 8),
                   ("unlinked", 4)):
        top = sorted(((ms, k, name) for (c, name), (ms, k) in
                      per_name.items() if c == cls), reverse=True)
        for ms, k, name in top[:n]:
            print(f"  {cls}: {ms:.3f} ms  {k} launches  {name[:100]}",
                  flush=True)
    return Run(launches, busy, host_ms, fetched, peak_gb, losses,
               outside_ms, peaks)


COMPILED_LEVELS = (0, 1, 2)
COMPILED_STEPS = 3


def _reset_gate_memos():
    """Every gate memo of the port emptied, so the next gates run fresh."""
    from paddle_tpu_torch.analysis import memory, passes, verifier
    verifier.reset_memo()
    memory.reset_memo()
    passes.reset_memo()


def time_executor_gates():
    """Count the host seconds of every Executor.run's gates from here on
    (Executor._gates wrapped): returns [seconds, calls], updated in
    place."""
    from paddle_tpu_torch.executor import Executor
    total = [0.0, 0]
    gates = Executor._gates

    def timed(cls, *args, **kw):
        t0 = time.perf_counter()
        try:
            return gates(*args, **kw)
        finally:
            total[0] += time.perf_counter() - t0
            total[1] += 1

    Executor._gates = classmethod(timed)
    return total


def timed_gates(main, feed, fetch):
    """The executor's three gates on `main` at `feed`, each timed on its
    first (unmemoized) run: ({gate: host seconds}, optimize report,
    memory plan). The executor's own gates then hit these memos."""
    from paddle_tpu_torch import Executor
    from paddle_tpu_torch.analysis import (memory_gate, optimize_gate,
                                           verify_gate)
    _reset_gate_memos()
    sig = Executor.feed_signature(main.global_block(), feed)
    secs = {}
    t0 = time.perf_counter()
    verify_gate(main, feed_names=sig.keys(), fetch_names=fetch)
    secs["verify"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prog, report = optimize_gate(main, feed_names=sig.keys(),
                                 fetch_names=fetch)
    secs["optimize"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = memory_gate(prog, feed_shapes=sig, fetch_names=fetch)
    secs["memory"] = time.perf_counter() - t0
    return secs, report, plan


def compiled_train_phase(torch, card):
    """[compiled_train]: [train]'s BERT-base step (b32, T512, bf16 AMP,
    AdamW, dropout 0.1) run as a Fluid script runs it, through
    CompiledProgram(main).with_data_parallel(loss_name=loss.name), at
    FLAGS_graph_opt_level 0, 1 and 2: COMPILED_STEPS steps at each level
    from one startup state copied into a fresh scope, under torch's
    deterministic algorithms. Gates: the losses and the final parameters
    and optimizer state at levels 1 and 2 equal level 0's (max |diff| 0;
    where a second level-0 run differs from the first, their gap is the
    bar); each flash kernel launches 12 times a step at every level; no
    executor cache miss after the first step. Prints per level
    ([compiled_train_level]): the op counts before and after each pass,
    the fused groups, renamed vars, sunk updates and the donation plan's
    size; the planner's peak estimate beside the run's measured peak
    (torch.cuda.max_memory_allocated() over what was allocated before
    its scope) and their ratio; each gate's
    first-run host seconds; the median host ms to enqueue a step and
    one profiled step's device ms. Returns the launches of every level's
    steps."""
    import statistics

    import numpy as np
    import paddle_tpu_torch as ptt
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.profiler import device_kernels

    batch = TRAIN_RUNS[True][0]
    cfg = transformer.bert_base(dropout=0.1, attn_dropout=0.0,
                                use_flash=True)
    main, startup, loss = _build_train(ptt, transformer, cfg, batch, True)
    scope = ptt.Scope()
    ptt.Executor().run(startup, scope=scope)
    init = {n: scope.get(n).clone() for n in scope.names()}
    del scope
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (batch, T)).astype("int64")
    feed = {"tokens": toks, "labels": toks}
    fetch = [loss.name]

    def run(level, profiled, base=None):
        """COMPILED_STEPS steps at `level` from the startup state: (losses,
        final state (with `base`, level 0's: its largest gap to it
        instead), launches, host ms a step, the run's peak bytes over
        what was allocated before its scope, misses after each step,
        gate seconds, optimize report, memory plan, device ms of one
        profiled step after them)."""
        prev = ptt.get_flags(["FLAGS_graph_opt_level"])
        ptt.set_flags({"FLAGS_graph_opt_level": level})
        try:
            secs, report, plan = timed_gates(main, feed, fetch)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base_bytes = torch.cuda.memory_allocated()
            sc = ptt.Scope()
            for n, t in init.items():
                sc.set(n, t.clone())
            exe = ptt.Executor()
            compiled = ptt.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name)
            losses, host, misses = [], [], []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_launch_counts()
            for _ in range(COMPILED_STEPS):
                t0 = time.perf_counter()
                out = exe.run(compiled, feed=feed, fetch_list=fetch,
                              scope=sc, return_numpy=False)
                host.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(out[0]))
                misses.append(exe.cache_stats()["misses"])
            launches = _launch_counts()
            peak = torch.cuda.max_memory_allocated() - base_bytes
            state = {n: sc.get(n).clone() for n in init}
            if base is not None:
                state = gap(base, state)
            device_ms = None
            if profiled:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    exe.run(compiled, feed=feed, fetch_list=fetch,
                            scope=ptt.Scope(sc))
                    torch.cuda.synchronize()
                device_ms = sum(ms for ms, _ in
                                device_kernels(prof).values())
            return (losses, state, launches, statistics.median(host), peak,
                    misses, secs, report, plan, device_ms)
        finally:
            ptt.set_flags(prev)

    def gap(a, b):
        return max(float((x.double() - y.double()).abs().max())
                   if x.is_floating_point() else
                   float((x != y).sum()) for x, y in
                   ((a[n], b[n]) for n in a))

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    t_phase = time.perf_counter()
    try:
        runs = {0: run(0, profiled=True)}
        base = runs[0]
        for level in COMPILED_LEVELS[1:]:
            runs[level] = run(level, profiled=True, base=base[1])
        gaps = {level: max(max(abs(a - b) for a, b in
                               zip(base[0], runs[level][0])),
                           runs[level][1])
                for level in COMPILED_LEVELS[1:]}
        bar = 0.0
        if any(gaps.values()):
            again = run(0, profiled=False, base=base[1])
            bar = max(max(abs(a - b) for a, b in zip(base[0], again[0])),
                      again[1])
            del again
    finally:
        torch.use_deterministic_algorithms(was)

    launches = dict.fromkeys(runs[0][2], 0)
    for level, (losses, _, lau, host_ms, peak, misses, secs, report,
                plan, device_ms) in runs.items():
        passes = (report or {}).get("passes", [])
        detail = {}
        for p in passes:
            detail[f"{p['name']}_ops"] = f"{p['ops_before']}->{p['ops_after']}"
            for k in ("removed", "folded", "deduped", "groups", "fused_ops",
                      "merged", "reused_vars", "sunk_updates",
                      "donated_vars", "donated_bytes"):
                if k in p:
                    detail[f"{p['name']}_{k}"] = p[k]
        ops = (report or {}).get("ops_after", len(main.global_block().ops))
        phase("compiled_train_level", level=level, ops=ops, **detail,
              **{f"{g}_gate_s": f"{v:.3f}" for g, v in secs.items()},
              est_peak_gb=f"{plan.peak_bytes / 1e9:.3f}",
              measured_peak_gb=f"{peak / 1e9:.3f}",
              est_over_measured=f"{plan.peak_bytes / peak:.4f}",
              host_ms_median=f"{host_ms:.3f}",
              device_ms=f"{device_ms:.3f}" if device_ms else "not measured",
              losses=",".join(f"{x:.6f}" for x in losses),
              card=f"'{card}'")
        for name, n in lau.items():
            launches[name] += n
            check(n == cfg.n_layers * COMPILED_STEPS,
                  f"[compiled_train] level {level}: {name} launches {n} "
                  f"!= {cfg.n_layers} x {COMPILED_STEPS}")
        check(misses[-1] == misses[0], f"[compiled_train] level {level}: "
              f"cache misses after the first step {misses}")
        check(all(math.isfinite(x) for x in losses),
              f"[compiled_train] level {level}: losses {losses}")
    phase("compiled_train", levels=",".join(map(str, COMPILED_LEVELS)),
          steps=COMPILED_STEPS,
          **{f"gap_level{lv}_vs_0": f"{g:.3e}" for lv, g in gaps.items()},
          level0_rerun_gap=f"{bar:.3e}", deterministic_algorithms=True,
          seconds=f"{time.perf_counter() - t_phase:.1f}", card=f"'{card}'")
    for level, g in gaps.items():
        check(g <= bar, f"[compiled_train] level {level} differs from level "
              f"0 by {g} (two level-0 runs by {bar})")
    return launches


def serve_gates_phase(torch, card, model_dir, reqs, answers):
    """[serve_gates]: the BERT-base model [serve] saved, served by a new
    ServingEngine with FLAGS_program_verify=error and the monitor on, its
    gate memos empty. Gates: warmup ran one verify, one optimize and one
    memory plan per ladder cell (the analysis.* stats), no cache miss
    after warmup, [serve]'s requests answered within SERVE_GATE_TOL of
    [serve]'s answers (the batches coalesce otherwise), and
    fwd_kernel_tf32wg's wrapper launched 12 times a batch. Then two
    refusals, each before anything runs: with FLAGS_memory_budget_bytes at
    half the planner's estimate for the largest cell, a new engine's
    warmup raises PTV050; under error mode, a copy of the program with
    one op reading an undeclared var raises PTV010 in Executor.run. After
    each, cache_stats()["misses"] and torch.cuda.memory_allocated() are
    unchanged. Returns the flash forward's launches."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.analysis import (ProgramVerificationError,
                                           analyze_program_memory,
                                           optimize_gate)
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine

    def engine():
        return ServingEngine(EngineConfig(max_batch_size=MAX_BATCH),
                             predictor=create_paddle_predictor(
                                 AnalysisConfig(model_dir)))

    prev = ptt.get_flags(["FLAGS_program_verify", "FLAGS_enable_monitor",
                          "FLAGS_memory_budget_bytes"])
    ptt.set_flags({"FLAGS_program_verify": "error",
                   "FLAGS_enable_monitor": True})
    monitor.reset_stats()
    _reset_gate_memos()
    try:
        eng = engine()
        t0 = time.perf_counter()
        eng.start()
        warm_s = time.perf_counter() - t0
        cells = len(eng.warmup_shapes())
        counters = monitor.get_stats_snapshot()["counters"]
        stats = {k: counters.get(k, 0) for k in (
            "analysis.programs_verified", "analysis.pass_programs_optimized",
            "analysis.mem_plans")}
        warm = eng.cache_stats()["misses"]
        _zero_launch_counts()
        batches0 = eng.batches
        got = [eng.predict({"tokens": r}, timeout_ms=60000)[0]
               for r in reqs]
        launches = flash_attention.launches
        batches = eng.batches - batches0
        misses = eng.cache_stats()["misses"]
        pred = eng.predictor
        eng.stop()
        err = max(float(np.abs(a - b).max()) for a, b in zip(got, answers))

        # refusal 1: a budget of half the largest cell's estimate
        prog = pred.program()
        fetches = pred.get_output_names()
        opt, _ = optimize_gate(prog, feed_names=["tokens"],
                               fetch_names=fetches)
        est = analyze_program_memory(
            opt, ["tokens"], fetches,
            {"tokens": ((MAX_BATCH, T), "int32")}).peak_bytes
        big = engine()
        misses0 = big.predictor._exe.cache_stats()["misses"]
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        ptt.set_flags({"FLAGS_memory_budget_bytes": est // 2})
        refused = None
        try:
            big.warmup()
        except ProgramVerificationError as e:
            refused = str(e)
        ptt.set_flags({"FLAGS_memory_budget_bytes":
                       prev["FLAGS_memory_budget_bytes"]})
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        misses1 = big.predictor._exe.cache_stats()["misses"]

        # refusal 2: an op reading an undeclared var, in Executor.run
        bad = prog.clone()
        op = next(o for o in bad.global_block().ops if "X" in o.inputs)
        op.inputs["X"] = ["undeclared_var"]
        exe = pred._exe
        misses2 = exe.cache_stats()["misses"]
        torch.cuda.synchronize()
        mem2 = torch.cuda.memory_allocated()
        refused2 = None
        try:
            exe.run(bad, feed={"tokens": reqs[0]}, fetch_list=fetches,
                    scope=pred._scope)
        except ProgramVerificationError as e:
            refused2 = str(e)
        torch.cuda.synchronize()
        mem3 = torch.cuda.memory_allocated()
        misses3 = exe.cache_stats()["misses"]
    finally:
        ptt.set_flags(prev)
        monitor.reset_stats()

    phase("serve_gates", cells=cells, warmup_s=f"{warm_s:.2f}",
          programs_verified=stats["analysis.programs_verified"],
          programs_optimized=stats["analysis.pass_programs_optimized"],
          mem_plans=stats["analysis.mem_plans"],
          misses_after_warmup=misses - warm, batches=batches,
          launches=launches, max_abs_diff_vs_serve=f"{err:.3e}",
          est_peak_gb_largest_cell=f"{est / 1e9:.3f}",
          budget_refusal="PTV050" in (refused or ""),
          budget_refusal_misses=misses1 - misses0,
          budget_refusal_alloc_bytes=mem1 - mem0,
          verify_refusal="PTV010" in (refused2 or ""),
          verify_refusal_misses=misses3 - misses2,
          verify_refusal_alloc_bytes=mem3 - mem2, card=f"'{card}'")
    check(stats == {"analysis.programs_verified": 1,
                    "analysis.pass_programs_optimized": 1,
                    "analysis.mem_plans": cells},
          f"[serve_gates] warmup gate runs {stats}, not 1 verify, 1 "
          f"optimize and {cells} memory plans")
    check(misses == warm, f"[serve_gates] cache misses after warmup: "
          f"{warm} -> {misses}")
    check(err <= SERVE_GATE_TOL, f"[serve_gates] answers differ from "
          f"[serve]'s by {err}")
    check(batches > 0 and launches == 12 * batches,
          f"[serve_gates] flash forward launches {launches} != 12 x "
          f"{batches} batches")
    check(refused is not None and "PTV050" in refused,
          f"[serve_gates] warmup under half the estimate did not refuse "
          f"with PTV050: {refused}")
    check(misses1 == misses0 and mem1 == mem0,
          f"[serve_gates] the PTV050 refusal moved misses {misses0} -> "
          f"{misses1} or allocated bytes {mem0} -> {mem1}")
    check(refused2 is not None and "PTV010" in refused2,
          f"[serve_gates] the undeclared read did not refuse with PTV010: "
          f"{refused2}")
    check(misses3 == misses2 and mem3 == mem2,
          f"[serve_gates] the PTV010 refusal moved misses {misses2} -> "
          f"{misses3} or allocated bytes {mem2} -> {mem3}")
    return launches


def train_cpu_check(torch):
    """The same full-width model at batch 1 with dropout 0 (the card's and
    the CPU's generators draw different masks), in float32 and in bf16
    AMP: one step on the card and one on the CPU through the plain
    versions, each from the same startup values. Float32: the loss within
    rtol 1e-4 and three parameters' gradients within rtol 1e-3, atol 1e-6.
    AMP: the loss within AMP_LOSS_RTOL and each gradient's Frobenius gap
    within AMP_GRAD_RTOL of its norm; beside it, the same readings of the
    card's AMP step against the CPU's float32 step (what an AMP step that
    silently ran in float32 would be near: bf16 rounding noise of the
    same size), and flash attention's outputs must be bfloat16 under AMP
    and float32 without. Returns the float32 card step's launches."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer

    cfg = transformer.bert_base(dropout=0.0, attn_dropout=0.0,
                                use_flash=True)
    progs = {amp: _build_train(ptt, transformer, cfg, 1, amp)
             for amp in (False, True)}
    check(progs[False][1].fingerprint() == progs[True][1].fingerprint(),
          "the float32 and AMP startup programs differ")
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, T))
    grads = _check_grads(cfg)
    t0 = time.perf_counter()
    out, launches = _card_and_cpu(
        ptt, {amp: (main, loss) for amp, (main, _, loss) in progs.items()},
        progs[False][1], {"tokens": toks, "labels": toks}, grads,
        cfg.n_layers)

    card, cpu = out[False, "card"], out[False, "cpu"]
    errs = {}
    for name, a, b in zip(grads, card[1:], cpu[1:]):
        errs[name] = float(np.max(np.abs(a - b)))
        check(np.allclose(a, b, rtol=1e-3, atol=1e-6) and
              np.abs(b).max() > 0,
              f"{name}: card vs CPU differ by {errs[name]} "
              f"(max |CPU| {np.abs(b).max()})")
    f32_loss = _loss_rel(card, cpu)
    check(f32_loss <= 1e-4, f"card vs CPU loss differs by {f32_loss}")
    phase("train_cpu_check", batch=1, amp=False,
          loss_card=f"{float(card[0]):.6f}", loss_cpu=f"{float(cpu[0]):.6f}",
          loss_rel=f"{f32_loss:.3e}",
          launches_per_kernel=launches[False]["flash_attention_fwd"],
          **{f"{n.split('@')[0]}_max_abs_err": f"{e:.3e}"
             for n, e in errs.items()})
    _amp_check("train_cpu_check", out, grads, t0,
               vs_f32=out[False, "cpu"])
    return launches[False]


def _check_grads(cfg):
    """The gradients a card-vs-CPU step compares: the embedding, the
    first layer's query weight and the last layer's second FFN weight."""
    return ["word_emb@GRAD", "layer_0.att.q.w@GRAD",
            f"layer_{cfg.n_layers - 1}.ffn.fc2.w@GRAD"]


def _card_and_cpu(ptt, progs, startup, feed, grads, n_layers,
                  prepare=None, perturb=None):
    """One step of each program in `progs` ({amp: (main, loss)}) on the
    card and one on the CPU, each from the same startup values (the
    startup program run once on the card, then `prepare(values)` where
    given), fetching the loss and the vars named in `grads`. The outputs
    of flash attention and conv2d (the white-list ops that take the
    tensor cores) must be bfloat16 under AMP and float32 without, and
    each flash kernel must launch `n_layers` times on the card and never
    on the CPU. With `perturb` ((values, feed) -> (values, feed)), each
    AMP program also takes one card step from the perturbed values and
    feed: how far bf16 rounding alone moves the results. Returns ({(amp,
    "card" | "cpu" | "card_perturbed"): [loss, *grads] as float32 numpy},
    {amp: the card step's launches})."""
    from paddle_tpu_torch.convert import scope_from_numpy

    card_exe, cpu_exe = ptt.Executor(), ptt.Executor(ptt.CPUPlace())
    init_scope = ptt.Scope()
    card_exe.run(startup, scope=init_scope)
    init = {n: init_scope.get_numpy(n) for n in init_scope.names()}
    del init_scope
    if prepare is not None:
        init = prepare(init)
    out, launches = {}, {}
    for amp, (main, loss) in progs.items():
        if amp and perturb is not None:
            values, fd = perturb(init, feed)
            scope = scope_from_numpy(values, ptt.Scope(), ptt.CUDAPlace(0))
            got = card_exe.run(main, feed=fd, fetch_list=[loss] + grads,
                               scope=scope, return_numpy=False)
            out[amp, "card_perturbed"] = [x.float().cpu().numpy()
                                          for x in got]
            del scope, got, values
        # flash attention's and conv2d's outputs: bfloat16 under AMP,
        # float32 without
        attn = [op.output("Out" if op.type == "flash_attention" else
                          "Output")[0] for op in main.global_block().ops
                if op.type in ("flash_attention", "conv2d")]
        want = "torch.bfloat16" if amp else "torch.float32"
        for where, exe, place in (("card", card_exe, ptt.CUDAPlace(0)),
                                  ("cpu", cpu_exe, ptt.CPUPlace())):
            scope = scope_from_numpy(init, ptt.Scope(), place)
            _zero_launch_counts()
            got = exe.run(main, feed=feed, fetch_list=[loss] + grads + attn,
                          scope=scope, return_numpy=False)
            counts = _launch_counts()
            dtypes = {str(x.dtype) for x in got[1 + len(grads):]}
            check(dtypes == {want}, f"flash attention or conv2d ran in "
                  f"{dtypes} on the {where} with amp={amp}; want {want}")
            # each kernel once a layer on the card, none on the CPU
            n = n_layers if where == "card" else 0
            check(all(x == n for x in counts.values()),
                  f"kernel launches of the {where} step with amp={amp}: "
                  f"{counts}, not {n} each")
            if where == "card":
                launches[amp] = counts
            out[amp, where] = [x.float().cpu().numpy()
                               for x in got[:1 + len(grads)]]
            del scope, got
    return out, launches


def _loss_rel(a, b):
    return abs(float(a[0]) - float(b[0])) / abs(float(b[0]))


def _grad_rel(grads, a, b):
    """{name: ||x - y|| / ||y||} over the gradients after the loss; where
    y is exactly 0, 0 if x is too, else inf."""
    import numpy as np

    def rel(x, y):
        ny = np.linalg.norm(y)
        if ny == 0:
            return 0.0 if not np.any(x) else math.inf
        return float(np.linalg.norm(x - y) / ny)
    return {n.split("@")[0]: rel(x, y)
            for n, x, y in zip(grads, a[1:], b[1:])}


def _amp_check(tag, out, grads, t0, vs_f32=None, grad_tol=AMP_GRAD_RTOL):
    """The AMP step on the card against the one on the CPU: the loss
    within AMP_LOSS_RTOL, each gradient's Frobenius gap within `grad_tol`
    of its norm; with `vs_f32` (the CPU's float32 step), the same
    readings against it printed beside, and so for the card's perturbed
    AMP step against the card's where _card_and_cpu took one."""
    card, cpu = out[True, "card"], out[True, "cpu"]
    amp_loss, amp_grads = _loss_rel(card, cpu), _grad_rel(grads, card, cpu)
    beside = {}
    for key, other in (("vs_f32", vs_f32),
                       ("card_pert", out.get((True, "card_perturbed")))):
        if other is not None:
            beside.update({f"{key}_loss_rel": f"{_loss_rel(card, other):.3e}",
                           **{f"{key}_{n}_rel": f"{e:.3e}" for n, e in
                              _grad_rel(grads, card, other).items()}})
    phase(tag, batch=1, amp=True,
          loss_card=f"{float(card[0]):.6f}", loss_cpu=f"{float(cpu[0]):.6f}",
          loss_rel=f"{amp_loss:.3e}", loss_tol=AMP_LOSS_RTOL,
          **{f"{n}_rel": f"{e:.3e}" for n, e in amp_grads.items()},
          grad_tol=grad_tol, **beside,
          seconds=f"{time.perf_counter() - t0:.2f}")
    check(amp_loss <= AMP_LOSS_RTOL,
          f"AMP card vs CPU loss differs by {amp_loss} > {AMP_LOSS_RTOL}")
    check(all(e <= grad_tol for e in amp_grads.values()),
          f"AMP card vs CPU gradients differ: {amp_grads} > {grad_tol}")


# -- the training recipes ------------------------------------------------

# ImageNet-1k's 1,281,167 training images at batch 256: 5005 steps an
# epoch, as PaddlePaddle/models' image classification train.py counts
# them (step = ceil(total_images / batch_size))
IMAGENET_IMAGES = 1281167
RESNET_STEPS_PER_EPOCH = -(-IMAGENET_IMAGES // 256)
RECIPES = {
    # BERT pretraining (Devlin et al. 2019, Appendix A.2, and its
    # reference code's optimization.py): AdamW with weight decay 0.01
    # and epsilon 1e-6; 1e-4 warmed up linearly over 10k steps, then
    # decayed linearly to 0 at 1M; a global-norm clip of 1.0. The 13
    # steps read counters 9995-10007, across the end of warmup
    "bert": {"lr": 1e-4, "decay_steps": 1_000_000, "power": 1.0,
             "warmup": 10_000, "first_step": 9995},
    # NVIDIA DeepLearningExamples' BERT phase-1 LAMB recipe: 6e-3, a
    # polynomial decay of power 0.5 over 7038 steps, warmup 0.2843 of
    # them (2000); the steps cross step 2000
    "lamb": {"lr": 6e-3, "decay_steps": 7038, "power": 0.5,
             "warmup": 2000, "first_step": 1995},
    # PaddlePaddle/models' ResNet-50: Momentum 0.9, L2 decay 1e-4, 0.1
    # cut tenfold at epochs 30, 60 and 90; the 8 steps start 4 before
    # the first boundary and read it fifth (0.055, both sides' mean)
    "resnet": {"boundaries": [e * RESNET_STEPS_PER_EPOCH
                              for e in (30, 60, 90)],
               "values": [0.1, 0.01, 0.001, 0.0001],
               "first_step": 30 * RESNET_STEPS_PER_EPOCH - 4},
}
LR_RTOL = 1e-6
N_MASK = 80    # bench.py's MLM positions at T 512: 15%, up to a multiple of 8
# [recipe_cpu_check]: the card's float32 recipe steps against the CPU's.
# The loss and the global norm within RECIPE_RTOL, each clipped gradient's
# Frobenius gap within RECIPE_GRAD_RTOL of its norm ([train_cpu_check]'s
# float32 bar), and each parameter's update (after the steps, minus the
# start) within RECIPE_UPDATE_RTOL of the CPU's update, Frobenius, the
# attention key biases left out (their gradient is 0 but for rounding,
# so Adam's step there is the sign of rounding noise). On the CPU (tools/
# torch_rounding_sensitivity.py recipe: d 128, 2 layers, T 128, two
# AdamW steps of this recipe) the JAX package's own updates move by at
# most 1.0e-5, 2.8e-5 and 5.7e-5 when the word embedding moves by 1e-6,
# 1e-5 and 1e-4 of each value, and the port's part from the JAX
# package's by 1.5e-5; the bar is the gradient bar, 17 times the largest
RECIPE_RTOL = 1e-4
RECIPE_GRAD_RTOL = 1e-3
RECIPE_UPDATE_RTOL = 1e-3


def recipe_lr(recipe, step):
    """The recipe's rate at `step` in closed form (float64), as the
    port's schedules compute it: linear_lr_warmup and piecewise_decay
    select through sign masks, so at a step exactly on a boundary the
    rate is the mean of the two sides."""
    def above(x):  # sign(x) * 0.5 + 0.5
        return 0.5 * (x > 0) + 0.5 * (x >= 0)
    if "boundaries" in recipe:
        bounds = [0.0, *recipe["boundaries"], 1e30]
        return sum(v * above(step - bounds[i]) * above(bounds[i + 1] - step)
                   for i, v in enumerate(recipe["values"]))
    lr, warm = recipe["lr"], recipe["warmup"]
    frac = min(step, recipe["decay_steps"]) / recipe["decay_steps"]
    poly = lr * (1.0 - frac) ** recipe["power"]
    done = above(step / warm - 1.0)
    return min(max(step / warm, 0.0), 1.0) * lr * (1.0 - done) + poly * done


def _recipe_lr_var(ptt, recipe):
    """The recipe's schedule as the port's LR ops."""
    L = ptt.layers
    if "boundaries" in recipe:
        return L.piecewise_decay(recipe["boundaries"], recipe["values"])
    return L.linear_lr_warmup(
        L.polynomial_decay(recipe["lr"], decay_steps=recipe["decay_steps"],
                           end_learning_rate=0.0, power=recipe["power"]),
        warmup_steps=recipe["warmup"], start_lr=0.0, end_lr=recipe["lr"])


def _start_counter(torch, scope, step):
    """Set @STEP_COUNTER@ so that the next step reads `step`, as a run
    resumed from a checkpoint does."""
    c = scope.get("@STEP_COUNTER@")
    scope.set("@STEP_COUNTER@", torch.full_like(c, step - 1))


def _step_parts(main, lr=None):
    """A training program's op indices by part: "schedule" (the ops the
    LR var `lr` is computed from), "after_backward" (between the last
    grad op and the first update: the regularizers and the gradient
    clip, the loss scaling's unscale), "update" (from the first
    optimizer update op on) and "model" (the rest: forward, backward)."""
    from paddle_tpu_torch.core.registry import REGISTRY
    ops = main.global_block().ops
    last_grad = max(i for i, op in enumerate(ops)
                    if op.type == "grad::generic")
    first_update = min(i for i, op in enumerate(ops)
                       if REGISTRY.get(op.type).inplace)
    schedule, want = set(), {lr.name} if lr is not None else set()
    for i in range(len(ops) - 1, -1, -1):
        if want & set(ops[i].output_names()) and i < first_update:
            schedule.add(i)
            want |= {n for n in ops[i].input_names() if n}
    after = set(range(last_grad + 1, first_update)) - schedule
    update = set(range(first_update, len(ops)))
    model = set(range(len(ops))) - schedule - after - update
    return {"schedule": schedule, "after_backward": after,
            "update": update, "model": model}


def _build_bert_recipe(ptt, transformer, cfg, batch, amp, name):
    """BERT-base MLM pretraining as bench.py's build_bert_bench builds it
    with BENCH_MLM=1 (build_train_mlm, N_MASK positions a sequence),
    trained by RECIPES[name] ("bert": AdamW, "lamb": Lamb) with its
    schedule, built first (its ops come before the forward), and the
    global-norm clip of 1.0. The clip is process-global: it is set back
    to None however the build ends. Returns (main, startup, loss, the LR
    var, the global norm's var, {parameter: its clipped gradient's
    var})."""
    import functools
    opt = ptt.optimizer
    opt_cls = (functools.partial(opt.Lamb, lamb_weight_decay=0.01)
               if name == "lamb" else
               functools.partial(opt.AdamW, weight_decay=0.01, epsilon=1e-6))
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    ptt.clip.set_gradient_clip(ptt.clip.GradientClipByGlobalNorm(1.0))
    try:
        with ptt.program_guard(main, startup), ptt.unique_name.guard():
            lr = _recipe_lr_var(ptt, RECIPES[name])
            loss, _ = transformer.build_train_mlm(
                cfg, batch, T, N_MASK, lr=lr, optimizer_cls=opt_cls, amp=amp)
    finally:
        ptt.clip.set_gradient_clip(None)
    return (main, startup, loss, lr, *_clip_vars(main))


def _clip_vars(main):
    """GradientClipByGlobalNorm's norm (its sqrt op's output) and the
    clipped gradients ({parameter: the elementwise_mul output by the
    clip's factor})."""
    ops = main.global_block().ops
    at = max(i for i, op in enumerate(ops) if op.type == "sqrt")
    norm = ops[at].output("Out")[0]
    factor = next(op for op in ops[at:] if op.type == "elementwise_div")
    factor = factor.output("Out")[0]
    return norm, {op.input("X")[0].split("@GRAD")[0]: op.output("Out")[0]
                  for op in ops if op.type == "elementwise_mul" and
                  op.input("Y") == [factor]}


def _mlm_feed(cfg, batch, seed):
    """bench.py's MLM feed: tokens from RandomState(seed), N_MASK masked
    positions a sequence and their labels."""
    import numpy as np
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (batch, T)).astype(np.int64)
    pos = np.stack([rng.choice(T, N_MASK, replace=False) + i * T
                    for i in range(batch)]).reshape(-1).astype(np.int32)
    return {"tokens": toks, "mask_pos": pos,
            "mask_label": toks.reshape(-1)[pos].reshape(-1, 1)}


def _lr_gate(tag, recipe, lrs):
    """Each step's rate against recipe_lr from the recipe's first step;
    returns the largest relative gap."""
    want = [recipe_lr(recipe, recipe["first_step"] + i)
            for i in range(len(lrs))]
    errs = [abs(a - b) / abs(b) for a, b in zip(lrs, want)]
    check(max(errs) <= LR_RTOL, f"[{tag}] learning rates {lrs} differ "
          f"from the closed form {want} by up to {max(errs)} > {LR_RTOL}")
    return max(errs)


def bert_recipe_phase(torch, card, train, name="bert"):
    """[bert_recipe] (AdamW, RECIPES["bert"]) or [bert_lamb] (Lamb with
    weight decay 0.01, RECIPES["lamb"]): BERT-base MLM pretraining at
    bench.py's step (b32, T512, N_MASK, bf16 AMP, dropout 0.1) through
    _build_bert_recipe, the startup program on the card, the step
    counter set so that the steps read the recipe's first_step on, then
    3 warm-up and 10 timed steps through run_steps (its gates; losses
    need not fall at these rates), fetching the LR var and the global
    norm each step. Gates: each step's rate equals recipe_lr within
    LR_RTOL, the global norm finite and positive, three parameters
    moved. Prints the op count and host ms beside [train]'s (`train`).
    Returns the timed steps' launches."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer

    tag = "bert_recipe" if name == "bert" else "bert_lamb"
    recipe = RECIPES[name]
    batch = TRAIN_RUNS[True][0]
    cfg = transformer.bert_base(dropout=0.1, attn_dropout=0.0,
                                use_flash=True)
    t0 = time.perf_counter()
    main, startup, loss, lr, norm, clipped = _build_bert_recipe(
        ptt, transformer, cfg, batch, True, name)
    scope = ptt.Scope()
    exe = ptt.Executor()  # the card
    exe.run(startup, scope=scope)
    _start_counter(torch, scope, recipe["first_step"])
    watched = [g.split("@")[0] for g in _check_grads(cfg)]
    before = {n: scope.get(n).clone() for n in watched}
    torch.cuda.synchronize()
    ops = main.global_block().ops
    params = main.all_parameters()
    phase(f"{tag}_build", ops=len(ops), train_ops=train["ops"],
          squared_l2_norm=sum(op.type == "squared_l2_norm" for op in ops),
          clipped=len(clipped), params=len(params),
          param_elements=sum(math.prod(p.shape) for p in params),
          seconds=f"{time.perf_counter() - t0:.2f}")
    # the LM head runs at the N_MASK positions only
    flops_tok = model_flops_per_token(cfg, T) - \
        6 * cfg.vocab_size * cfg.d_model * (1 - N_MASK / T)
    run = run_steps(torch, card, tag, exe, main, scope,
                    _mlm_feed(cfg, batch, 0), loss, cfg.n_layers, 3, 10,
                    BF16_KERNEL_SYMBOLS, batch * T, flops_tok, BF16_FLOPS,
                    must_fall=False, fetch=[lr.name, norm],
                    parts=_step_parts(main, lr))
    lrs = [float(f[0][0]) for f in run.fetched]
    norms = [float(f[1][0]) for f in run.fetched]
    moved = [n for n in watched if not torch.equal(scope.get(n), before[n])]
    phase(f"{tag}_lr", first_step=recipe["first_step"],
          lr=",".join(f"{x:.7e}" for x in lrs),
          lr_max_rel_err=f"{_lr_gate(tag, recipe, lrs):.3e}",
          global_norm=",".join(f"{x:.4f}" for x in norms),
          ops=len(ops), train_ops=train["ops"],
          host_ms_median=f"{run.host_ms:.3f}",
          train_host_ms_median=f"{train['host_ms']:.3f}",
          device_ms=f"{run.device_ms:.3f}",
          train_device_ms=f"{train['device_ms']:.3f}", card=f"'{card}'")
    check(all(math.isfinite(x) and x > 0 for x in norms),
          f"[{tag}] global norms not finite and positive: {norms}")
    check(moved == watched, f"[{tag}] parameters that did not move: "
          f"{sorted(set(watched) - set(moved))}")
    return run.launches


def _recipe_steps(ptt, exe, place, main, init, feed, fetch, steps,
                  params):
    """`steps` steps of `main` on `place` from the values `init`:
    ([per step: fetched values as float64 numpy], {param: its update,
    after the steps minus `init`'s})."""
    from paddle_tpu_torch.convert import scope_from_numpy
    scope = scope_from_numpy(init, ptt.Scope(), place, program=main)
    out = [[x.double().cpu().numpy() for x in
            exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                    return_numpy=False)] for _ in range(steps)]
    return out, {p: scope.get_numpy(p) - init[p] for p in params}


def _fro(a, b):
    import numpy as np
    nb = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / nb if nb else \
        (0.0 if not np.any(a) else math.inf)


def recipe_cpu_check(torch):
    """[recipe_cpu_check]: BERT-base at full width, batch 1, dropout 0,
    float32, through the recipes with the global-norm clip: two AdamW
    steps of RECIPES["bert"] from counter 9999 (across the end of
    warmup) and one Lamb step of RECIPES["lamb"] at counter 2000 (at
    9999 its rate is exactly 0, past its 7038 decay steps), each on the
    card and on the CPU (plain versions) from the same startup values.
    Per step: the loss and the global norm within RECIPE_RTOL, the rate
    equal on both and to recipe_lr within LR_RTOL, each clipped gradient
    within RECIPE_GRAD_RTOL (Frobenius; the attention key biases', 0 but
    for rounding, printed apart); after the steps, each
    parameter's update within RECIPE_UPDATE_RTOL of the CPU's
    (Frobenius; the attention key biases printed apart). Beside it, the
    card's own update gap when the word embedding moves by 1e-6 of each
    value (card_pert). The card launches
    each float32 kernel 12 times a step. Returns the card's launches."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer

    cfg = transformer.bert_base(dropout=0.0, attn_dropout=0.0,
                                use_flash=True)
    feed = _mlm_feed(cfg, 1, 1)
    card_exe, cpu_exe = ptt.Executor(), ptt.Executor(ptt.CPUPlace())
    launches = {k: 0 for k in _launch_counts()}
    for name, steps, first in (("bert", 2, 9999), ("lamb", 1, 2000)):
        t0 = time.perf_counter()
        recipe = RECIPES[name]
        main, startup, loss, lr, norm, clipped = _build_bert_recipe(
            ptt, transformer, cfg, 1, False, name)
        params = sorted(p.name for p in main.all_parameters())
        scope = ptt.Scope()
        card_exe.run(startup, scope=scope)
        _start_counter(torch, scope, first)
        init = {n: scope.get_numpy(n) for n in scope.names()}
        del scope
        # the clipped gradients of the parameters held to the bar first;
        # the attention key biases' (0 but for rounding) last
        held = [p for p in params if not p.endswith(".k.b")]
        fetch = [loss.name, lr.name, norm,
                 *(clipped[p] for p in held + [p for p in params
                                              if p not in held])]
        _zero_launch_counts()
        card, d_card = _recipe_steps(ptt, card_exe, ptt.CUDAPlace(0), main,
                                     init, feed, fetch, steps, params)
        counts = _launch_counts()
        cpu, d_cpu = _recipe_steps(ptt, cpu_exe, ptt.CPUPlace(), main, init,
                                   feed, fetch, steps, params)
        noise = np.random.RandomState(5).randn(*init["word_emb"].shape)
        moved = {**init, "word_emb": (init["word_emb"] * (1 + 1e-6 * noise))
                 .astype(np.float32)}
        _, d_pert = _recipe_steps(ptt, card_exe, ptt.CUDAPlace(0), main,
                                  moved, feed, fetch[:1], steps, params)
        check(all(n == cfg.n_layers * steps for n in counts.values()),
              f"[recipe_cpu_check] card launches {counts}, not "
              f"{cfg.n_layers} x {steps} each")
        for k, n in counts.items():
            launches[k] += n
        loss_rel = max(abs(float(a[0]) - float(b[0])) / abs(float(b[0]))
                       for a, b in zip(card, cpu))
        norm_rel = max(abs(float(a[2][0]) - float(b[2][0])) / float(b[2][0])
                       for a, b in zip(card, cpu))
        lrs = [float(a[1][0]) for a in card]
        lr_gap = max(abs(float(a[1][0]) - float(b[1][0])) / float(b[1][0])
                     for a, b in zip(card, cpu))
        n = 3 + len(held)
        grad = max(_fro(x, y) for a, b in zip(card, cpu)
                   for x, y in zip(a[3:n], b[3:n]))
        upd = {p: _fro(d_card[p], d_cpu[p]) for p in held}
        pert = {p: _fro(d_pert[p], d_card[p]) for p in held}
        key_bias = max(_fro(d_card[p], d_cpu[p]) for p in params
                       if p not in held)
        key_bias_grad = max(_fro(x, y) for a, b in zip(card, cpu)
                            for x, y in zip(a[n:], b[n:]))
        worst = max(upd, key=upd.get)
        phase("recipe_cpu_check", recipe=name, steps=steps, first_step=first,
              loss_card=f"{float(card[-1][0]):.6f}",
              loss_cpu=f"{float(cpu[-1][0]):.6f}",
              loss_rel=f"{loss_rel:.3e}", lr=",".join(f"{x:.7e}"
                                                      for x in lrs),
              lr_card_vs_cpu=f"{lr_gap:.3e}",
              global_norm=",".join(f"{float(a[2][0]):.4f}" for a in card),
              global_norm_rel=f"{norm_rel:.3e}", clipped=len(clipped),
              clipped_grad_max_rel=f"{grad:.3e}",
              key_bias_clipped_grad_max_rel=f"{key_bias_grad:.3e}",
              update_gap_median=f"{np.median(list(upd.values())):.3e}",
              update_gap_max=f"{upd[worst]:.3e}", update_gap_worst=worst,
              key_bias_update_gap_max=f"{key_bias:.3e}",
              card_pert_update_gap_median=(
                  f"{np.median(list(pert.values())):.3e}"),
              card_pert_update_gap_max=f"{max(pert.values()):.3e}",
              bars=f"loss:{RECIPE_RTOL},lr:{LR_RTOL},grad:"
                   f"{RECIPE_GRAD_RTOL},update:{RECIPE_UPDATE_RTOL}",
              seconds=f"{time.perf_counter() - t0:.2f}")
        recipe = dict(recipe, first_step=first)
        _lr_gate("recipe_cpu_check", recipe, lrs)
        check(lr_gap <= LR_RTOL, f"[recipe_cpu_check] {name}: card and CPU "
              f"rates differ by {lr_gap}")
        check(loss_rel <= RECIPE_RTOL, f"[recipe_cpu_check] {name}: loss "
              f"differs by {loss_rel} > {RECIPE_RTOL}")
        check(norm_rel <= RECIPE_RTOL, f"[recipe_cpu_check] {name}: global "
              f"norm differs by {norm_rel} > {RECIPE_RTOL}")
        check(grad <= RECIPE_GRAD_RTOL, f"[recipe_cpu_check] {name}: "
              f"clipped gradients differ by {grad} > {RECIPE_GRAD_RTOL}")
        check(upd[worst] <= RECIPE_UPDATE_RTOL, f"[recipe_cpu_check] "
              f"{name}: {worst}'s update differs by {upd[worst]} > "
              f"{RECIPE_UPDATE_RTOL}")
        del card, cpu, d_card, d_cpu, d_pert, init, moved
    return launches


def _gpt_cfg(**kw):
    """GPT-small as bench.py's GPT step builds it."""
    from paddle_tpu_torch.models import gpt
    return gpt.gpt_small(attn_dropout=0.0, use_flash=True,
                         max_seq_len=GPT_SEQ, **kw)


def _build_gpt(ptt, cfg, batch, amp):
    from paddle_tpu_torch.models import gpt
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss, _, _ = gpt.build_train(cfg, batch, GPT_SEQ, lr=3e-4, amp=amp)
    return main, startup, loss


def gpt_train_phase(torch, card):
    """GPT-small training at full width through models/gpt.build_train,
    as bench.py's GPT step (batch 32, seq_len 512, bf16 AMP, AdamW lr
    3e-4, dropout 0.1, tokens from RandomState(0)): the startup program
    on the card, then 3 warm-up and 10 timed steps through run_steps.
    Attention runs causal at T 511 (the in-graph shift). Tokens a step
    are batch x 511; operations a token are bench.py's causal count,
    model_flops_per_token(cfg, 511) - 6 L 511 d. Returns (the timed
    steps' launches, the trained scope, the config)."""
    import numpy as np
    import paddle_tpu_torch as ptt

    cfg = _gpt_cfg(dropout=0.1)
    t0 = time.perf_counter()
    main, startup, loss = _build_gpt(ptt, cfg, GPT_BATCH, True)
    scope = ptt.Scope()
    exe = ptt.Executor()  # the card
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    phase("gpt_train_build", layers=cfg.n_layers, d_model=cfg.d_model,
          heads=cfg.n_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
          batch=GPT_BATCH, seq_len=GPT_SEQ, T=GPT_SEQ - 1, amp=True,
          ops=len(main.global_block().ops),
          seconds=f"{time.perf_counter() - t0:.2f}")
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ)).astype(np.int64)
    t = GPT_SEQ - 1
    flops_tok = model_flops_per_token(cfg, t) - 6 * cfg.n_layers * t * \
        cfg.d_model
    launches = run_steps(torch, card, "gpt_train", exe, main, scope,
                            {"tokens": toks}, loss, cfg.n_layers, 3, 10,
                            BF16_KERNEL_SYMBOLS, GPT_BATCH * t, flops_tok,
                            BF16_FLOPS).launches
    return launches, scope, cfg


def gpt_cpu_check(torch):
    """The same full-width GPT at batch 1, dropout 0, bf16 AMP: one step
    on the card and one on the CPU through the plain versions, from the
    same startup values, under train_cpu_check's AMP limits; attention
    must run in bfloat16 and each kernel once a layer on the card."""
    import numpy as np
    import paddle_tpu_torch as ptt

    cfg = _gpt_cfg(dropout=0.0)
    main, startup, loss = _build_gpt(ptt, cfg, 1, True)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, GPT_SEQ))
    grads = _check_grads(cfg)
    t0 = time.perf_counter()
    out, _ = _card_and_cpu(ptt, {True: (main, loss)}, startup,
                           {"tokens": toks}, grads, cfg.n_layers)
    _amp_check("gpt_cpu_check", out, grads, t0)


class _Recorder:
    """An executor seen through kv_generate: runs every call on `exe` and
    keeps each step's logits row (batch row 0, position 0) and its
    milliseconds on the host clock, fetch to the host included."""

    def __init__(self, exe):
        self.exe, self.place = exe, exe.place
        self.logits, self.ms = [], []

    def run(self, *args, **kw):
        t0 = time.perf_counter()
        out = self.exe.run(*args, **kw)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.logits.append(out[0][0, 0])
        return out


def engine_generate(engine, prompts, max_new_tokens, timeout_s=600.0):
    """Greedy generation of `prompts` by a started paged GenerationEngine,
    all submitted at once, its paged steps seen through: returns (the
    streams, per stream the decode step's logits row of each new token,
    {"prefill" | "decode": milliseconds of each step on the host clock,
    fetch to the host included, "chunks": per stream the prefill steps
    that held its tokens})."""
    from paddle_tpu_torch.serving import GenerationRequest

    rows, chunks, times = {}, {}, {"prefill": [], "decode": []}
    run = engine._run_paged

    def recorded(prog, step, tokens, table, start, nvalid):
        t0 = time.perf_counter()
        out = run(prog, step, tokens, table, start, nvalid)
        what = "decode" if prog is engine._prog else "prefill"
        times[what].append((time.perf_counter() - t0) * 1e3)
        for i, st in enumerate(engine._state):
            if st is None or not nvalid[i]:
                continue
            if what == "decode":
                rows.setdefault(id(st.req), []).append(out[i, 0])
            else:
                chunks[id(st.req)] = chunks.get(id(st.req), 0) + 1
        return out

    engine._run_paged = recorded
    try:
        reqs = [GenerationRequest(p, max_new_tokens,
                                  timeout_ms=timeout_s * 1e3)
                for p in prompts]
        pending = [engine.submit(r) for r in reqs]
        streams = [r.result()["tokens"] for r in pending]
    finally:
        del engine._run_paged
    times["chunks"] = [chunks.get(id(r), 0) for r in reqs]
    return streams, [rows.get(id(r), []) for r in reqs], times


def _build_decode(ptt, build, *args, **kw):
    """A decode program built in a Program pair of its own; its startup
    never runs (the trained scope holds the weights)."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        step = build(*args, **kw)
    return main, step


def gpt_generate_phase(torch, card, scope, cfg):
    """Generation from the trained GPT scope in float32 (the AMP step's
    weights are float32; the decode programs share their names): serial
    greedy kv_generate through the slab decode step (batch 1, max_seq
    GPT_SEQ) for each of GEN_PROMPT_LENS's seeded prompts and GEN_NEW new
    tokens, then the same prompts submitted at once to a paged
    GenerationEngine (one slot each, block GEN_BLOCK, chunked prefill),
    its steps seen through by engine_generate. Gates: equal streams, the
    engine's decode steps' logits within GEN_LOGIT_TOL of the slab's at
    every token (both condition on the same tokens), finite logits, and
    no flash kernel launched (counts set to 0 before the serial run,
    read after the engine's)."""
    import statistics

    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import GenerationEngine

    n_slots = len(GEN_PROMPT_LENS)
    slab_prog, slab = _build_decode(ptt, gpt.build_decode_step, cfg, 1,
                                    GPT_SEQ)
    rng = np.random.RandomState(SEED)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in GEN_PROMPT_LENS]
    exe = ptt.Executor()  # the card

    # the decode path's run: every count to 0 just before, read after
    _zero_launch_counts()
    serial, serial_logits, slab_ms = [], [], []
    t0 = time.perf_counter()
    for p in prompts:
        rec = _Recorder(exe)
        serial.append(gpt.kv_generate(rec, scope, slab_prog, *slab, p,
                                      GEN_NEW))
        serial_logits.append(rec.logits[-GEN_NEW:])
        slab_ms += rec.ms
    slab_s = time.perf_counter() - t0
    engine = GenerationEngine(cfg, scope, exe=exe, max_slots=n_slots,
                              max_seq=GPT_SEQ, paged=True,
                              block_size=GEN_BLOCK,
                              state_prefix="gen_check.")
    engine.start()
    try:
        t0 = time.perf_counter()
        paged, paged_logits, paged_ms = engine_generate(engine, prompts,
                                                        GEN_NEW)
        paged_s = time.perf_counter() - t0
    finally:
        engine.stop()
    launches = _launch_counts()

    same = [a == b for a, b in zip(serial, paged)]
    err = max((float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
               for s, p, ok in zip(serial_logits, paged_logits, same) if ok
               for a, b in zip(s, p)), default=math.inf)
    finite = all(np.isfinite(x).all() for rows in serial_logits +
                 paged_logits for x in rows)
    n_tok = n_slots * GEN_NEW
    phase("gpt_generate", prompts=n_slots,
          prompt_lens=",".join(map(str, GEN_PROMPT_LENS)),
          new_tokens=GEN_NEW, streams_equal=sum(same),
          max_logit_err=f"{err:.3e}", tol=GEN_LOGIT_TOL,
          slab_steps=len(slab_ms),
          slab_decode_ms_b1=f"{statistics.median(slab_ms):.3f}",
          slab_tokens_per_s=f"{n_tok / slab_s:.1f}",
          paged_decode_steps=len(paged_ms["decode"]),
          **{f"paged_decode_ms_b{n_slots}":
             f"{statistics.median(paged_ms['decode']):.3f}"},
          prefill_chunks=len(paged_ms["prefill"]),
          prefill_chunk_ms=f"{statistics.median(paged_ms['prefill']):.3f}",
          paged_tokens_per_s=f"{n_tok / paged_s:.1f}",
          flash_launches=sum(launches.values()), card=f"'{card}'")
    check(all(len(rows) == GEN_NEW for rows in paged_logits),
          f"the engine's decode steps: {[len(r) for r in paged_logits]} "
          f"logits rows, not {GEN_NEW} a stream")
    differ = [n for n, ok in zip(GEN_PROMPT_LENS, same) if not ok]
    check(not differ, f"paged streams differ from the serial slab streams "
          f"for the prompts of lengths {differ}")
    check(finite, "non-finite decode logits")
    check(err <= GEN_LOGIT_TOL, f"paged vs slab decode logits differ by "
          f"{err} > {GEN_LOGIT_TOL}")
    check(not any(launches.values()),
          f"the decode programs launched flash kernels: {launches}")
    return prompts, serial


# [gen_serve]: GenerationEngine over the trained GPT-small, 8 slots,
# paged KV in blocks of GEN_BLOCK, first without and then with
# speculative decoding (FLAGS_spec_decode_k drafts)
GEN_SLOTS = 8
GEN_PREFIX = 128                   # tokens shared by GEN_SUFFIX_LENS
GEN_SUFFIX_LENS = (8, 24, 40, 64)
GEN_SEGMENT = 16                   # a segment the repeat prompts repeat
GEN_REPEATS = (2, 3, 4, 5)
GEN_SAMPLED_LENS = (5, 40, 90, 150)
GEN_TEMPERATURE, GEN_TOP_K = 0.8, 40
GEN_MEMORY_SLACK = 64 << 20        # allocated bytes after a run vs warmup
# a fault run: transient faults at the engine's decode and prefill sites
# and at the executor, from a fixed seed, on GEN_FAULT_PROMPTS of the
# [gpt_generate] prompts
GEN_FAULT_SPEC = ("transient_fail:p=0.2:site=generation,"
                  "transient_fail:p=0.2:site=gen_prefill,"
                  "transient_fail:p=0.05:site=executor")
GEN_FAULT_SEED = 7
GEN_FAULT_PROMPTS = 4
# what the JAX package's generation engine records for this traffic
# (tests/test_torch_generation.py holds these names to the JAX
# engine's); GEN_SPEC_STATS only where a verify step ran
GEN_STATS = {
    "counters": ("serving.gen_requests", "serving.gen_steps",
                 "serving.gen_tokens", "serving.gen_chunked_prefills",
                 "serving.gen_prefix_hits", "serving.gen_prefix_misses"),
    "gauges": ("serving.gen_queue_depth", "serving.gen_active_slots",
               "serving.gen_kv_blocks_total", "serving.gen_kv_blocks_free"),
    "histograms": ("serving.gen_ttft_ms", "serving.gen_inter_token_ms",
                   "serving.gen_e2e_ms", "serving.gen_slot_occupancy"),
}
GEN_SPEC_STATS = {
    "counters": ("serving.gen_spec_steps", "serving.gen_spec_draft_proposed",
                 "serving.gen_spec_draft_accepted"),
    "gauges": ("serving.gen_spec_k_effective",),
    "histograms": ("serving.gen_spec_acceptance_rate",
                   "serving.gen_spec_tokens_per_step"),
}


def gen_requests(vocab, prompts):
    """[gen_serve]'s traffic: the [gpt_generate] prompts, greedy; prompts
    that share a GEN_PREFIX-token prefix (the first of them is sent
    first, so the others can find its blocks), greedy; prompts in which
    a GEN_SEGMENT-token segment repeats (the n-gram drafter's food),
    greedy; and sampled prompts (GEN_TEMPERATURE, GEN_TOP_K, a seed
    each). Returns [(prompt, {temperature, top_k, seed})], the shared
    prefix's first request first."""
    import numpy as np
    rng = np.random.RandomState(SEED + 1)
    prefix = rng.randint(0, vocab, GEN_PREFIX).tolist()
    shared = [prefix + rng.randint(0, vocab, n).tolist()
              for n in GEN_SUFFIX_LENS]
    seg = rng.randint(0, vocab, GEN_SEGMENT).tolist()
    repeat = [rng.randint(0, vocab, 8).tolist() + seg * r
              for r in GEN_REPEATS]
    sampled = [rng.randint(0, vocab, n).tolist() for n in GEN_SAMPLED_LENS]
    greedy = {"temperature": 0.0, "top_k": 0, "seed": 0}
    return ([(p, greedy) for p in shared + list(prompts) + repeat] +
            [(p, {"temperature": GEN_TEMPERATURE, "top_k": GEN_TOP_K,
                  "seed": 100 + i}) for i, p in enumerate(sampled)])


def _percentiles(xs):
    import numpy as np
    return tuple(float(np.percentile(xs, q)) for q in (50, 99)) if xs \
        else (math.nan, math.nan)


def gen_serve_run(ptt, eng, requests):
    """Start `eng`, send `requests` ([(prompt, sampling kwargs)]): the
    first alone until its first token, then the rest submitted at once
    from N_THREADS threads, none waiting for an answer before it sends
    its next request, so that more requests are live than the engine
    has slots; each token's time is recorded by its stream_cb. Stops
    the engine. Returns a dict of the streams, results, errors, token
    times, allocated bytes after warmup and after the run, the engine's
    program runs, and the wall time."""
    import torch
    from paddle_tpu_torch.serving import GenerationRequest

    eng.start()
    mem_warm = torch.cuda.memory_allocated()
    n = len(requests)
    results, errors, futures = [None] * n, [None] * n, [None] * n
    submitted, times = [0.0] * n, [[] for _ in range(n)]
    first_token = threading.Event()

    def send(i):
        prompt, kw = requests[i]

        def cb(tok, i=i):
            times[i].append(time.perf_counter())
            if i == 0:
                first_token.set()

        submitted[i] = time.perf_counter()
        try:
            futures[i] = eng.submit(GenerationRequest(
                prompt, GEN_NEW, timeout_ms=600000, stream_cb=cb, **kw))
        except Exception as e:  # reported by the caller's gates
            errors[i] = e
            first_token.set()

    t0 = time.perf_counter()
    send(0)
    first_token.wait(300)
    threads = [threading.Thread(
        target=lambda idx: [send(i) for i in idx],
        args=(range(1 + j, n, N_THREADS),)) for j in range(N_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    hung = any(th.is_alive() for th in threads)
    for i, fut in enumerate(futures):
        if fut is not None:
            try:
                results[i] = fut.result(timeout=600)
            except Exception as e:  # reported by the caller's gates
                errors[i] = e
    wall = time.perf_counter() - t0
    mem_run = torch.cuda.memory_allocated()
    runs = {name: eng.exe._step_counters.get(prog.fingerprint(), 0) - 1
            for name, prog in (("decode", eng._prog),
                               ("prefill", eng._prefill_prog),
                               ("verify", eng._spec_prog))
            if prog is not None}
    compiles = eng.post_warmup_compiles()
    eng.stop()
    ttft = [(ts[0] - t) * 1e3 for ts, t in zip(times, submitted) if ts]
    # requests live (submitted, last token not yet out) at each submission
    live = max(sum(1 for j in range(n) if submitted[j] <= t and times[j]
                   and times[j][-1] > t) for t in submitted)
    itl = [(b - a) * 1e3 for ts in times for a, b in zip(ts, ts[1:])]
    return {"streams": [r["tokens"] if r else None for r in results],
            "results": results, "errors": errors, "hung": hung,
            "ttft": _percentiles(ttft), "itl": _percentiles(itl),
            "tokens": sum(len(ts) for ts in times), "wall": wall,
            "live": live,
            "mem": (mem_warm, mem_run), "runs": runs,
            "compiles": compiles, "kv": eng.kv_block_stats(),
            "breaker": eng.breaker.state}


def _step_times(torch, eng):
    """Host and card milliseconds of one decode step, one prefill chunk
    and one verify step of `eng` (stopped) with all GEN_SLOTS rows live
    at position 200 (half of max_seq if that is less): host time around the executor's run with the fetch
    to numpy (median of 10); CUDA events around 10 runs with the fetch
    left on the card (mean); and the card's busy time a step from
    torch.profiler (its kernels' device time)."""
    import statistics

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.profiler import device_kernels
    from paddle_tpu_torch.serving import blocks_for_tokens

    B, bs = GEN_SLOTS, eng.block_size
    mb = eng.step.max_blocks_per_slot
    pos = min(200, eng.max_seq // 2)
    per_slot = blocks_for_tokens(pos + eng.spec_k + 1, bs)
    table = np.zeros((B, mb), np.int64)
    for i in range(B):
        table[i, :per_slot] = np.arange(1 + i * per_slot,
                                        1 + (i + 1) * per_slot)
    out = {}
    for what, prog, step, t, start in (
            ("decode", eng._prog, eng.step, 1, pos),
            ("prefill", eng._prefill_prog, eng.prefill_step, bs, pos - bs),
            ("verify", eng._spec_prog, eng.spec_step, eng.spec_k + 1, pos)):
        feed = {step.token_var.name: np.ones((B, t), np.int64),
                step.table_var.name: table,
                step.start_var.name: np.full(B, start, np.int64),
                step.nvalid_var.name: np.full(B, t, np.int64)}

        def run(numpy):
            return eng.exe.run(prog, feed=feed, fetch_list=[step.logits_var],
                               scope=eng.scope, return_numpy=numpy)

        host = []
        for _ in range(10):
            t0 = time.perf_counter()
            run(True)
            host.append((time.perf_counter() - t0) * 1e3)
        event = cuda_ms(lambda: run(False), iters=10, warmup=1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                run(False)
            torch.cuda.synchronize()
        busy = sum(ms for ms, _ in device_kernels(prof).values()) / 10
        out[what] = (statistics.median(host), event, busy)
    return out


# a spec-on sampled stream may part from its spec-off one where the two
# runs' logits rows, computed at other batch shapes (verify against
# decode), round apart and the draw lands between their CDFs: the rows
# must agree within the card-against-card bar
SPEC_FLIP_LOGIT_TOL = 1e-4


class DrawRecorder:
    """While entered, wraps models.sampling.sample_token (every decode,
    verify and serial path draws through it) and keeps each sampled draw
    (temperature > 0) under its rng: (the logits row, temperature,
    top_k, the uniform u that the draw reads, the token). An rng is told
    by its state at its first draw, a fresh RandomState(seed)'s."""

    def __enter__(self):
        import numpy as np
        from paddle_tpu_torch.models import sampling
        self._mod, orig = sampling, sampling.sample_token
        self._orig, self._by_rng = orig, {}

        def wrapped(step_logits, temperature=0.0, top_k=0, rng=None):
            if not (temperature and temperature > 0.0 and rng is not None):
                return orig(step_logits, temperature, top_k, rng)
            state = rng.get_state()
            replay = np.random.RandomState()
            replay.set_state(state)
            u = replay.random_sample()  # what rng.choice reads
            tok = orig(step_logits, temperature, top_k, rng)
            entry = self._by_rng.setdefault(id(rng), (rng, state, []))
            entry[2].append((np.array(step_logits, copy=True), temperature,
                             top_k, u, tok))
            return tok

        sampling.sample_token = wrapped
        return self

    def __exit__(self, *exc):
        self._mod.sample_token = self._orig

    def draws(self, seed):
        """The draws of the request whose rng was RandomState(seed)."""
        import numpy as np
        fresh = np.random.RandomState(seed).get_state()
        for _, state, draws in self._by_rng.values():
            if state[2:] == fresh[2:] and np.array_equal(state[1],
                                                         fresh[1]):
                return draws
        return []


def sample_cdf(row, temperature, top_k):
    """The CDF that sample_token's rng.choice searches for its draw,
    computed as sample_token and numpy's choice compute it."""
    import numpy as np
    logits = np.asarray(row)
    if top_k and 0 < int(top_k) < logits.shape[0]:
        keep = np.argpartition(-logits, int(top_k) - 1)[:int(top_k)]
        masked = np.full_like(logits, -np.inf)
        masked[keep] = logits[keep]
        logits = masked
    p = logits / temperature
    p = np.exp(p - p.max())
    p /= p.sum()
    cdf = np.cumsum(p.astype(np.float64))
    return cdf / cdf[-1]


def spec_flip_gate(off, on, draws_off, draws_on,
                   logit_tol=SPEC_FLIP_LOGIT_TOL):
    """One sampled request's spec-off and spec-on streams, with each
    run's draws (DrawRecorder.draws). Equal streams pass. At the first
    differing token both runs drew from their own logits row with the
    same uniform u (the prefixes agree, so the rng has made the same
    draws); the flip passes only when the rows agree within `logit_tol`
    and u lies between the two rows' CDFs at the boundary it crossed
    (the CDF entry of the lower of the two tokens): |u - CDF_off| <=
    |CDF_on - CDF_off| + 1e-6. A difference with no draw behind it, a
    draw that is not the stream's token, or two different u fail.
    Nothing after the flip is compared. Returns (ok, None or {index,
    why, margin, gap, logit_gap})."""
    import numpy as np
    k = next((j for j, (a, b) in enumerate(zip(off, on)) if a != b),
             None if len(off) == len(on) else min(len(off), len(on)))
    if k is None:
        return True, None
    info = {"index": k, "why": "", "margin": math.inf, "gap": 0.0,
            "logit_gap": math.inf}
    if k >= min(len(off), len(on), len(draws_off), len(draws_on)):
        return False, dict(info, why="no draw behind the difference")
    row_off, temp, top_k, u_off, tok_off = draws_off[k]
    row_on, _, _, u_on, tok_on = draws_on[k]
    if (tok_off, tok_on) != (off[k], on[k]) or u_off != u_on:
        return False, dict(info, why="the draws are not the streams'")
    j = min(tok_off, tok_on)
    cdf_off = sample_cdf(row_off, temp, top_k)
    cdf_on = sample_cdf(row_on, temp, top_k)
    info.update(margin=float(abs(u_off - cdf_off[j])),
                gap=float(abs(cdf_on[j] - cdf_off[j])),
                logit_gap=float(np.abs(np.asarray(row_off, np.float64)
                                       - np.asarray(row_on)).max()))
    ok = info["logit_gap"] <= logit_tol and \
        info["margin"] <= info["gap"] + 1e-6
    return ok, dict(info, why="" if ok else "not a rounding flip")


def gen_serve_phase(torch, card, scope, cfg, prompts, serial):
    """GenerationEngine serving the trained GPT-small (float32, the
    [gpt_generate] weights) on the card: 8 slots, max_seq GPT_SEQ, paged
    KV in blocks of GEN_BLOCK, the traffic of gen_requests with GEN_NEW
    tokens each, first with spec_decode off and then on (the default
    FLAGS_spec_decode_k), the monitor on. Gates: every request finishes;
    each greedy stream equals its serial slab kv_generate stream (the
    [gpt_generate] ones reused); each spec-on stream equals its spec-off
    stream, a sampled one up to a first flip that spec_flip_gate
    explains by rounding (the flips and their margins printed); a
    verify step ran; prefix-cache hits;
    no new executor cache entry after warmup in either engine; after
    stop no KV block held by a slot; no flash kernel launched; the
    breaker closed; more requests live at once than the engine has
    slots; the stats of GEN_STATS (and GEN_SPEC_STATS for the
    spec engine) recorded; allocated card memory after each run within
    GEN_MEMORY_SLACK of its value after warmup. Then a fault run
    (GEN_FAULT_SPEC, GEN_FAULT_SEED) must retry and give the same greedy
    streams. Prints TTFT, inter-token time and tokens/s, the step
    counts, the acceptance rate, the prefix-hit blocks and each step's
    host and card time."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.core.flags import FLAGS, set_flags
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.resilience import reset_injector
    from paddle_tpu_torch.serving import GenerationEngine

    requests = gen_requests(cfg.vocab_size, prompts)
    greedy = [i for i, (_, kw) in enumerate(requests)
              if kw["temperature"] == 0.0]
    # serial slab references: the [gpt_generate] streams, and the others
    # computed the same way
    want = dict(zip((tuple(p) for p in prompts), serial))
    slab_prog, slab = _build_decode(ptt, gpt.build_decode_step, cfg, 1,
                                    GPT_SEQ)
    exe = ptt.Executor()  # the card
    for i in greedy:
        p = tuple(requests[i][0])
        if p not in want:
            want[p] = gpt.kv_generate(exe, scope, slab_prog, *slab,
                                      list(p), GEN_NEW)

    def engine(spec):
        return GenerationEngine(cfg, scope, exe=ptt.Executor(),
                                max_slots=GEN_SLOTS, max_seq=GPT_SEQ,
                                paged=True, block_size=GEN_BLOCK,
                                spec_decode=spec)

    runs, stats = {}, {}
    set_flags({"FLAGS_enable_monitor": True})
    _zero_launch_counts()
    try:
        for spec in (False, True):
            monitor.reset_stats()
            eng = engine(spec)
            with DrawRecorder() as draws:
                runs[spec] = gen_serve_run(ptt, eng, requests)
            runs[spec]["draws"] = draws
            stats[spec] = monitor.get_stats_snapshot()
        launches = _launch_counts()
        step_ms = _step_times(torch, eng)
        monitor.reset_stats()
        set_flags({"FLAGS_fault_spec": GEN_FAULT_SPEC,
                   "FLAGS_fault_seed": GEN_FAULT_SEED})
        reset_injector()
        fault_reqs = [(p, {"temperature": 0.0, "top_k": 0, "seed": 0})
                      for p in prompts[:GEN_FAULT_PROMPTS]]
        fault = gen_serve_run(ptt, engine(False), fault_reqs)
        fault_stats = monitor.get_stats_snapshot()["counters"]
    finally:
        set_flags({"FLAGS_enable_monitor": False, "FLAGS_fault_spec": ""})
        reset_injector()

    for spec, r in runs.items():
        c, h = stats[spec]["counters"], stats[spec]["histograms"]
        proposed = c.get("serving.gen_spec_draft_proposed", 0)
        accepted = c.get("serving.gen_spec_draft_accepted", 0)
        phase("gen_serve", spec_decode=spec,
              spec_k=FLAGS.spec_decode_k if spec else 0,
              requests=len(requests), new_tokens=GEN_NEW,
              tokens=r["tokens"], seconds=f"{r['wall']:.3f}",
              tokens_per_s=f"{r['tokens'] / r['wall']:.1f}",
              ttft_p50_ms=f"{r['ttft'][0]:.2f}",
              ttft_p99_ms=f"{r['ttft'][1]:.2f}",
              inter_token_p50_ms=f"{r['itl'][0]:.2f}",
              inter_token_p99_ms=f"{r['itl'][1]:.2f}",
              decode_steps=r["runs"]["decode"],
              prefill_chunks=r["runs"]["prefill"],
              verify_steps=r["runs"].get("verify", 0),
              acceptance=f"{accepted / proposed:.4f}" if proposed else "-",
              prefix_hit_blocks=sum(x["cached_tokens"] for x in
                                    r["results"] if x) // GEN_BLOCK,
              engine_ttft_p50_ms=h.get("serving.gen_ttft_ms", {}).get("p50"),
              slot_occupancy_p50=h.get("serving.gen_slot_occupancy",
                                       {}).get("p50"),
              live_requests_peak=r["live"], slots=GEN_SLOTS,
              mem_after_warmup=r["mem"][0], mem_after_run=r["mem"][1],
              post_warmup_compiles=r["compiles"], card=f"'{card}'")
    for what, (host, event, busy) in step_ms.items():
        phase("gen_step", step=what, rows=GEN_SLOTS,
              host_ms=f"{host:.3f}", event_ms=f"{event:.3f}",
              busy_ms=f"{busy:.3f}", card=f"'{card}'")
    phase("gen_faults", spec=f"'{GEN_FAULT_SPEC}'", seed=GEN_FAULT_SEED,
          requests=len(fault_reqs),
          retries=fault_stats.get("resilience.retries", 0),
          faults=fault_stats.get("resilience.fault_transient", 0),
          step_failures=fault_stats.get("resilience.gen_step_failures", 0),
          seconds=f"{fault['wall']:.3f}", card=f"'{card}'")

    for spec, r in list(runs.items()) + [("fault", fault)]:
        failed = [(i, repr(e)) for i, e in enumerate(r["errors"]) if e]
        check(not failed and not r["hung"],
              f"[gen_serve] spec={spec}: requests failed {failed}")
        check(r["compiles"] == 0, f"[gen_serve] spec={spec}: "
              f"{r['compiles']} executor cache entries after warmup")
        kv = r["kv"]
        check(kv["blocks_total"] - kv["blocks_free"] == kv["prefix_entries"],
              f"[gen_serve] spec={spec}: blocks held by slots after stop: "
              f"{kv}")
        check(r["breaker"] == "closed", f"[gen_serve] spec={spec}: breaker "
              f"{r['breaker']}")
        check(r["mem"][1] - r["mem"][0] <= GEN_MEMORY_SLACK,
              f"[gen_serve] spec={spec}: allocated {r['mem'][1]} bytes "
              f"after the run, {r['mem'][0]} after warmup")
    for spec in runs:
        wrong = [i for i in greedy
                 if runs[spec]["streams"][i] != want[tuple(requests[i][0])]]
        check(not wrong, f"[gen_serve] spec={spec}: greedy streams differ "
              f"from the slab kv_generate streams for requests {wrong}")
        missing = _missing_stats(stats[spec], GEN_STATS) + (
            _missing_stats(stats[spec], GEN_SPEC_STATS) if spec else [])
        check(not missing, f"[gen_serve] spec={spec}: stats not recorded: "
              f"{missing}")
        check(stats[spec]["counters"]["serving.gen_prefix_hits"] > 0,
              f"[gen_serve] spec={spec}: no prefix-cache hit")
        check(runs[spec]["live"] > GEN_SLOTS,
              f"[gen_serve] spec={spec}: at most {runs[spec]['live']} "
              f"requests were live, so none waited for one of the "
              f"{GEN_SLOTS} slots")
    # spec on against off: greedy streams exactly; a sampled stream
    # exactly up to its first differing token, and there only a flip
    # that rounding explains (spec_flip_gate), nothing after it
    flips, unexplained = [], []
    for i, (a, b) in enumerate(zip(runs[False]["streams"],
                                   runs[True]["streams"])):
        if a == b:
            continue
        seed = requests[i][1]["seed"]
        ok, flip = (False, {"index": 0, "why": "greedy"}) \
            if requests[i][1]["temperature"] == 0.0 else spec_flip_gate(
                a, b, runs[False]["draws"].draws(seed),
                runs[True]["draws"].draws(seed))
        (flips if ok else unexplained).append((i, flip))
    phase("gen_spec_flips", sampled=len(requests) - len(greedy),
          flips=len(flips), unexplained=len(unexplained),
          margins=";".join(
              f"req{i}@{f['index']}:u-cdf_off={f['margin']:.3e}"
              f",cdf_gap={f['gap']:.3e},logit_gap={f['logit_gap']:.3e}"
              for i, f in flips) or "-")
    check(not unexplained, f"[gen_serve] spec-on streams differ from "
          f"spec-off beyond a rounding flip: {unexplained}")
    check(runs[True]["runs"]["verify"] > 0 and
          stats[True]["counters"]["serving.gen_spec_steps"] > 0,
          "[gen_serve] the spec engine never ran its verify step")
    check(not any(launches.values()),
          f"[gen_serve] the generation path launched flash kernels: "
          f"{launches}")
    check(fault_stats.get("resilience.retries", 0) > 0,
          "[gen_serve] the fault run retried nothing")
    wrong = [i for i, (p, _) in enumerate(fault_reqs)
             if fault["streams"][i] != want[tuple(p)]]
    check(not wrong, f"[gen_serve] the fault run's streams differ for "
          f"requests {wrong}")
    return {"ttft_p50_ms": runs[False]["ttft"][0],
            "ttft_p99_ms": runs[False]["ttft"][1]}


# --- ResNet-50, LeNet and Transformer-big NMT training -----------------

# One ResNet-50 step, card against CPU, from the same startup values with
# the scale of every batch_norm that ends a residual branch cut to 0.1 of
# its start (RESNET_BRANCH_SCALE, so each block starts near the
# identity): the loss's relative gap, each parameter gradient's Frobenius
# gap over its norm, and each running mean and variance's max|gap| /
# max|value|. From the startup values as they are, the network amplifies
# rounding: under bf16 AMP a change of 1e-3 in the image moves the JAX
# package's own step-1 gradients by 0.05-1.69 of their norm (median 1.28,
# 3x64x64, batch 4), above the 1.0 an all-zero gradient reads; with the
# branch scales cut, by at most 0.30 (tools/torch_rounding_sensitivity.py
# resnet). The
# phase prints the same reading on the card (card_pert_*: the card's AMP
# step with the image moved by 1e-3). Measured on the H100 (NVIDIA H100
# 80GB HBM3, 700.00 W; PERF.md): float32 loss 0, gradients at most
# 2.0e-2, statistics 3.9e-7; AMP loss 3.1e-6, gradients at most 0.21
# (the card's own 1e-3 reading up to 0.40), statistics 1.9e-3.
RESNET_F32_BARS = {"loss": 1e-4, "grad": 0.1, "stat": 1e-4}
RESNET_AMP_BARS = {"loss": 1e-4, "grad": 0.5, "stat": 2e-2}
# NMT's card-vs-CPU gradients, Frobenius gap over the norm. Float32: at
# most 4.4e-4 (src_emb). bf16 AMP: relu in the feed-forward layers stops
# or passes a gradient by the sign of a bf16-rounded input, so at
# Transformer-big width bf16 rounding alone moves the embeddings' and
# the first layers' gradients by about 6%: on the H100 the card's AMP
# step moves by 6.6% (src_emb), 5.1% (enc_0.att.q.w), 5.8% (trg_emb) when
# both embedding tables move by 1e-3 of each value, and parts from the
# CPU's float32 step by 6.9%, 5.1%, 6.4%; the card against the CPU's AMP
# step reads 6.2%, 5.3%, 5.7% (PERF.md). On the CPU at narrower widths
# the JAX package's own gradients move as far under the same change as
# the port's part from them (tools/torch_rounding_sensitivity.py nmt).
# The AMP bar is 1.5 times the largest of those readings; it holds the
# gap to the CPU's AMP step and to its float32 step.
NMT_AMP_GRAD_RTOL = 0.1
NMT_F32_GRAD_RTOL = 1e-3


RESNET_BRANCH_SCALE = 0.1


def _branch_end_scales(main):
    """The scale of each batch_norm that ends a residual branch (its
    output is the Y of the block's elementwise_add)."""
    ops = main.global_block().ops
    add_y = {op.input("Y")[0] for op in ops if op.type == "elementwise_add"}
    return [op.input("Scale")[0] for op in ops if op.type == "batch_norm"
            and op.output("Y")[0] in add_y]


def _stat_names(main):
    """Every batch_norm's running mean and variance var, in program
    order."""
    return [op.input(s)[0] for op in main.global_block().ops
            if op.type == "batch_norm" for s in ("Mean", "Variance")]


def _build_resnet(ptt, amp):
    """ResNet-50 as bench.py's build_resnet50_bench builds it: 3x224x224,
    1000 classes, Momentum lr 0.1, momentum 0.9."""
    from paddle_tpu_torch.models import resnet
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss, _, _ = resnet.build_train(img_shape=RESNET_IMAGE,
                                        class_dim=RESNET_CLASSES, amp=amp)
    return main, startup, loss


def _resnet_feed(batch, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(batch, *RESNET_IMAGE).astype(np.float32),
            "label": rng.randint(0, RESNET_CLASSES, (batch, 1))
            .astype(np.int64)}


def resnet_train_phase(torch, card):
    """ResNet-50 training at bench.py's step through the port's entry
    points: build_train (batch 64, bf16 AMP, Momentum lr 0.1, momentum
    0.9), the startup program on the card, the feed from RandomState(0)
    as bench.py makes it, then 3 warm-up and 10 timed steps through
    run_steps: images/s, MFU (3 x flops_per_image x 64 a step against
    the bf16 peak), peak memory and device ms by class (conv, matmul,
    norm, other). Gates: finite losses (bench.py's lr makes them rise, in
    the JAX package too, so a fall is not asked for), no flash launch,
    no executor cache miss after the first step, and every batch_norm's
    running mean and variance moved from its start (0, 1) and finite.
    Returns (the timed steps' launches, {ops, host_ms, device_ms})."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import resnet

    t0 = time.perf_counter()
    main, startup, loss = _build_resnet(ptt, True)
    scope = ptt.Scope()
    exe = ptt.Executor()  # the card
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    ops = main.global_block().ops
    phase("resnet_train_build", depth=50, batch=RESNET_BATCH,
          image="x".join(map(str, RESNET_IMAGE)), classes=RESNET_CLASSES,
          amp=True, ops=len(ops),
          conv2d=sum(op.type == "conv2d" for op in ops),
          casts=sum(op.type == "cast" for op in ops),
          seconds=f"{time.perf_counter() - t0:.2f}")
    run = run_steps(
        torch, card, "resnet_train", exe, main, scope,
        _resnet_feed(RESNET_BATCH, 0), loss, 0, 3, 10, (), RESNET_BATCH,
        3 * resnet.flops_per_image(50, RESNET_IMAGE[1], RESNET_CLASSES),
        BF16_FLOPS, unit="images",
        must_fall=False, classes=("conv", "matmul", "norm", "other"),
        parts=_step_parts(main))
    _check_stats(torch, "resnet_stats", main, scope)
    return run.launches, {"ops": len(ops), "host_ms": run.host_ms,
                          "device_ms": run.device_ms}


def _check_stats(torch, tag, main, scope):
    """Every batch_norm's running mean and variance moved from its start
    (0, 1) and finite; the [tag] line. Returns their count."""
    stats = _stat_names(main)
    moved = finite = 0
    for i, n in enumerate(stats):
        t = scope.get(n)
        start = 1.0 if i % 2 else 0.0  # mean, variance, mean, ...
        finite += bool(torch.isfinite(t).all())
        moved += bool((t != start).any())
    phase(tag, vars=len(stats), moved=moved, finite=finite)
    check(finite == len(stats), f"{len(stats) - finite} running "
          f"statistics are not finite")
    check(moved == len(stats), f"{len(stats) - moved} running statistics "
          f"never moved from their start")
    return len(stats)


def resnet_cpu_check(torch):
    """ResNet-50 at full width, batch 2, one step on the card and one on
    the CPU from the same startup values with the residual branches'
    last batch_norm scales cut (RESNET_BRANCH_SCALE), in float32 and in
    bf16 AMP (_card_and_cpu: the convolutions' outputs bfloat16 under
    AMP, float32 without, on both devices): the loss, the gradient of
    every parameter and the running mean and variance of every
    batch_norm (MeanOut and VarianceOut, after the step) within
    RESNET_F32_BARS and RESNET_AMP_BARS. Beside the AMP readings, the
    card's AMP step with the image moved by 1e-3 against the card's
    (card_pert_*). The float32 step takes full float32 convolutions (the
    package keeps cudnn.allow_tf32 off)."""
    import numpy as np
    import paddle_tpu_torch as ptt

    check(not torch.backends.cudnn.allow_tf32,
          "cudnn.allow_tf32 is on: the float32 convolutions would be TF32")
    progs = {amp: _build_resnet(ptt, amp) for amp in (False, True)}
    check(progs[False][1].fingerprint() == progs[True][1].fingerprint(),
          "the float32 and AMP startup programs differ")
    main = progs[False][0]
    pnames = sorted(p.name for p in main.all_parameters())
    stats = _stat_names(main)
    scales = _branch_end_scales(main)
    check(len(scales) == 16, f"{len(scales)} residual branches, not 16")
    fetch = [f"{p}@GRAD" for p in pnames] + stats

    def prepare(values):
        return {**values, **{n: values[n] * RESNET_BRANCH_SCALE
                             for n in scales}}

    def perturb(values, feed):
        noise = np.random.RandomState(5).randn(*feed["image"].shape)
        return values, {**feed, "image": (feed["image"] + 1e-3 * noise)
                        .astype(np.float32)}

    t0 = time.perf_counter()
    out, _ = _card_and_cpu(
        ptt, {amp: (m, loss) for amp, (m, _, loss) in progs.items()},
        progs[False][1], _resnet_feed(RESNET_CHECK_BATCH, 1), fetch, 0,
        prepare=prepare, perturb=perturb)
    n = len(pnames)
    for amp, bars in ((False, RESNET_F32_BARS), (True, RESNET_AMP_BARS)):
        card, cpu = out[amp, "card"], out[amp, "cpu"]
        loss_rel = _loss_rel(card, cpu)
        grads = list(_grad_rel(fetch[:n], card[:1 + n], cpu[:1 + n])
                     .values())
        # max|gap| / max|value| of each running mean and variance
        stat = [float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(card[1 + n:], cpu[1 + n:])]
        beside = {}
        if amp:
            pert = list(_grad_rel(fetch[:n], out[amp, "card_perturbed"]
                                  [:1 + n], card[:1 + n]).values())
            loss_pert = _loss_rel(out[amp, "card_perturbed"], card)
            beside = {"card_pert_loss_rel": f"{loss_pert:.3e}",
                      "card_pert_grad_gap_median": f"{np.median(pert):.3e}",
                      "card_pert_grad_gap_max": f"{max(pert):.3e}"}
        phase("resnet_cpu_check", batch=RESNET_CHECK_BATCH, amp=amp,
              loss_card=f"{float(card[0]):.6f}",
              loss_cpu=f"{float(cpu[0]):.6f}", loss_rel=f"{loss_rel:.3e}",
              grad_gap_median=f"{np.median(grads):.3e}",
              grad_gap_max=f"{max(grads):.3e}",
              stat_gap_median=f"{np.median(stat):.3e}",
              stat_gap_max=f"{max(stat):.3e}", **beside,
              bars=",".join(f"{k}:{v}" for k, v in bars.items()),
              seconds=f"{time.perf_counter() - t0:.2f}")
        check(all(np.isfinite(x).all() for x in card),
              f"non-finite values in the card's step (amp={amp})")
        check(loss_rel <= bars["loss"], f"ResNet card vs CPU loss differs "
              f"by {loss_rel} > {bars['loss']} (amp={amp})")
        check(max(grads) <= bars["grad"], f"ResNet card vs CPU gradients "
              f"differ by {max(grads)} > {bars['grad']} (amp={amp})")
        check(max(stat) <= bars["stat"], f"ResNet card vs CPU running "
              f"statistics differ by {max(stat)} > {bars['stat']} "
              f"(amp={amp})")


def _build_resnet_recipe(ptt, amp):
    """ResNet-50 at bench.py's shape trained by RECIPES["resnet"]:
    models/resnet.py's build_train line for line, its Momentum swapped
    for Momentum(piecewise_decay(...), 0.9, regularization=L2Decay(1e-4))
    (build_train takes no regularization). Returns (main, startup, loss,
    the LR var)."""
    from paddle_tpu_torch.contrib import mixed_precision as mp
    from paddle_tpu_torch.models import resnet
    L = ptt.layers
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        img = L.data("image", shape=list(RESNET_IMAGE), dtype="float32")
        label = L.data("label", shape=[1], dtype="int64")
        logits = resnet.resnet(img, RESNET_CLASSES, 50)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        L.accuracy(L.softmax(logits), label)
        lr = _recipe_lr_var(ptt, RECIPES["resnet"])
        opt_inst = ptt.optimizer.Momentum(
            learning_rate=lr, momentum=0.9,
            regularization=ptt.regularizer.L2Decay(1e-4))
        if amp:
            opt_inst = mp.decorate(opt_inst)
        opt_inst.minimize(loss)
    return main, startup, loss, lr


def resnet_recipe_phase(torch, card, train):
    """[resnet_recipe]: ResNet-50 at bench.py's b64 AMP step through
    _build_resnet_recipe, the step counter set so that the steps read
    RECIPES["resnet"]["first_step"] on, 3 warm-up and 5 timed steps
    through run_steps (its gates), fetching the LR var each step. Gates:
    each step's rate equals recipe_lr within LR_RTOL (0.1, then 0.055 at
    the boundary, then 0.01), every running statistic moved and finite.
    Prints the op count and host ms beside [resnet_train]'s (`train`)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import resnet

    recipe = RECIPES["resnet"]
    t0 = time.perf_counter()
    main, startup, loss, lr = _build_resnet_recipe(ptt, True)
    scope = ptt.Scope()
    exe = ptt.Executor()  # the card
    exe.run(startup, scope=scope)
    _start_counter(torch, scope, recipe["first_step"])
    torch.cuda.synchronize()
    ops = main.global_block().ops
    phase("resnet_recipe_build", ops=len(ops), train_ops=train["ops"],
          decayed=sum(op.type == "scale" and op.attrs.get("scale") == 1e-4
                      for op in ops),
          boundaries=",".join(map(str, recipe["boundaries"])),
          steps_per_epoch=RESNET_STEPS_PER_EPOCH,
          seconds=f"{time.perf_counter() - t0:.2f}")
    run = run_steps(
        torch, card, "resnet_recipe", exe, main, scope,
        _resnet_feed(RESNET_BATCH, 0), loss, 0, 3, 5, (), RESNET_BATCH,
        3 * resnet.flops_per_image(50, RESNET_IMAGE[1], RESNET_CLASSES),
        BF16_FLOPS, unit="images", must_fall=False,
        classes=("conv", "matmul", "norm", "other"), fetch=[lr.name],
        parts=_step_parts(main, lr))
    lrs = [float(f[0][0]) for f in run.fetched]
    phase("resnet_recipe_lr", first_step=recipe["first_step"],
          lr=",".join(f"{x:.7e}" for x in lrs),
          lr_max_rel_err=f"{_lr_gate('resnet_recipe', recipe, lrs):.3e}",
          ops=len(ops), train_ops=train["ops"],
          host_ms_median=f"{run.host_ms:.3f}",
          train_host_ms_median=f"{train['host_ms']:.3f}",
          device_ms=f"{run.device_ms:.3f}",
          train_device_ms=f"{train['device_ms']:.3f}", card=f"'{card}'")
    _check_stats(torch, "resnet_recipe_stats", main, scope)


def _lenet_flops():
    """Operations of one LeNet forward image: 2 per multiply-add of the
    two 5x5 convolutions (20 maps of 24x24 from 1, 50 of 8x8 from 20)
    and the head (800 -> 10)."""
    return 2 * (25 * 1 * 20 * 24 * 24 + 25 * 20 * 50 * 8 * 8 + 800 * 10)


def lenet_train_phase(torch, card):
    """LeNet (models/lenet.py convolutional_neural_network, [1, 28, 28])
    as examples/train_mnist.py trains it: cross_entropy, accuracy, Adam
    lr 1e-3, float32, at batch 128 of seeded images in [0, 1): 3
    warm-up and 10 timed steps through run_steps (images/s, step ms; the
    loss must fall), then one step on the card against one on the CPU
    from the same startup values: the loss within rtol 1e-4 and every
    parameter's gradient within rtol 1e-3, atol 1e-6."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import lenet

    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        img = ptt.layers.data("img", shape=[1, 28, 28], dtype="float32")
        label = ptt.layers.data("label", shape=[1], dtype="int64")
        loss, predict = lenet.convolutional_neural_network(img, label)
        ptt.layers.accuracy(predict, label)
        ptt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    scope = ptt.Scope()
    exe = ptt.Executor()  # the card
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(LENET_BATCH, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (LENET_BATCH, 1)).astype(np.int64)}
    run_steps(torch, card, "lenet_train", exe, main, scope, feed, loss, 0,
              3, 10, (), LENET_BATCH, 3 * _lenet_flops(), F32_FLOPS,
              unit="images", classes=("conv", "matmul", "norm", "other"))
    grads = [f"{p.name}@GRAD" for p in main.all_parameters()]
    out, _ = _card_and_cpu(ptt, {False: (main, loss)}, startup, feed,
                           grads, 0)
    card, cpu = out[False, "card"], out[False, "cpu"]
    errs = [float(np.abs(a - b).max()) for a, b in zip(card[1:], cpu[1:])]
    loss_rel = _loss_rel(card, cpu)
    phase("lenet_cpu_check", batch=LENET_BATCH, loss_rel=f"{loss_rel:.3e}",
          grad_max_abs_err=f"{max(errs):.3e}", params=len(grads))
    check(loss_rel <= 1e-4, f"LeNet card vs CPU loss differs by {loss_rel}")
    for name, a, b in zip(grads, card[1:], cpu[1:]):
        check(np.allclose(a, b, rtol=1e-3, atol=1e-6),
              f"{name}: LeNet card vs CPU differ by "
              f"{float(np.abs(a - b).max())}")


def _build_nmt(ptt, cfg, batch, amp=True):
    from paddle_tpu_torch.models import nmt
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss, _ = nmt.build_train(cfg, batch, NMT_LEN, NMT_LEN, lr=1e-4,
                                  amp=amp)
    return main, startup, loss


def _nmt_feed(cfg, batch, seed):
    import numpy as np
    rng = np.random.RandomState(seed)
    return {"src_tokens": rng.randint(0, cfg.vocab_size, (batch, NMT_LEN))
            .astype(np.int64),
            "trg_tokens": rng.randint(0, cfg.vocab_size,
                                      (batch, NMT_LEN + 1)).astype(np.int64)}


def nmt_train_phase(torch, card):
    """Transformer-big NMT training as bench.py's build_transformer_bench
    (6+6 layers, d 1024, 16 heads, d_ff 4096, vocab 32000, batch 32,
    source and target 256, bf16 AMP, dropout 0.1, attention dropout 0,
    label smoothing 0.1, AdamW lr 1e-4, tokens from RandomState(0)): 3
    warm-up and 10 timed steps through run_steps, with tokens a step =
    batch x target length and MFU from flops_per_step. Each bf16 flash
    kernel must run 12 times a step (6 encoder and 6 decoder
    self-attentions; cross-attention takes the plain path), and no other
    flash kernel. Then nmt_cpu_check. Returns the timed steps'
    launches."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import nmt

    cfg = nmt.transformer_big_nmt(dropout=0.1, attn_dropout=0.0,
                                  use_flash=True)
    t0 = time.perf_counter()
    main, startup, loss = _build_nmt(ptt, cfg, NMT_BATCH)
    scope = ptt.Scope()
    exe = ptt.Executor()  # the card
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    phase("nmt_train_build", layers=f"{cfg.n_layers}+{cfg.n_layers}",
          d_model=cfg.d_model, heads=cfg.n_heads, d_ff=cfg.d_ff,
          vocab=cfg.vocab_size, batch=NMT_BATCH, src_len=NMT_LEN,
          trg_len=NMT_LEN, amp=True, ops=len(main.global_block().ops),
          seconds=f"{time.perf_counter() - t0:.2f}")
    tokens = NMT_BATCH * NMT_LEN
    flops = nmt.flops_per_step(cfg, NMT_BATCH, NMT_LEN, NMT_LEN)
    launches = run_steps(torch, card, "nmt_train", exe, main, scope,
                         _nmt_feed(cfg, NMT_BATCH, 0), loss,
                         2 * cfg.n_layers, 3, 10, BF16_KERNEL_SYMBOLS,
                         tokens, flops / tokens, BF16_FLOPS).launches
    del scope, exe

    nmt_cpu_check(ptt, nmt)
    return launches


def nmt_cpu_check(ptt, nmt):
    """Transformer-big at batch 1, dropout 0, one step on the card and
    one on the CPU from the same startup values, in float32 and in bf16
    AMP. Float32: the loss within rtol 1e-4 and each gradient's Frobenius
    gap within NMT_F32_GRAD_RTOL of its norm. AMP: the loss within
    AMP_LOSS_RTOL, the gradients within NMT_AMP_GRAD_RTOL of the CPU's
    AMP step and of its float32 step (vs_f32_*); beside them, against
    the card's AMP step with both embedding tables moved by 1e-3 of each
    value (card_pert_*): how far bf16 rounding alone moves each gradient
    at this size."""
    import numpy as np

    cfg = nmt.transformer_big_nmt(dropout=0.0, attn_dropout=0.0,
                                  use_flash=True)
    progs = {amp: _build_nmt(ptt, cfg, 1, amp) for amp in (False, True)}
    check(progs[False][1].fingerprint() == progs[True][1].fingerprint(),
          "the float32 and AMP startup programs differ")
    grads = ["src_emb@GRAD", "enc_0.att.q.w@GRAD",
             f"dec_{cfg.n_layers - 1}.ffn.fc2.w@GRAD", "trg_emb@GRAD",
             "nmt_head.w@GRAD"]

    def perturb(values, feed):
        rng = np.random.RandomState(5)
        return {**values, **{n: (values[n] * (1 + 1e-3 * rng.randn(
            *values[n].shape))).astype(np.float32)
            for n in ("src_emb", "trg_emb")}}, feed

    t0 = time.perf_counter()
    out, launches = _card_and_cpu(
        ptt, {amp: (main, loss) for amp, (main, _, loss) in progs.items()},
        progs[False][1], _nmt_feed(cfg, 1, 1), grads, 2 * cfg.n_layers,
        perturb=perturb)
    card, cpu = out[False, "card"], out[False, "cpu"]
    f32_loss, f32_grads = _loss_rel(card, cpu), _grad_rel(grads, card, cpu)
    phase("nmt_cpu_check", batch=1, amp=False,
          loss_card=f"{float(card[0]):.6f}", loss_cpu=f"{float(cpu[0]):.6f}",
          loss_rel=f"{f32_loss:.3e}",
          **{f"{n}_rel": f"{e:.3e}" for n, e in f32_grads.items()},
          grad_tol=NMT_F32_GRAD_RTOL,
          launches_per_kernel=launches[False]["flash_attention_fwd"])
    check(f32_loss <= 1e-4, f"NMT card vs CPU loss differs by {f32_loss}")
    check(all(e <= NMT_F32_GRAD_RTOL for e in f32_grads.values()),
          f"NMT card vs CPU float32 gradients differ: {f32_grads} > "
          f"{NMT_F32_GRAD_RTOL}")
    _amp_check("nmt_cpu_check", out, grads, t0, vs_f32=cpu,
               grad_tol=NMT_AMP_GRAD_RTOL)
    vs_f32 = _grad_rel(grads, out[True, "card"], cpu)
    check(all(e <= NMT_AMP_GRAD_RTOL for e in vs_f32.values()),
          f"NMT card AMP vs CPU float32 gradients differ: {vs_f32} > "
          f"{NMT_AMP_GRAD_RTOL}")

# [http_serve]: the serving model and the trained GPT-small behind one
# ServingHTTPServer; a threshold rule over the front end's own request
# counter fires once the monitor counts a request, and writes one
# incident bundle
HTTP_ALERT_RULE = "http_requests:threshold:serving.http_requests >= 1"
HTTP_ALERT_WAIT_S = 30.0


def _http(url, body=None, raw=None):
    """(status, parsed JSON or text, bytes of the answer's body) of one
    request; an HTTP error status is an answer, not an exception."""
    import urllib.error
    import urllib.request
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            status, ctype, payload = (r.status, r.headers["Content-Type"],
                                      r.read())
    except urllib.error.HTTPError as e:
        status, ctype, payload = (e.code, e.headers["Content-Type"],
                                  e.read())
    text = payload.decode()
    return (status, json.loads(text) if ctype == "application/json"
            else text, len(payload))


def _http_pass(url, path, bodies):
    """POST `bodies` to url+path from N_THREADS threads, each waiting
    for its answer before it sends its next: (answers, latencies in
    seconds, wall seconds)."""
    got, lat, errors = [None] * len(bodies), [None] * len(bodies), []

    def client(idx):
        for i in idx:
            t0 = time.perf_counter()
            try:
                got[i] = _http(url + path, bodies[i])
            except Exception as e:  # recorded and re-raised below
                errors.append(e)
                return
            lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client,
                                args=(range(j, len(bodies), N_THREADS),))
               for j in range(N_THREADS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads),
          "an HTTP client thread did not finish")
    if errors:
        raise errors[0]
    return got, lat, wall


def http_serve_phase(torch, card, model_dir, served, gpt_scope, gpt_cfg,
                     prompts, serial):
    """The HTTP front end (serving.serve) over a ServingEngine on the
    saved BERT-base (float32, T 512, max batch 8) and a GenerationEngine
    on the trained GPT-small (8 slots, max_seq 512, paged KV in blocks
    of GEN_BLOCK), on an ephemeral port. From N_THREADS threads: the
    [serve] requests to /v1/predict (answers within 2e-3 of the
    engine's own [serve] answers, which [serve] holds to the CPU's), then
    the [gpt_generate] prompts to /v1/generate, greedy, GEN_NEW tokens
    (streams equal to the serial kv_generate ones). Gates: each forward
    launches the float32 flash forward 12 times (counts set to 0 just
    before the requests, read just after); /healthz 200; a malformed
    body 400; /v1/kv/export of a served prompt a 200 shipment of its
    full blocks, which a second paged engine adopts and decodes the
    serial stream from (_adopt_and_decode); HTTP_ALERT_RULE, set in
    FLAGS_alert_rules with the monitor off during the timed traffic,
    fires once the monitor counts a request: ALERTS{...} on /metrics,
    the rule firing on /alertz, and exactly one incident bundle in a
    temporary FLAGS_alert_bundle_dir. Prints req/s and p50/p99 over
    HTTP beside [serve]'s direct numbers. Returns the float32 flash
    forward's launches and the HTTP requests/s and p50/p99."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import monitor_alerts
    from paddle_tpu_torch.core.flags import get_flags, set_flags
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention
    from paddle_tpu_torch.serving import (EngineConfig, GenerationEngine,
                                          ServingEngine, serve)

    _, reqs, answers, direct = served
    bundles = tempfile.TemporaryDirectory(prefix="ptt_bundles_")
    alert_flags = {"FLAGS_alert_rules": HTTP_ALERT_RULE,
                   "FLAGS_alert_eval_interval_s": 0.2,
                   "FLAGS_alert_bundle_dir": bundles.name,
                   "FLAGS_enable_monitor": False}
    keep = get_flags(list(alert_flags))
    set_flags(alert_flags)
    engine = ServingEngine(EngineConfig(max_batch_size=MAX_BATCH),
                           predictor=create_paddle_predictor(
                               AnalysisConfig(model_dir)))
    gen = GenerationEngine(gpt_cfg, gpt_scope, exe=ptt.Executor(),
                           max_slots=GEN_SLOTS, max_seq=GPT_SEQ, paged=True,
                           block_size=GEN_BLOCK)
    t0 = time.perf_counter()
    srv = serve(engine, port=0, gen_engine=gen)
    start_s = time.perf_counter() - t0
    try:
        bodies = [{"inputs": {"tokens": r.tolist()}, "timeout_ms": 60000}
                  for r in reqs]
        _zero_launch_counts()
        batches0 = engine.batches
        got, lat, wall = _http_pass(srv.url, "/v1/predict", bodies)
        launches = flash_attention.launches
        batches = engine.batches - batches0
        gen_bodies = [{"prompt": p, "max_new_tokens": GEN_NEW,
                       "timeout_ms": 120000} for p in prompts]
        gen_got, gen_lat, gen_wall = _http_pass(srv.url, "/v1/generate",
                                                gen_bodies)
        health = _http(srv.url + "/healthz")
        bad = _http(srv.url + "/v1/predict", raw=b"{not json")
        kv = _http(srv.url + "/v1/kv/export",
                   {"prompt": prompts[HTTP_KV_PROMPT]})
        kv_stream = _adopt_and_decode(ptt, gpt_cfg, gpt_scope, kv[1],
                                      prompts[HTTP_KV_PROMPT])
        # the monitor on: the front end's request counter moves and the
        # background evaluator fires the rule
        set_flags({"FLAGS_enable_monitor": True})
        _http(srv.url + "/healthz")
        deadline = time.perf_counter() + HTTP_ALERT_WAIT_S
        while monitor_alerts.firing_count() == 0 and \
                time.perf_counter() < deadline:
            time.sleep(0.05)
        metrics = _http(srv.url + "/metrics")[1]
        alertz = _http(srv.url + "/alertz")[1]
        n_bundles = len([f for f in os.listdir(bundles.name)
                         if f.startswith("incident_")])
    finally:
        srv.close()
        engine.stop()
        gen.stop()
        monitor_alerts.stop_alerts()
        set_flags(keep)
        bundles.cleanup()

    statuses = sorted({st for st, _, _ in got} |
                      {st for st, _, _ in gen_got})
    errs = [float(np.max(np.abs(np.asarray(body["outputs"][name],
                                           np.float32) - want)))
            for (st, body, _), want in zip(got, answers) if st == 200
            for name in body["outputs"]]
    streams = [st == 200 and body["tokens"] == want
               for (st, body, _), want in zip(gen_got, serial)]
    p50, p99 = _percentiles(lat)
    g50, g99 = _percentiles(gen_lat)
    alert_line = 'ALERTS{alertname="http_requests",alertstate="firing"} 1'
    phase("http_serve", requests=len(bodies), batches=batches,
          launches=launches, statuses=",".join(map(str, statuses)),
          max_abs_err_vs_engine=f"{max(errs, default=math.inf):.3e}",
          req_per_s=f"{len(bodies) / wall:.3f}",
          p50_ms=f"{p50 * 1e3:.2f}", p99_ms=f"{p99 * 1e3:.2f}",
          answer_mb=f"{sum(n for _, _, n in got) / 1e6:.1f}",
          direct_req_per_s=f"{direct['req_per_s']:.3f}",
          direct_p50_ms=f"{direct['p50_ms']:.2f}",
          direct_p99_ms=f"{direct['p99_ms']:.2f}",
          generate_requests=len(gen_bodies),
          streams_equal=sum(streams),
          generate_tokens_per_s=f"{len(gen_bodies) * GEN_NEW / gen_wall:.1f}",
          generate_p50_ms=f"{g50 * 1e3:.2f}",
          generate_p99_ms=f"{g99 * 1e3:.2f}",
          healthz=health[0], malformed=bad[0], kv_export=kv[0],
          kv_export_mb=f"{kv[2] / 1e6:.1f}",
          kv_adopted_blocks=kv_stream["adopted"],
          kv_stream_equal=kv_stream["tokens"] == serial[HTTP_KV_PROMPT],
          alerts_firing=alertz["firing"], bundles=n_bundles,
          start_s=f"{start_s:.2f}", card=f"'{card}'")
    check(statuses == [200], f"HTTP statuses {statuses}, not all 200")
    check(len(errs) == len(bodies) and max(errs) <= 2e-3,
          f"HTTP answers differ from the engine's by {max(errs)}")
    check(all(streams), f"{len(streams) - sum(streams)} HTTP generate "
          f"streams differ from the serial kv_generate ones")
    n_layers = transformer.bert_base().n_layers
    check(batches > 0 and launches == n_layers * batches,
          f"fwd_kernel_tf32wg launches {launches} != {n_layers} x "
          f"{batches} forwards")
    check(health[0] == 200 and health[1]["state"] == "ok",
          f"/healthz answered {health}")
    check(bad[0] == 400, f"a malformed body answered {bad[0]}, not 400")
    n_full = len(prompts[HTTP_KV_PROMPT]) // GEN_BLOCK
    check(kv[0] == 200 and kv[1]["n_blocks"] == n_full,
          f"/v1/kv/export answered {kv[0]} with "
          f"{kv[1].get('n_blocks') if kv[0] == 200 else kv[1]} blocks, "
          f"not {n_full}")
    check(kv_stream["adopted"] == n_full and
          kv_stream["cached_tokens"] == n_full * GEN_BLOCK,
          f"the adopting engine took {kv_stream['adopted']} of {n_full} "
          f"blocks and reused {kv_stream['cached_tokens']} tokens")
    check(kv_stream["tokens"] == serial[HTTP_KV_PROMPT],
          "the stream decoded from the adopted KV differs from the "
          "serial one")
    check(alert_line in metrics, "no firing ALERTS series on /metrics")
    check(alertz["firing"] == 1 and alertz["rules"][0]["state"] == "firing",
          f"/alertz shows {alertz['rules']}")
    check(n_bundles == 1, f"{n_bundles} incident bundles, not 1")
    return launches, {"req_per_s": len(bodies) / wall, "p50_ms": p50 * 1e3,
                      "p99_ms": p99 * 1e3}


# [http_serve]'s /v1/kv/export: the [gpt_generate] prompt of 300 tokens
# (18 full blocks of GEN_BLOCK), already served over /v1/generate
HTTP_KV_PROMPT = GEN_PROMPT_LENS.index(300)


def _adopt_and_decode(ptt, cfg, scope, shipment, prompt):
    """Adopt a /v1/kv/export shipment into a second paged engine on the
    card (the same weights, decode state of its own under "gen2.") and
    decode GEN_NEW greedy tokens of `prompt` from it. Returns its stream,
    reused tokens and adopted blocks."""
    from paddle_tpu_torch.serving import GenerationEngine, adopt_prefix
    eng = GenerationEngine(cfg, scope, exe=ptt.Executor(),
                           max_slots=GEN_SLOTS, max_seq=GPT_SEQ, paged=True,
                           block_size=GEN_BLOCK, state_prefix="gen2.",
                           default_timeout_ms=120000)
    eng.start()
    try:
        res = adopt_prefix(eng, shipment)
        out = eng.generate(prompt, GEN_NEW)
    finally:
        eng.stop()
    return {"tokens": out["tokens"], "cached_tokens": out["cached_tokens"],
            "adopted": res["adopted"]}


# --- the serving fleet: router, replica processes, disaggregated decode -

# [router_serve]'s drills: each sends [serve]'s requests (cycled) through
# the Router from N_THREADS threads, runs its action on a thread of its
# own once N_THREADS answers are in, and stops once ROUTER_DRILL_AFTER
# answers came back after the action returned
ROUTER_DRILL_AFTER = 16
ROUTER_DRILL_LIMIT_S = 300.0   # a drill that has not ended by then failed
ROUTER_STOP_TRIES = 8          # the stop drill's own requests, at most
FLEET_READY_S = 300.0          # replica processes: warm and bound by then
FLEET_EXIT_S = 120.0           # and exited this long after SIGTERM
ROUTER_HOP_REQUESTS = 4        # [serve]'s first requests over the url= hop
DISAGG_DECODERS = 2            # [disagg_gen]: one prefill replica, two decode


def _bert_engine(model_dir):
    """A ServingEngine over the saved BERT-base on the card, as [serve]'s."""
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    return ServingEngine(EngineConfig(max_batch_size=MAX_BATCH),
                         predictor=create_paddle_predictor(
                             AnalysisConfig(model_dir)))


def _router_drill(router, reqs, action):
    """Cycle `reqs` through router.predict from N_THREADS threads. Once
    N_THREADS answers are in, `action(wait)` runs on a thread of its own
    (`wait(k)` blocks until k more answers arrived); the clients stop
    ROUTER_DRILL_AFTER answers after it returned. Returns ([(request
    index, answer)], [errors], the action's result, answers after the
    action)."""
    cond = threading.Condition()
    state = {"next": 0, "answers": [], "after": None, "stop": False}
    errors, result = [], {}

    def wait(k):
        with cond:
            goal = len(state["answers"]) + k
            cond.wait_for(lambda: len(state["answers"]) >= goal or
                          state["stop"], ROUTER_DRILL_LIMIT_S)

    def act():
        try:
            result["value"] = action(wait)
        except Exception as e:  # reported by the caller's gates
            errors.append(e)
        with cond:
            state["after"] = len(state["answers"])
            cond.notify_all()

    actor = threading.Thread(target=act)

    def client():
        while True:
            with cond:
                if state["stop"]:
                    return
                i = state["next"] % len(reqs)
                state["next"] += 1
            try:
                out = router.predict({"tokens": reqs[i]}, timeout_ms=60000)
            except Exception as e:  # reported by the caller's gates
                with cond:
                    errors.append(e)
                    state["stop"] = True
                    cond.notify_all()
                return
            with cond:
                state["answers"].append((i, next(iter(out.values()))))
                n = len(state["answers"])
                if n == N_THREADS:
                    actor.start()
                if state["after"] is not None and \
                        n - state["after"] >= ROUTER_DRILL_AFTER:
                    state["stop"] = True
                cond.notify_all()

    threads = [threading.Thread(target=client) for _ in range(N_THREADS)]
    for th in threads:
        th.start()
    with cond:
        ended = cond.wait_for(lambda: state["stop"], ROUTER_DRILL_LIMIT_S)
        state["stop"] = True
        cond.notify_all()
    for th in threads:
        th.join(timeout=120)
    if actor.ident is not None:
        actor.join(timeout=120)
    check(ended and not any(th.is_alive() for th in threads) and
          not actor.is_alive(), "a router drill did not end")
    after = len(state["answers"]) - (state["after"] or 0)
    return state["answers"], errors, result.get("value"), after


def stop_and_redispatch(router, rep, feed, tries=ROUTER_STOP_TRIES):
    """[router_drill] stop's action: stop `rep`, then send `feed` through
    `router` until a request was re-dispatched away from it (at most
    `tries`). The router runs no background probe, so `rep` stays in its
    table until the drill's own probe_once(); its queue is empty, so the
    least-loaded pick (ties broken by name: the stopped replica is r0)
    sends the next request to it, and its EngineClosedError makes the
    router re-dispatch. Returns the re-dispatches this counted."""
    before = router.redispatches
    rep.stop()
    for _ in range(tries):
        if router.redispatches > before:
            break
        router.predict(feed, timeout_ms=60000)
    return router.redispatches - before


def _answer_err(answers, want):
    """max |answer - [serve]'s answer| over [(request index, answer)]."""
    import numpy as np
    return max(float(np.abs(np.asarray(a) - want[i]).max())
               for i, a in answers)


def router_serve_phase(torch, card, model_dir, served, http):
    """[router_serve]: a RouterHTTP over a Router over two in-process
    Replica(engine=ServingEngine) on [serve]'s saved BERT-base (float32,
    T 512, max batch 8). [serve]'s requests go over HTTP from N_THREADS
    threads: every answer 200 and within 2e-3 of [serve]'s, 12 float32
    flash-forward launches a forward (counts set to 0 just before the
    traffic, read just after), both replicas served, no new executor
    cache entry after warmup; req/s and p50/p99 print beside [serve]'s
    direct numbers and [http_serve]'s. Then three drills through the
    Router with traffic flowing (_router_drill), each with zero failed
    requests, answers within 2e-3 and 12 launches a forward:
    preempt r0 and resume it (r0 serves again after the resume); stop
    r0 (serving.router_redispatches moves, and a probe takes r0 out of
    the healthy set); hot_swap r1 for a standby built the same way
    (drained, the standby with no cache entry after its warmup, r1
    stopped, the standby serving). Returns the launches of all four
    runs."""
    import numpy as np
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention
    from paddle_tpu_torch.serving import Replica, Router, RouterHTTP

    _, reqs, answers, direct = served
    n_layers = transformer.bert_base().n_layers
    t_phase = time.perf_counter()
    reps = {n: Replica(n, engine=_bert_engine(model_dir))
            for n in ("r0", "r1")}
    t0 = time.perf_counter()
    for rep in reps.values():
        rep.start()
    start_s = time.perf_counter() - t0
    set_flags({"FLAGS_enable_monitor": True})
    monitor.reset_stats()
    # no background probe: the stop drill's probe is its own, so the
    # stopped replica stays routable until then (stop_and_redispatch)
    router = Router(list(reps.values()), start_probe=False)
    front = RouterHTTP(router, port=0)
    launched = []

    def counted(run, engines, warm=0):
        """Run `run()` between a zero and a read of the launch counts;
        gate 12 launches a forward (the engines' batches and `warm`
        warmup forwards). Returns run's result, launches, batches."""
        before = [e.batches for e in engines]
        _zero_launch_counts()
        out = run()
        launches = flash_attention.launches
        launched.append(launches)
        batches = [e.batches - b for e, b in zip(engines, before)]
        check(launches == n_layers * (sum(batches) + warm),
              f"[router_serve] fwd_kernel_tf32wg launches {launches} != "
              f"{n_layers} x ({sum(batches)} batches + {warm} warmup "
              f"forwards)")
        return out, launches, batches

    standby = Replica("r2", engine=_bert_engine(model_dir))
    try:
        bodies = [{"inputs": {"tokens": r.tolist()}, "timeout_ms": 60000}
                  for r in reqs]
        engines = [reps["r0"].engine, reps["r1"].engine]
        (got, lat, wall), launches, batches = counted(
            lambda: _http_pass(front.url, "/v1/predict", bodies), engines)
        statuses = sorted({st for st, _, _ in got})
        errs = [float(np.max(np.abs(np.asarray(body["outputs"][name],
                                               np.float32) - want)))
                for (st, body, _), want in zip(got, answers) if st == 200
                for name in body["outputs"]]
        compiles = [r.post_warmup_compiles() for r in reps.values()]
        p50, p99 = _percentiles(lat)
        phase("router_serve", replicas=len(reps), requests=len(bodies),
              batches=",".join(map(str, batches)), launches=launches,
              statuses=",".join(map(str, statuses)),
              max_abs_err_vs_serve=f"{max(errs, default=math.inf):.3e}",
              req_per_s=f"{len(bodies) / wall:.3f}",
              p50_ms=f"{p50 * 1e3:.2f}", p99_ms=f"{p99 * 1e3:.2f}",
              direct_req_per_s=f"{direct['req_per_s']:.3f}",
              direct_p50_ms=f"{direct['p50_ms']:.2f}",
              direct_p99_ms=f"{direct['p99_ms']:.2f}",
              http_req_per_s=f"{http['req_per_s']:.3f}",
              http_p50_ms=f"{http['p50_ms']:.2f}",
              http_p99_ms=f"{http['p99_ms']:.2f}",
              post_warmup_compiles=",".join(map(str, compiles)),
              start_s=f"{start_s:.2f}", card=f"'{card}'")
        check(statuses == [200], f"[router_serve] statuses {statuses}")
        check(len(errs) == len(bodies) and max(errs) <= 2e-3,
              f"[router_serve] answers differ from [serve]'s by "
              f"{max(errs, default=math.inf)}")
        check(all(batches), f"[router_serve] a replica served no batch: "
              f"{batches}")
        check(not any(compiles), f"[router_serve] executor cache entries "
              f"after warmup: {compiles}")

        def drill(name, action, engines, warm=0):
            r0 = router.redispatches
            t0 = time.perf_counter()
            (got, errors, res, after), launches, batches = counted(
                lambda: _router_drill(router, reqs, action), engines, warm)
            err = _answer_err(got, answers) if got else math.inf
            phase("router_drill", drill=name, answers=len(got),
                  after_action=after, failed=len(errors),
                  redispatches=router.redispatches - r0,
                  batches=",".join(map(str, batches)), launches=launches,
                  max_abs_err_vs_serve=f"{err:.3e}",
                  seconds=f"{time.perf_counter() - t0:.2f}",
                  card=f"'{card}'")
            check(not errors, f"[router_drill] {name}: failed requests "
                  f"{[repr(e) for e in errors]}")
            check(err <= 2e-3, f"[router_drill] {name}: answers differ "
                  f"from [serve]'s by {err}")
            return res, router.redispatches - r0, batches

        def preempt(wait):
            router.preempt("r0")
            wait(ROUTER_DRILL_AFTER)
            router.resume("r0")
            return reps["r0"].engine.batches

        resumed_at, _, _ = drill("preempt_resume", preempt, engines)
        check(reps["r0"].engine.batches > resumed_at,
              "[router_drill] preempt_resume: r0 served nothing after "
              "its resume")

        def stop(wait):
            return stop_and_redispatch(router, reps["r0"],
                                       {"tokens": reqs[0]})

        _, moved, _ = drill("stop", stop, engines)
        router.probe_once()
        healthy = [r.name for r in router.healthy_replicas()]
        check(moved >= 1, "[router_drill] stop: no request was "
              "re-dispatched away from the stopped replica")
        check("r0" not in healthy, f"[router_drill] stop: the probe "
              f"left r0 routable: {healthy}")

        def swap(wait):
            return router.hot_swap("r1", standby)

        res, _, batches = drill(
            "hot_swap", swap, engines + [standby.engine],
            warm=len(standby.engine.warmup_shapes()))
        phase("router_hot_swap", old=res["old"], new=res["new"],
              drained=res["drained"],
              standby_post_warmup_compiles=res[
                  "standby_post_warmup_compiles"],
              standby_batches=batches[-1],
              old_stopped=not reps["r1"].engine.ready)
        check(res["swapped"] and res["drained"],
              f"[router_hot_swap] {res}")
        check(res["standby_post_warmup_compiles"] == 0 and
              standby.post_warmup_compiles() == 0,
              f"[router_hot_swap] the standby added cache entries after "
              f"its warmup: {res}")
        check(not reps["r1"].engine.ready and batches[-1] > 0,
              "[router_hot_swap] the old replica still runs or the standby "
              "served nothing")
        counters = monitor.get_stats_snapshot()["counters"]
        phase("router_stats", **{k.replace("serving.", ""): v for k, v in
                                 sorted(counters.items())
                                 if k.startswith("serving.router_")},
              seconds=f"{time.perf_counter() - t_phase:.1f}")
        check(counters.get("serving.router_redispatches", 0) >= 1 and
              counters.get("serving.router_hot_swaps") == 1 and
              counters.get("serving.router_preemptions") == 1,
              f"[router_stats] {counters}")
    finally:
        front.close()
        router.close(stop_replicas=True)
        set_flags({"FLAGS_enable_monitor": False})
        monitor.reset_stats()
    return sum(launched)


def kv_wire_phase(torch, card):
    """[kv_wire]: a bfloat16 and a float32 paged pool set on the card (2
    layers of k and v, [64, GEN_BLOCK, 12, 64], random) packed with
    kv_wire.pack_blocks (one gather a pool, one copy to the host) and
    unpacked: every row bit-equal to the pool's, the row digest equal on
    both sides, and the JSON byte-equal to that of the same pools copied
    to the CPU."""
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.serving import kv_wire

    names = ["k0", "v0", "k1", "v1"]
    ids = [3, 17, 40, 5, 63]
    hashes = [f"h{i}" for i in range(len(ids))]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype in (torch.bfloat16, torch.float32):
        card_scope, cpu_scope = Scope(), Scope()
        for n in names:
            pool = torch.randn((64, GEN_BLOCK, H, HD), generator=gen,
                               device="cuda").to(dtype)
            card_scope.set(n, pool)
            cpu_scope.set(n, pool.cpu())
        t0 = time.perf_counter()
        payload = kv_wire.pack_blocks(card_scope, names, ids, hashes,
                                      GEN_BLOCK)
        pack_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        ship = kv_wire.unpack_blocks(payload)
        unpack_ms = (time.perf_counter() - t0) * 1e3
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        idx = torch.tensor(ids, device="cuda")
        equal = all(torch.equal(
            rows.view(bits),
            card_scope.get(names[2 * li + side]).index_select(0, idx)
            .cpu().view(bits))
            for li, pair in enumerate(ship.layers)
            for side, rows in enumerate(pair))
        same_json = json.dumps(payload) == json.dumps(
            kv_wire.pack_blocks(cpu_scope, names, ids, hashes, GEN_BLOCK))
        same_digest = kv_wire.rows_digest(payload["layers"]) == \
            kv_wire.rows_digest(ship.layers)
        phase("kv_wire", dtype=payload["dtype"], blocks=len(ids),
              kv_bytes=kv_wire.payload_bytes(payload),
              json_bytes=len(json.dumps(payload)),
              pack_ms=f"{pack_ms:.2f}", unpack_ms=f"{unpack_ms:.2f}",
              rows_bit_equal=equal, json_equal_cpu=same_json,
              digest_equal=same_digest, card=f"'{card}'")
        check(equal and same_json and same_digest and
              ship.dtype == dtype, f"[kv_wire] {payload['dtype']}: rows "
              f"{equal}, JSON {same_json}, digest {same_digest}, dtype "
              f"{ship.dtype}")


class _ReplicaProcess:
    """One `python -m paddle_tpu_torch.serving.replica` process on the
    card, its standard output in `tmp/<name>.log`."""

    def __init__(self, tmp, name, args, env=None):
        here = os.path.dirname(os.path.abspath(__file__))
        self.name = name
        self.port_file = os.path.join(tmp, f"{name}.port")
        self.log = os.path.join(tmp, f"{name}.log")
        self.url = None
        self._out = open(self.log, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.replica",
             "--port-file", self.port_file, *args],
            cwd=here, stdout=self._out, stderr=subprocess.STDOUT,
            env=dict(os.environ, **(env or {}),
                     PYTHONPATH=os.pathsep.join(
                         [here] + [p for p in [os.environ.get(
                             "PYTHONPATH")] if p])))

    def ready(self, deadline):
        """Wait for the port file (written after warmup and bind)."""
        while not os.path.exists(self.port_file):
            check(self.proc.poll() is None,
                  f"replica {self.name} exited {self.proc.returncode}: "
                  f"{self.tail()}")
            check(time.perf_counter() < deadline,
                  f"replica {self.name} not ready: {self.tail()}")
            time.sleep(0.1)
        with open(self.port_file) as f:
            self.url = f"http://127.0.0.1:{f.read().strip()}"
        return self.url

    def records(self):
        """The JSON lines the replica printed."""
        with open(self.log) as f:
            return [json.loads(ln) for ln in f if ln.startswith("{")]

    def tail(self, n=2000):
        with open(self.log) as f:
            return f.read()[-n:]

    def terminate(self):
        """SIGTERM, then the exit code (the replica drains first)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(FLEET_EXIT_S)
        finally:
            self.kill()

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self._out.close()


def write_gpt_weights(tmp, gpt_scope, gpt_cfg):
    """The trained GPT-small's decode parameters, written from its scope
    to tmp/gpt.npz for [disagg_gen]'s replica processes. Returns the
    path."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import gpt

    t0 = time.perf_counter()
    prog, _ = _build_decode(ptt, gpt.build_paged_decode_step, gpt_cfg,
                            GEN_SLOTS, GPT_SEQ, GEN_BLOCK, 2)
    weights = os.path.join(tmp, "gpt.npz")
    np.savez(weights, **{p.name: gpt_scope.get_numpy(p.name)
                         for p in prog.all_parameters()})
    phase("gpt_weights", mb=f"{os.path.getsize(weights) / 1e6:.1f}",
          seconds=f"{time.perf_counter() - t0:.2f}")
    return weights


def start_fleet(tmp, model_dir, weights, gpt_cfg):
    """Start [router_hop]'s replica process (--model-dir, tracing on)
    and [disagg_gen]'s three (--weights: one prefill, DISAGG_DECODERS
    decode, from write_gpt_weights' npz), all at once. The parent's
    kernels are built already, so no child builds one. Returns {name:
    _ReplicaProcess}."""
    fleet = {"hop": _ReplicaProcess(
        tmp, "hop", ["--model-dir", model_dir, "--seq-buckets", "",
                     "--max-batch-size", str(MAX_BATCH),
                     "--timeout-ms", "120000",
                     "--trace-out", os.path.join(tmp, "hop.spans.jsonl")],
        env={"FLAGS_enable_trace": "1", "FLAGS_trace_sample": "1.0"})}
    gen_args = ["--weights", weights, "--vocab", str(gpt_cfg.vocab_size),
                "--d-model", str(gpt_cfg.d_model),
                "--n-heads", str(gpt_cfg.n_heads),
                "--n-layers", str(gpt_cfg.n_layers),
                "--d-ff", str(gpt_cfg.d_ff), "--max-seq", str(GPT_SEQ),
                "--slots", str(GEN_SLOTS), "--block-size", str(GEN_BLOCK),
                "--timeout-ms", "600000", "--kv-digest"]
    for name in ["p0"] + [f"d{i}" for i in range(DISAGG_DECODERS)]:
        fleet[name] = _ReplicaProcess(tmp, name, gen_args)
    phase("fleet_start", processes=len(fleet))
    return fleet


def router_hop_phase(torch, card, served, fleet):
    """[router_hop]: the replica process over the saved BERT-base behind
    a RouterHTTP as Replica(url=...), tracing on in both processes.
    ROUTER_HOP_REQUESTS of [serve]'s requests: answers within 2e-3 of
    [serve]'s in-process ones (the largest difference printed); each
    replica http.request span (read from the child's --trace-out file)
    parents under one of the router's router.dispatch spans, in the
    router's http.request trace; SIGTERM makes the replica drain and
    exit 0."""
    import numpy as np
    from paddle_tpu_torch import trace
    from paddle_tpu_torch.core.flags import get_flags, set_flags
    from paddle_tpu_torch.serving import Replica, Router, RouterHTTP

    _, reqs, answers, _ = served
    rep = fleet["hop"]
    t0 = time.perf_counter()
    url = rep.ready(time.perf_counter() + FLEET_READY_S)
    ready_s = time.perf_counter() - t0
    flags = {"FLAGS_enable_trace": True, "FLAGS_trace_sample": 1.0}
    keep = get_flags(list(flags))
    set_flags(flags)
    trace.reset()
    router = Router([Replica("hop", url=url)], start_probe=False)
    front = RouterHTTP(router, port=0)
    try:
        bodies = [{"inputs": {"tokens": r.tolist()}, "timeout_ms": 120000}
                  for r in reqs[:ROUTER_HOP_REQUESTS]]
        got, lat, wall = _http_pass(front.url, "/v1/predict", bodies)
        spans = trace.drain_spans()
    finally:
        front.close()
        router.close()
        set_flags(keep)
        trace.reset()
    code = rep.terminate()
    with open(os.path.join(os.path.dirname(rep.log),
                           "hop.spans.jsonl")) as f:
        child = [json.loads(ln) for ln in f]
    statuses = sorted({st for st, _, _ in got})
    err = max((float(np.max(np.abs(np.asarray(body["outputs"][name],
                                              np.float32) - want)))
               for (st, body, _), want in zip(got, answers) if st == 200
               for name in body["outputs"]), default=math.inf)
    roots = {s["trace_id"] for s in spans if s["name"] == "http.request"
             and s["parent_id"] is None and s["attrs"].get("tier") ==
             "router"}
    disp = {s["span_id"]: s["trace_id"] for s in spans
            if s["name"] == "router.dispatch"}
    hops = [s for s in child if s["name"] == "http.request"
            and s["attrs"].get("path") == "/v1/predict"]
    joined = [s for s in hops if disp.get(s["parent_id"]) == s["trace_id"]
              and s["trace_id"] in roots]
    phase("router_hop", requests=len(bodies),
          statuses=",".join(map(str, statuses)),
          max_abs_err_vs_in_process=f"{err:.3e}",
          req_per_s=f"{len(bodies) / wall:.3f}",
          p50_ms=f"{_percentiles(lat)[0] * 1e3:.2f}",
          traces=len(roots), dispatch_spans=len(disp),
          replica_request_spans=len(hops), joined=len(joined),
          exit_code=code, ready_s=f"{ready_s:.1f}", card=f"'{card}'")
    check(statuses == [200], f"[router_hop] statuses {statuses}")
    check(err <= 2e-3, f"[router_hop] answers differ from the in-process "
          f"ones by {err}")
    check(len(roots) == len(bodies) and len(joined) == len(bodies),
          f"[router_hop] {len(joined)} of {len(bodies)} replica request "
          f"spans parent under a router.dispatch span of the router's "
          f"trace")
    check(code == 0, f"[router_hop] the replica exited {code} after "
          f"SIGTERM: {rep.tail()}")


def _healthz(url):
    return _http(url + "/healthz")[1]


def disagg_gen_phase(torch, card, prompts, serial, fleet, gen_serve):
    """[disagg_gen]: a Router with FLAGS_router_disagg on over the three
    --weights replica processes (full-width GPT-small from [gpt_train]'s
    scope, paged, block GEN_BLOCK, max_seq GPT_SEQ, GEN_SLOTS slots): p0
    prefill, d0 and d1 decode. Each [gpt_generate] prompt is sent twice,
    greedy, GEN_NEW tokens, from N_THREADS threads, each prompt with a
    session of its own (so the second send finds its prefix on its decode
    replica). Gates: every stream equal to the serial kv_generate stream;
    p0 exported at least once and the router reused a prefix at least
    once; no executor cache entry after warmup in any replica (their
    /healthz); every adoption's row sha256, printed by the adopting
    process, equal to the exported shipment's, printed by p0. Then the
    decode replica that holds the longest prompt is preempted, p0 stops
    (SIGTERM) and the prompt is sent again: the stream unchanged and
    serving.disagg_fallbacks >= 1. Every replica exits 0 on SIGTERM; no
    flash kernel ran in this process. Prints KV MB shipped, ms a
    transfer and the decode replicas' TTFT beside [gen_serve]'s."""
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.serving import Replica, Router

    names = ["p0"] + [f"d{i}" for i in range(DISAGG_DECODERS)]
    t0 = time.perf_counter()
    deadline = time.perf_counter() + FLEET_READY_S
    urls = {n: fleet[n].ready(deadline) for n in names}
    ready_s = time.perf_counter() - t0
    set_flags({"FLAGS_enable_monitor": True, "FLAGS_router_disagg": True})
    monitor.reset_stats()
    router = Router([Replica(n, url=urls[n],
                             role="prefill" if n == "p0" else "decode")
                     for n in names])
    want = dict(zip((tuple(p) for p in prompts), serial))
    results, errors = {}, []
    try:
        for rep in router.replicas():
            rep.start(timeout_s=60)
        _zero_launch_counts()
        t0 = time.perf_counter()
        for rnd in range(2):
            def client(idx, rnd=rnd):
                for i in idx:
                    try:
                        results[(rnd, i)] = router.generate(
                            {"prompt": prompts[i],
                             "max_new_tokens": GEN_NEW,
                             "timeout_ms": 600000},
                            session=f"prompt{i}")
                    except Exception as e:  # reported below
                        errors.append((rnd, i, repr(e)))
            threads = [threading.Thread(
                target=client, args=(range(j, len(prompts), N_THREADS),))
                for j in range(N_THREADS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        health = {n: _healthz(urls[n]) for n in names}
        stats = monitor.get_stats_snapshot()
        # the fallback: the decode replica holding the longest prompt
        # leaves, the prefill replica stops, the prompt goes again
        longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
        holder = router._affinity.get(f"prompt{longest}")
        router.preempt(holder)
        p0_code = fleet["p0"].terminate()
        again = router.generate({"prompt": prompts[longest],
                                 "max_new_tokens": GEN_NEW,
                                 "timeout_ms": 600000}, session="fallback")
        fb = monitor.get_stats_snapshot()["counters"]
    finally:
        router.close()
        set_flags({"FLAGS_enable_monitor": False,
                   "FLAGS_router_disagg": False})
        monitor.reset_stats()
    codes = {"p0": p0_code}
    codes.update({n: fleet[n].terminate() for n in names[1:]})
    recs = {n: fleet[n].records() for n in names}
    # a shipment may come from a decode replica that owns the chain too
    exports = {r["chain_tail"]: r for n in names for r in recs[n]
               if r["kind"] == "kv_export" and r["blocks"]}
    adopts = [r for n in names[1:] for r in recs[n]
              if r["kind"] == "kv_adopt" and r["shipped"]]
    digest_ok = [a["blocks"] == a["shipped"] and a["chain_tail"] in exports
                 and exports[a["chain_tail"]]["sha256"] == a["sha256"]
                 for a in adopts]
    wrong = [(rnd, i) for (rnd, i), r in results.items()
             if r["tokens"] != want[tuple(prompts[i])]]
    c, h = stats["counters"], stats["histograms"]
    xfer = h.get("serving.kv_xfer_ms", {"count": 0, "sum": 0.0, "max": 0.0})
    ttft = [r["ttft_ms"] for r in results.values()]
    compiles = {n: hz["engines"]["generate"]["post_warmup_compiles"]
                for n, hz in health.items()}
    phase("disagg_gen", prompts=len(prompts), requests=len(results),
          new_tokens=GEN_NEW, streams_equal=len(results) - len(wrong),
          failed=len(errors), kv_mb=f"{c.get('serving.kv_xfer_bytes', 0) /
                                      1e6:.1f}",
          kv_blocks=c.get("serving.kv_xfer_blocks", 0),
          exports=len(exports), adoptions=len(adopts),
          digests_equal=sum(digest_ok),
          prefix_reuse=c.get("serving.disagg_prefix_reuse", 0),
          transfers=xfer["count"],
          xfer_ms_mean=f"{xfer['sum'] / max(1, xfer['count']):.2f}",
          xfer_ms_max=f"{xfer['max']:.2f}",
          decode_ttft_p50_ms=f"{_percentiles(ttft)[0]:.2f}",
          decode_ttft_p99_ms=f"{_percentiles(ttft)[1]:.2f}",
          gen_serve_ttft_p50_ms=f"{gen_serve['ttft_p50_ms']:.2f}",
          gen_serve_ttft_p99_ms=f"{gen_serve['ttft_p99_ms']:.2f}",
          tokens_per_s=f"{len(results) * GEN_NEW / wall:.1f}",
          seconds=f"{wall:.2f}", ready_s=f"{ready_s:.1f}",
          post_warmup_compiles=",".join(f"{n}:{v}" for n, v in
                                        compiles.items()),
          flash_launches=sum(launches.values()), card=f"'{card}'")
    phase("disagg_fallback", preempted=holder, prompt_len=len(
        prompts[longest]), stream_equal=again["tokens"] == want[tuple(
            prompts[longest])], fallbacks=fb.get("serving.disagg_fallbacks",
                                                 0),
          exit_codes=",".join(f"{n}:{v}" for n, v in codes.items()))
    check(not errors, f"[disagg_gen] failed requests {errors}")
    check(not wrong and len(results) == 2 * len(prompts),
          f"[disagg_gen] streams differ from the serial ones: {wrong}")
    check(exports and c.get("serving.disagg_prefix_reuse", 0) >= 1,
          f"[disagg_gen] {len(exports)} exports, "
          f"{c.get('serving.disagg_prefix_reuse', 0)} prefix reuses")
    check(not any(compiles.values()), f"[disagg_gen] executor cache "
          f"entries after warmup: {compiles}")
    check(adopts and all(digest_ok), f"[disagg_gen] adopted rows differ "
          f"from the shipped ones: {adopts} against {list(exports)}")
    check(again["tokens"] == want[tuple(prompts[longest])] and
          fb.get("serving.disagg_fallbacks", 0) >= 1,
          f"[disagg_fallback] stream equal "
          f"{again['tokens'] == want[tuple(prompts[longest])]}, "
          f"{fb.get('serving.disagg_fallbacks', 0)} fallbacks")
    check(all(v == 0 for v in codes.values()), f"[disagg_gen] replica "
          f"exit codes after SIGTERM: {codes}")
    check(not any(launches.values()), f"[disagg_gen] flash kernels ran "
          f"in the router's process: {launches}")


# DeepLabv3+ (models/deeplab.py) at bench.py's step (build_deeplab_bench):
# batch 8, 3x513x513, 19 classes, bf16 AMP, Momentum 1e-3 / 0.9
DEEPLAB_BATCH, DEEPLAB_HW = 8, 513
# [deeplab_cpu_check] at bench.py's CPU-validate size, batch 1 at 65x65
# (the image-pooling branch's batch_norm sees one value a channel there),
# from the startup values with each residual branch's last batch_norm
# scale cut to RESNET_BRANCH_SCALE. The bars are those that
# tests/test_torch_deeplab.py holds the port to against the JAX package
# at this size, derived from the JAX package's own gradients under a
# 1e-3 change of the image (up to 0.39 of their norm under AMP; its
# docstring). The card's own reading under that change prints beside.
DEEPLAB_CHECK_BATCH, DEEPLAB_CHECK_HW = 1, 65
DEEPLAB_F32_BARS = {"loss": 1e-4, "grad": 0.05, "stat": 3e-4}
DEEPLAB_AMP_BARS = {"loss": 2e-3, "grad": 0.6, "stat": 0.03}


def _build_deeplab(ptt, hw, batch, amp):
    from paddle_tpu_torch.models import deeplab
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss, _ = deeplab.build_train(hw, batch, amp=amp)
    return main, startup, loss


def _deeplab_feed(hw, batch, seed):
    """Images and per-pixel labels as bench.py makes them."""
    import numpy as np
    from paddle_tpu_torch.models import deeplab
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(batch, 3, hw, hw).astype(np.float32),
            "label": rng.randint(0, deeplab.N_CLASSES, (batch, hw, hw))
            .astype(np.int64)}


def deeplab_train_phase(torch, card):
    """DeepLabv3+ training at bench.py's step through the port's entry
    points, nothing cut: build_train (batch 8, 3x513x513, 19 classes,
    bf16 AMP, Momentum lr 1e-3, momentum 0.9), the startup program on
    the card, the feed from RandomState(0) as bench.py makes it, then 3
    warm-up and 10 timed steps through run_steps: images/s, MFU (3 x
    flops_per_image(513) x 8 a step against the bf16 peak), peak memory,
    busy share and device ms by class. Gates: finite losses, no flash
    launch, no executor cache miss after the first step, and every
    batch_norm's running mean and variance (62 of each) moved and
    finite. Returns (executor, program, scope, feed, loss, the profiled
    step's device ms, its device ms outside every op scope) for
    [profiler]."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import deeplab

    t0 = time.perf_counter()
    main, startup, loss = _build_deeplab(ptt, DEEPLAB_HW, DEEPLAB_BATCH,
                                         True)
    scope = ptt.Scope()
    exe = ptt.Executor()  # the card
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    ops = main.global_block().ops
    phase("deeplab_train_build", batch=DEEPLAB_BATCH,
          image=f"3x{DEEPLAB_HW}x{DEEPLAB_HW}", classes=deeplab.N_CLASSES,
          amp=True, ops=len(ops),
          **{t: sum(op.type == t for op in ops)
             for t in ("conv2d", "batch_norm", "bilinear_interp", "concat",
                       "cast")},
          params=len(main.all_parameters()),
          seconds=f"{time.perf_counter() - t0:.2f}")
    feed = _deeplab_feed(DEEPLAB_HW, DEEPLAB_BATCH, 0)
    run = run_steps(
        torch, card, "deeplab_train", exe, main, scope, feed, loss, 0, 3, 10,
        (), DEEPLAB_BATCH, 3 * deeplab.flops_per_image(DEEPLAB_HW),
        BF16_FLOPS, unit="images", must_fall=False,
        classes=("conv", "matmul", "norm", "other"))
    n = _check_stats(torch, "deeplab_stats", main, scope)
    check(n == 124, f"{n} running statistics, not 124")
    return exe, main, scope, feed, loss, run.device_ms, run.outside_ms


def profiler_gate(total_ms, outside_ms, step_ms, step_outside_ms, steps=2,
                  tol=0.1):
    """[profiler]'s like-for-like comparison: the device ms inside the
    op scopes of the profiler's `steps` steps (its total less the kernels
    outside every scope, chiefly the feed's copies, whose time follows
    the host) against `steps` times the profiled training step's. Returns
    (scoped ms, wanted ms, whether they agree within `tol`)."""
    scoped = total_ms - outside_ms
    want = steps * (step_ms - step_outside_ms)
    return scoped, want, abs(scoped - want) <= tol * want


def profiler_phase(torch, card, exe, main, scope, feed, loss, step_ms,
                   step_outside_ms):
    """profiler.profiler() (the port's torch.profiler front end) around
    two [deeplab_train] steps, each under record_event. Gates: the
    summary's device ms inside op scopes (total_us less the
    "(unattributed)" kernels) within 10% of twice that of
    [deeplab_train_profile]'s step (profiler_gate; each side's ms
    outside the scopes printed apart), its classes adding up to
    total_us, by_framework_op naming the forward convolutions'
    'conv2d:0/<idx>' scopes (63), and a chrome trace written."""
    from paddle_tpu_torch import profiler

    with tempfile.TemporaryDirectory(prefix="ptt_prof_") as d:
        t0 = time.perf_counter()
        with profiler.profiler(profile_path=d):
            for _ in range(2):
                with profiler.record_event("deeplab_step"):
                    float(exe.run(main, feed=feed, fetch_list=[loss],
                                  scope=scope, return_numpy=False)[0])
        wall_ms = (time.perf_counter() - t0) * 1e3
        path = profiler.last_trace_path()
        trace_mb = os.path.getsize(path) / 1e6 if path and \
            os.path.exists(path) else 0.0
        summary = profiler.summarize_profile()
    total_ms = summary["total_us"] / 1e3
    cats = summary["by_category"]
    fw = summary.get("by_framework_op", {})
    convs = [k for k in fw if k.startswith("conv2d:0/")]
    attributed = sum(r["device_us"] for k, r in fw.items()
                     if k != "(unattributed)") / 1e3
    scoped, want, agree = profiler_gate(total_ms, total_ms - attributed,
                                        step_ms, step_outside_ms)
    phase("profiler", steps=2, wall_ms=f"{wall_ms:.3f}",
          total_ms=f"{total_ms:.3f}",
          train_profile_ms_x2=f"{2 * step_ms:.3f}",
          scoped_ms=f"{scoped:.3f}", train_scoped_ms_x2=f"{want:.3f}",
          outside_ms=f"{total_ms - attributed:.3f}",
          train_outside_ms_x2=f"{2 * step_outside_ms:.3f}",
          **{f"{k}_ms": f"{v / 1e3:.3f}" for k, v in cats.items()},
          framework_ops=len(fw), conv2d_scopes=len(convs),
          attributed_ms=f"{attributed:.3f}", trace_mb=f"{trace_mb:.1f}",
          host_phases=",".join(sorted(profiler.host_phase_stats())),
          card=f"'{card}'")
    top = sorted(fw.items(), key=lambda kv: -kv[1]["device_us"])[:6]
    for key, row in top:
        print(f"  op: {row['device_us'] / 1e3:.3f} ms  {row['calls']} "
              f"kernels  {key}", flush=True)
    profiler.reset_profiler()
    check(agree, f"the profiler's device time inside op scopes, {scoped} "
          f"ms, is not within 10% of the profiled step's, 2 x "
          f"{want / 2} ms")
    check(abs(sum(cats.values()) - summary["total_us"])
          <= 1e-6 * summary["total_us"],
          "the profiler's classes do not add up to its total")
    check(len(convs) == 63, f"{len(convs)} conv2d scopes, not 63")
    check(trace_mb > 0, "no chrome trace written")


def deeplab_cpu_check(torch):
    """DeepLabv3+ at bench.py's CPU-validate size (batch 1, 3x65x65), one
    step on the card and one on the CPU from the same startup values
    with the residual branches' last batch_norm scales cut
    (RESNET_BRANCH_SCALE), in float32 and in bf16 AMP (_card_and_cpu:
    the convolutions' outputs bfloat16 under AMP, float32 without): the
    loss, every parameter's gradient (Frobenius gap over the norm; a
    gradient that is exactly 0 on the CPU must be 0 on the card) and
    every batch_norm's running mean and variance within
    DEEPLAB_F32_BARS and DEEPLAB_AMP_BARS. The image-pooling branch's
    batch_norm sees one value a channel here. Beside the AMP readings,
    the card's AMP step with the image moved by 1e-3 (card_pert_*)."""
    import numpy as np
    import paddle_tpu_torch as ptt

    hw, batch = DEEPLAB_CHECK_HW, DEEPLAB_CHECK_BATCH
    progs = {amp: _build_deeplab(ptt, hw, batch, amp) for amp in (False,
                                                                  True)}
    check(progs[False][1].fingerprint() == progs[True][1].fingerprint(),
          "the float32 and AMP startup programs differ")
    main = progs[False][0]
    pnames = sorted(p.name for p in main.all_parameters())
    stats = _stat_names(main)
    scales = _branch_end_scales(main)
    check(len(scales) == 16, f"{len(scales)} residual branches, not 16")
    fetch = [f"{p}@GRAD" for p in pnames] + stats

    def prepare(values):
        return {**values, **{n: values[n] * RESNET_BRANCH_SCALE
                             for n in scales}}

    def perturb(values, feed):
        noise = np.random.RandomState(5).randn(*feed["image"].shape)
        return values, {**feed, "image": (feed["image"] + 1e-3 * noise)
                        .astype(np.float32)}

    t0 = time.perf_counter()
    out, _ = _card_and_cpu(
        ptt, {amp: (m, loss) for amp, (m, _, loss) in progs.items()},
        progs[False][1], _deeplab_feed(hw, batch, 1), fetch, 0,
        prepare=prepare, perturb=perturb)
    n = len(pnames)
    for amp, bars in ((False, DEEPLAB_F32_BARS), (True, DEEPLAB_AMP_BARS)):
        card, cpu = out[amp, "card"], out[amp, "cpu"]
        loss_rel = _loss_rel(card, cpu)
        grads = list(_grad_rel(fetch[:n], card[:1 + n], cpu[:1 + n])
                     .values())
        stat = [float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(card[1 + n:], cpu[1 + n:])]
        beside = {}
        if amp:
            pert = list(_grad_rel(fetch[:n], out[amp, "card_perturbed"]
                                  [:1 + n], card[:1 + n]).values())
            loss_pert = _loss_rel(out[amp, "card_perturbed"], card)
            beside = {"card_pert_loss_rel": f"{loss_pert:.3e}",
                      "card_pert_grad_gap_median": f"{np.median(pert):.3e}",
                      "card_pert_grad_gap_max": f"{max(pert):.3e}"}
        phase("deeplab_cpu_check", batch=batch, image=f"3x{hw}x{hw}",
              amp=amp, loss_card=f"{float(card[0]):.6f}",
              loss_cpu=f"{float(cpu[0]):.6f}", loss_rel=f"{loss_rel:.3e}",
              grad_gap_median=f"{np.median(grads):.3e}",
              grad_gap_max=f"{max(grads):.3e}",
              zero_grads=sum(not np.any(g) for g in cpu[1:1 + n]),
              stat_gap_median=f"{np.median(stat):.3e}",
              stat_gap_max=f"{max(stat):.3e}", **beside,
              bars=",".join(f"{k}:{v}" for k, v in bars.items()),
              seconds=f"{time.perf_counter() - t0:.2f}")
        check(all(np.isfinite(x).all() for x in card),
              f"non-finite values in the card's step (amp={amp})")
        check(loss_rel <= bars["loss"], f"DeepLab card vs CPU loss differs "
              f"by {loss_rel} > {bars['loss']} (amp={amp})")
        check(max(grads) <= bars["grad"], f"DeepLab card vs CPU gradients "
              f"differ by {max(grads)} > {bars['grad']} (amp={amp})")
        check(max(stat) <= bars["stat"], f"DeepLab card vs CPU running "
              f"statistics differ by {max(stat)} > {bars['stat']} "
              f"(amp={amp})")


# [guard_train]: TrainerGuard around LeNet on the card; a NaN batch at
# GUARD_NAN_AT, a preemption requested before GUARD_PREEMPT_AT. The
# resumed losses against an uninterrupted run's: cuDNN's float32
# convolution backward may add in another order from run to run (the
# package leaves cudnn.deterministic at torch's default), so within rtol
# GUARD_LOSS_RTOL, not bit for bit.
GUARD_STEPS, GUARD_NAN_AT, GUARD_PREEMPT_AT = 8, 3, 5
GUARD_LOSS_RTOL = 1e-5


def guard_train_phase(torch, card):
    """TrainerGuard (resilience/trainer_guard.py) around LeNet on the
    card (batch 128, float32, Adam lr 1e-3), GUARD_STEPS seeded batches
    with a NaN in the batch at GUARD_NAN_AT. An uninterrupted run: that
    step returns None and leaves every persistable equal to the state
    before it (the step-2 snapshot). A second run: request_preemption()
    before step GUARD_PREEMPT_AT writes a checkpoint and raises
    PreemptedError with that many batches consumed; a fresh guard's
    resume() returns the count, and its losses over the rest of the
    batches equal the uninterrupted run's within GUARD_LOSS_RTOL."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.models import lenet
    from paddle_tpu_torch.resilience import PreemptedError, TrainerGuard

    def build():
        main, startup = ptt.Program(), ptt.Program()
        startup.random_seed = SEED
        with ptt.program_guard(main, startup), ptt.unique_name.guard():
            img = ptt.layers.data("img", shape=[1, 28, 28], dtype="float32")
            label = ptt.layers.data("label", shape=[1], dtype="int64")
            loss, _ = lenet.convolutional_neural_network(img, label)
            ptt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        return main, startup, loss

    main, startup, _ = build()
    init_scope = ptt.Scope()
    ptt.Executor().run(startup, scope=init_scope)
    init = {n: init_scope.get_numpy(n) for n in init_scope.names()}
    persist = [v.name for v in main.list_vars()
               if v.persistable and not v.is_data]
    rng = np.random.RandomState(0)
    batches = [{"img": rng.rand(LENET_BATCH, 1, 28, 28).astype(np.float32),
                "label": rng.randint(0, 10, (LENET_BATCH, 1))
                .astype(np.int64)} for _ in range(GUARD_STEPS)]
    batches[GUARD_NAN_AT]["img"][0, 0, 0, 0] = np.nan

    def guard(**kw):
        main, _, loss = build()
        scope = scope_from_numpy(init, ptt.Scope(), ptt.CUDAPlace(0))
        return TrainerGuard(ptt.Executor(), main, scope=scope,
                            fetch_list=[loss], install_sigterm=False, **kw)

    t0 = time.perf_counter()
    losses, rolled_back = [], None
    with guard() as g:
        for i, b in enumerate(batches):
            before = {n: g.scope.get(n).clone() for n in persist} \
                if i == GUARD_NAN_AT else None
            out = g.step(b)
            if before is not None:
                rolled_back = out is None and all(
                    torch.equal(g.scope.get(n), t) for n, t in before.items())
            losses.append(None if out is None else float(out[0]))
        skips = g.nan_skips
    with tempfile.TemporaryDirectory(prefix="ptt_guard_") as ck:
        consumed = None
        with guard(checkpoint_dir=ck) as g:
            try:
                for i, b in enumerate(batches):
                    if i == GUARD_PREEMPT_AT:
                        g.request_preemption()
                    g.step(b)
            except PreemptedError as e:
                consumed = e.global_step
        with guard(checkpoint_dir=ck) as g:
            resumed = g.resume(ck)
            tail = [float(g.step(b)[0]) for b in batches[resumed:]]
    gaps = [abs(a - b) / abs(a) for a, b in zip(losses[resumed:], tail)]
    phase("guard_train", batch=LENET_BATCH, steps=GUARD_STEPS,
          nan_at=GUARD_NAN_AT, nan_skips=skips, rolled_back=rolled_back,
          preempted_at=consumed, resumed_at=resumed,
          resumed_loss_gap_max=f"{max(gaps):.3e}", tol=GUARD_LOSS_RTOL,
          cudnn_deterministic=torch.backends.cudnn.deterministic,
          losses=",".join("skip" if x is None else f"{x:.4f}"
                          for x in losses),
          seconds=f"{time.perf_counter() - t0:.2f}", card=f"'{card}'")
    check(skips == 1 and rolled_back, "the NaN step was not skipped and "
          "rolled back to the state before it")
    check(all(x is not None and math.isfinite(x)
              for i, x in enumerate(losses) if i != GUARD_NAN_AT),
          f"non-finite losses: {losses}")
    check(consumed == GUARD_PREEMPT_AT and resumed == consumed,
          f"preempted after {consumed} batches, resumed at {resumed}; "
          f"want {GUARD_PREEMPT_AT}")
    check(max(gaps) <= GUARD_LOSS_RTOL, f"resumed losses differ from the "
          f"uninterrupted run's by {max(gaps)} > {GUARD_LOSS_RTOL}")



# --- dygraph: eager BERT-base and ResNet-50 -----------------------------

# [dygraph_bert] at [train_f32]'s batch (float32 activations), 2 warm-up
# and 5 timed steps; [dygraph_resnet] at bench.py's ResNet-50 batch;
# [dygraph_trace] traces the trained encoder at batch 8
DYGRAPH_BATCH, DYGRAPH_WARMUP, DYGRAPH_STEPS = 16, 2, 5
DYGRAPH_RESNET_BATCH = 64
DYGRAPH_TRACE_BATCH = 8
# each step's peak memory within this share of step 2's: no growth, as
# a tape that kept every step's activations would show
DYGRAPH_MEM_RTOL = 0.05
# the traced Program on the card against the eager output: the float32
# serving bar
DYGRAPH_TRACE_ATOL = 2e-3
# [dygraph_layers]: each layer's outputs, gradients and state after the
# step, card vs CPU, within this share of max(1, max|CPU|) (cuDNN and
# the CPU sum in other orders; TF32 is off)
DYGRAPH_LAYER_TOL = 1e-4
# [dygraph_cpu_check]'s gradient bar: [train_cpu_check]'s float32 one
DYGRAPH_GRAD_RTOL, DYGRAPH_GRAD_ATOL = 1e-3, 1e-6
# Dropout(0.3) on 4096 values: the kept share within this of 0.7 (7
# standard deviations)
DYGRAPH_KEEP_TOL = 0.05
# BERT's recipe in eager form (RECIPES["bert"] without its warmup, which
# the dygraph PolynomialDecay does not have)
DYGRAPH_BERT_LR, DYGRAPH_BERT_DECAY_STEPS = 1e-4, 1_000_000
# PaddlePaddle/models' ResNet-50 recipe ([resnet_recipe]): 0.1, divided
# by 10 at epochs 30, 60 and 90 of RESNET_STEPS_PER_EPOCH steps
DYGRAPH_RESNET_LRS = (0.1, 0.01, 0.001, 0.0001)


def make_dygraph_bert(dg, layers, cfg, seed=SEED):
    """BERT-base as models/transformer.py shapes it (post-LN blocks of q,
    k, v and an output projection, then a gelu FFN; sinusoid positions;
    the LM head at every position), as a dygraph Layer over the package
    `dg` and its `layers`: Embedding, Linear, LayerNorm and Dropout, with
    add_position_encoding, reshape, transpose, flash_attention,
    softmax_with_cross_entropy and mean through the layer dispatch, and
    the residual sums as VarBase sums (the elementwise layers take a
    VarBase operand for a Python number in both packages). model(tokens,
    labels) is the mean LM loss over all
    positions (labels [b * T, 1]); model.encoder(tokens) the hidden
    states. Dropout (upscale_in_train) only where cfg.dropout is set;
    attention dropout stays 0. The weights are drawn from `seed`."""
    import numpy as np
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h

    def dropout(x, drop):
        return drop(x) if cfg.dropout else x

    class Block(dg.Layer):
        def __init__(self):
            super().__init__()
            self.q = dg.Linear(d, d)
            self.k = dg.Linear(d, d)
            self.v = dg.Linear(d, d)
            self.proj = dg.Linear(d, d)
            self.ln1 = dg.LayerNorm(normalized_shape=d)
            self.fc1 = dg.Linear(d, cfg.d_ff, act="gelu")
            self.fc2 = dg.Linear(cfg.d_ff, d)
            self.ln2 = dg.LayerNorm(normalized_shape=d)
            self.drop = dg.Dropout(
                p=cfg.dropout, dropout_implementation="upscale_in_train")

        def forward(self, x):
            b, t = x.shape[0], x.shape[1]

            def heads(z):
                return layers.transpose(layers.reshape(z, [b, t, h, hd]),
                                        [0, 2, 1, 3])

            ctx = layers.flash_attention(
                heads(self.q(x)), heads(self.k(x)), heads(self.v(x)),
                sm_scale=1.0 / math.sqrt(hd))
            ctx = layers.reshape(layers.transpose(ctx, [0, 2, 1, 3]),
                                 [b, t, d])
            x = self.ln1(x + dropout(self.proj(ctx), self.drop))
            return self.ln2(x + dropout(self.fc2(self.fc1(x)), self.drop))

    class Encoder(dg.Layer):
        def __init__(self):
            super().__init__()
            self.emb = dg.Embedding(size=[cfg.vocab_size, d])
            self.drop = dg.Dropout(
                p=cfg.dropout, dropout_implementation="upscale_in_train")
            self.blocks = [self.add_sublayer(f"layer_{i}", Block())
                           for i in range(cfg.n_layers)]

        def forward(self, tokens):
            x = layers.add_position_encoding(self.emb(tokens), alpha=1.0,
                                             beta=1.0)
            x = dropout(x, self.drop)
            for blk in self.blocks:
                x = blk(x)
            return x

    class Bert(dg.Layer):
        def __init__(self):
            super().__init__()
            self.encoder = Encoder()
            self.head = dg.Linear(d, cfg.vocab_size, bias_attr=False)

        def forward(self, tokens, labels):
            logits = layers.reshape(self.head(self.encoder(tokens)),
                                    [-1, cfg.vocab_size])
            return layers.mean(
                layers.softmax_with_cross_entropy(logits, labels))

    model = Bert()
    # BERT's init, as models/transformer.py writes it: every dense weight
    # and the embedding drawn from N(0, 0.02) (the layers' own default is
    # Xavier), biases 0, layer norms 1 and 0
    rng = np.random.default_rng(seed)
    model.set_dict({n: (0.02 * rng.standard_normal(p.shape,
                                                   dtype=np.float32))
                    for n, p in model.named_parameters()
                    if n.endswith("weight") and ".ln" not in n})
    return model


def make_dygraph_resnet(dg, layers, class_dim=1000, counts=(3, 4, 6, 3)):
    """ResNet as models/resnet.py builds ResNet-50 (a 7x7 stem, a max
    pool, bottleneck stages of `counts` blocks, a global average pool
    and an FC head), as a dygraph Layer over the package `dg` and its
    `layers`: Conv2D, BatchNorm, Pool2D and FC, with relu,
    softmax_with_cross_entropy and mean through the layer dispatch and
    the residual sums as VarBase sums. model(image, label) is the mean
    loss."""

    class ConvBN(dg.Layer):
        def __init__(self, c_in, c_out, k, stride=1, act=None):
            super().__init__()
            self.conv = dg.Conv2D(num_channels=c_in, num_filters=c_out,
                                  filter_size=k, stride=stride,
                                  padding=(k - 1) // 2, bias_attr=False)
            self.bn = dg.BatchNorm(num_channels=c_out, act=act)

        def forward(self, x):
            return self.bn(self.conv(x))

    class Bottleneck(dg.Layer):
        def __init__(self, c_in, filters, stride):
            super().__init__()
            self.conv0 = ConvBN(c_in, filters, 1, act="relu")
            self.conv1 = ConvBN(filters, filters, 3, stride, act="relu")
            self.conv2 = ConvBN(filters, filters * 4, 1)
            self.short = ConvBN(c_in, filters * 4, 1, stride) \
                if c_in != filters * 4 or stride != 1 else None

        def forward(self, x):
            y = self.conv2(self.conv1(self.conv0(x)))
            s = x if self.short is None else self.short(x)
            return layers.relu(s + y)

    class ResNet(dg.Layer):
        def __init__(self):
            super().__init__()
            self.stem = ConvBN(3, 64, 7, 2, act="relu")
            self.pool = dg.Pool2D(pool_size=3, pool_type="max",
                                  pool_stride=2, pool_padding=1)
            self.blocks = []
            c_in = 64
            for stage, n in enumerate(counts):
                filters = 64 * 2 ** stage
                for i in range(n):
                    self.blocks.append(self.add_sublayer(
                        f"block_{stage}_{i}", Bottleneck(
                            c_in, filters,
                            2 if i == 0 and stage > 0 else 1)))
                    c_in = filters * 4
            self.gap = dg.Pool2D(pool_type="avg", global_pooling=True)
            self.fc = dg.FC(size=class_dim)

        def forward(self, image, label):
            x = self.pool(self.stem(image))
            for blk in self.blocks:
                x = blk(x)
            logits = self.fc(self.gap(x))
            return layers.mean(
                layers.softmax_with_cross_entropy(logits, label))

    return ResNet()


def dygraph_bert_opt(ptt, dg):
    """BERT's AdamW recipe in eager form: weight decay 0.01, epsilon
    1e-6, a dygraph PolynomialDecay from 1e-4 to 0 over 1M steps (the
    global-norm clip of 1.0 is set by the caller)."""
    return ptt.optimizer.AdamW(
        learning_rate=dg.PolynomialDecay(DYGRAPH_BERT_LR,
                                         DYGRAPH_BERT_DECAY_STEPS,
                                         end_learning_rate=0.0),
        weight_decay=0.01, epsilon=1e-6)


class GlobalNormClip:
    """set_gradient_clip(GradientClipByGlobalNorm(norm)) of the package
    `fluid` for a with block, back to None after it (the clip is
    process-wide)."""

    def __init__(self, fluid, norm):
        self._clip = fluid.clip
        self._norm = norm

    def __enter__(self):
        self._clip.set_gradient_clip(
            self._clip.GradientClipByGlobalNorm(self._norm))

    def __exit__(self, *exc):
        self._clip.set_gradient_clip(None)


def _dygraph_step(model, opt, inputs):
    """One eager training step: forward, backward, minimize, clear. It
    returns the loss tensor detached, so the step's graph is freed when
    the function returns."""
    loss = model(*inputs)
    loss.backward()
    opt.minimize(loss, parameter_list=model.parameters())
    model.clear_gradients()
    return loss.value.detach()


def _dygraph_run(torch, step, n):
    """`step` run n times: per step (loss, host ms to enqueue it, ms until
    its loss is on the host, the step's peak memory in GB)."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = step()
        t_host = time.perf_counter()
        value = float(loss)
        out.append((value, (t_host - t0) * 1e3,
                    (time.perf_counter() - t0) * 1e3,
                    torch.cuda.max_memory_allocated() / 1e9))
    return out


def _dygraph_profile(torch, step):
    """One step under torch.profiler: (device ms, the kernel table)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.profiler import device_kernels
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        step()
        torch.cuda.synchronize()
    per_name = device_kernels(prof)
    return sum(ms for ms, _ in per_name.values()), per_name


def _dygraph_gates(tag, runs):
    """Finite losses, and each step's peak memory from step 2 on within
    DYGRAPH_MEM_RTOL of step 2's. Returns the largest move."""
    losses = [r[0] for r in runs]
    peaks = [r[3] for r in runs]
    check(all(math.isfinite(x) for x in losses),
          f"[{tag}] non-finite loss: {losses}")
    growth = max(abs(p - peaks[1]) / peaks[1] for p in peaks[1:])
    check(growth <= DYGRAPH_MEM_RTOL, f"[{tag}] peak memory moves by "
          f"{growth:.3f} of step 2's across steps: {peaks}")
    return growth


def dygraph_bert_phase(torch, card, static_peak_gb):
    """[dygraph_bert]: BERT-base at full width (make_dygraph_bert; 12
    layers, d 768, 12 heads of 64, FFN 3072, vocab 30522, T 512, dropout
    0.1), batch DYGRAPH_BATCH, float32, on the card through the dygraph
    entry points: guard(), to_variable, loss.backward(), eager AdamW
    with a dygraph PolynomialDecay under the global-norm clip of 1.0
    (dygraph_bert_opt). DYGRAPH_WARMUP warm-up and DYGRAPH_STEPS timed
    steps (launch counts set to 0 just before those, read just after),
    then one profiled step. Gates: finite losses; each float32 flash
    kernel 12 times a timed step and in the profiled step; flat peak
    memory (_dygraph_gates); two AdamW moments per trainable parameter.
    Prints host and device ms a step, tokens/s, each step's peak and the
    largest against [train_f32]'s static step (`static_peak_gb`).
    Returns (the trained model, the timed steps' launches)."""
    import statistics

    import numpy as np
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.dygraph as dg
    from paddle_tpu_torch.models import transformer

    cfg = transformer.bert_base(dropout=0.1, attn_dropout=0.0)
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (DYGRAPH_BATCH, T)).astype(np.int64)
    t0 = time.perf_counter()
    with dg.guard(), GlobalNormClip(ptt, 1.0):
        model = make_dygraph_bert(dg, ptt.layers, cfg)
        opt = dygraph_bert_opt(ptt, dg)
        inputs = (dg.to_variable(toks), dg.to_variable(toks.reshape(-1, 1)))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0

        def step():
            return _dygraph_step(model, opt, inputs)

        warm = _dygraph_run(torch, step, DYGRAPH_WARMUP)
        _zero_launch_counts()
        timed = _dygraph_run(torch, step, DYGRAPH_STEPS)
        launches = _launch_counts()
        device_ms, per_name = _dygraph_profile(torch, step)
        trainable = [p for p in model.parameters() if p.trainable]
        moments = [sum(isinstance(v, torch.Tensor) for v in
                       opt._dy_state.get(p.name, {}).values())
                   for p in trainable]
    runs = warm + timed
    growth = _dygraph_gates("dygraph_bert", runs)
    step_ms = statistics.median(r[2] for r in timed)
    peak = max(r[3] for r in runs)
    phase("dygraph_bert", layers=cfg.n_layers, d_model=cfg.d_model,
          batch=DYGRAPH_BATCH, T=T, params=len(trainable),
          build_s=f"{build_s:.2f}", steps=DYGRAPH_STEPS,
          step_ms_median=f"{step_ms:.3f}",
          host_ms_median=f"{statistics.median(r[1] for r in timed):.3f}",
          device_ms=f"{device_ms:.3f}" if device_ms else "not measured",
          tokens_per_s=f"{DYGRAPH_BATCH * T / (step_ms / 1e3):.1f}",
          launches_per_step=launches["flash_attention_fwd"] // DYGRAPH_STEPS,
          losses=",".join(f"{r[0]:.4f}" for r in runs),
          peak_gb=",".join(f"{r[3]:.3f}" for r in runs),
          peak_growth=f"{growth:.4f}",
          peak_vs_static=f"{peak / static_peak_gb:.3f}",
          card=f"'{card}'")
    _print_flash_symbols(per_name)
    for name, n in launches.items():
        check(n == cfg.n_layers * DYGRAPH_STEPS, f"[dygraph_bert] {name} "
              f"launches {n} != {cfg.n_layers} x {DYGRAPH_STEPS} steps")
    if device_ms:
        for sym in F32_KERNEL_SYMBOLS:
            n = _symbol_launches(per_name, sym)
            check(n == cfg.n_layers, f"[dygraph_bert] {sym} ran {n} times "
                  f"in the profiled step, not {cfg.n_layers}")
    check(moments == [2] * len(trainable), f"[dygraph_bert] AdamW moments "
          f"a trainable parameter: {sorted(set(moments))}, not 2")
    return model, launches


def _key_bias(name):
    """An attention key's bias: its gradient is 0 but for rounding (a
    constant added to a row of scores), so Adam's step there is noise."""
    return name.endswith(".k.bias")


def dygraph_cpu_check(torch):
    """[dygraph_cpu_check]: the dygraph BERT-base at batch 1, dropout 0,
    built on the card and carried to the CPU port by its state dict
    (convert.layer_from_numpy). Step 1 on each: the loss within
    RECIPE_RTOL and every parameter's gradient within rtol
    DYGRAPH_GRAD_RTOL, atol DYGRAPH_GRAD_ATOL ([train_cpu_check]'s
    float32 bars); after two AdamW steps under dygraph_bert_opt and the
    clip of 1.0, both losses within RECIPE_RTOL and every parameter's
    update within RECIPE_UPDATE_RTOL (Frobenius; [recipe_cpu_check]'s
    bar), the attention key biases' printed apart. The card's steps run the flash forward, and its backward on
    the eager autograd path: each float32 kernel 12 times a step.
    Returns the card's launches."""
    import numpy as np
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.dygraph as dg
    from paddle_tpu_torch.convert import layer_from_numpy
    from paddle_tpu_torch.models import transformer

    cfg = transformer.bert_base(dropout=0.0, attn_dropout=0.0)
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, T))
    t0 = time.perf_counter()
    out, launches, init = {}, None, None
    for where, place in (("card", ptt.CUDAPlace(0)),
                         ("cpu", ptt.CPUPlace())):
        with dg.guard(place), GlobalNormClip(ptt, 1.0):
            model = make_dygraph_bert(dg, ptt.layers, cfg)
            if init is None:
                init = model.state_dict()
            layer_from_numpy(init, model)
            opt = dygraph_bert_opt(ptt, dg)
            inputs = (dg.to_variable(toks),
                      dg.to_variable(toks.reshape(-1, 1)))
            _zero_launch_counts()
            loss = model(*inputs)
            loss.backward()
            grads = {n: p.gradient() for n, p in model.named_parameters()}
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
            losses = [float(loss.numpy())]
            del loss
            losses.append(float(_dygraph_step(model, opt, inputs)))
            if where == "card":
                launches = _launch_counts()
            out[where] = (losses, grads, {n: v - init[n] for n, v in
                                          model.state_dict().items()})
            del model, opt
    (l_card, g_card, d_card), (l_cpu, g_cpu, d_cpu) = out["card"], out["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    keys = [n for n in init if _key_bias(n)]
    held = [n for n in init if not _key_bias(n)]
    grad = {n: _fro(g_card[n], g_cpu[n]) for n in held}
    upd = {n: _fro(d_card[n], d_cpu[n]) for n in held}
    worst_g, worst_u = max(grad, key=grad.get), max(upd, key=upd.get)
    # [train_cpu_check]'s float32 gradient bar, elementwise, on every
    # parameter (the key biases' gradients are within atol of 0)
    grad_off = [n for n in init if not np.allclose(
        g_card[n], g_cpu[n], rtol=DYGRAPH_GRAD_RTOL, atol=DYGRAPH_GRAD_ATOL)]
    phase("dygraph_cpu_check", batch=1, T=T, steps=2, params=len(init),
          loss_card=",".join(f"{x:.6f}" for x in l_card),
          loss_cpu=",".join(f"{x:.6f}" for x in l_cpu),
          loss_rel=f"{loss_rel:.3e}",
          grad_gap_median=f"{np.median(list(grad.values())):.3e}",
          grad_gap_max=f"{grad[worst_g]:.3e}", grad_gap_worst=worst_g,
          key_bias_grad_gap_max=(
              f"{max(_fro(g_card[n], g_cpu[n]) for n in keys):.3e}"),
          update_gap_median=f"{np.median(list(upd.values())):.3e}",
          update_gap_max=f"{upd[worst_u]:.3e}", update_gap_worst=worst_u,
          key_bias_update_gap_max=(
              f"{max(_fro(d_card[n], d_cpu[n]) for n in keys):.3e}"),
          grads_off_bar=len(grad_off),
          launches_per_kernel=launches["flash_attention_fwd"],
          bars=f"loss:{RECIPE_RTOL},grad:{DYGRAPH_GRAD_RTOL}+"
               f"{DYGRAPH_GRAD_ATOL},update:{RECIPE_UPDATE_RTOL}",
          seconds=f"{time.perf_counter() - t0:.2f}")
    check(all(n == 2 * cfg.n_layers for n in launches.values()),
          f"[dygraph_cpu_check] card launches {launches}, not "
          f"{cfg.n_layers} x 2 each")
    check(loss_rel <= RECIPE_RTOL, f"[dygraph_cpu_check] loss differs by "
          f"{loss_rel} > {RECIPE_RTOL}")
    check(not grad_off, f"[dygraph_cpu_check] gradients off the bar "
          f"(rtol {DYGRAPH_GRAD_RTOL}, atol {DYGRAPH_GRAD_ATOL}): "
          f"{grad_off}")
    check(upd[worst_u] <= RECIPE_UPDATE_RTOL, f"[dygraph_cpu_check] "
          f"{worst_u}'s update differs by {upd[worst_u]} > "
          f"{RECIPE_UPDATE_RTOL}")
    return launches


def dygraph_trace_phase(torch, card, model):
    """[dygraph_trace]: TracedLayer.trace of the trained [dygraph_bert]
    encoder in eval() at batch DYGRAPH_TRACE_BATCH on the card. The
    captured Program, run by the card's Executor, gives the eager output
    within DYGRAPH_TRACE_ATOL and runs the float32 flash forward once a
    layer (counts set to 0 just before the call, read after);
    save_inference_model, then io.load_inference_model in a fresh scope,
    gives the same output. Then a traced function that starts with an
    op on its input alone (scale, then the first encoder block) gives
    the eager answer on a second, different input (the JAX package's
    capture freezes that op's first output). Returns the traced call's
    launches."""
    import numpy as np
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.dygraph as dg

    encoder = model.encoder
    vocab = encoder.emb.weight.shape[0]
    rng = np.random.RandomState(3)
    toks = rng.randint(0, vocab, (DYGRAPH_TRACE_BATCH, T)).astype(np.int64)
    t0 = time.perf_counter()
    with dg.guard():
        model.eval()
        eager, traced = dg.TracedLayer.trace(encoder, [dg.to_variable(toks)])
        eager = eager.numpy()
        _zero_launch_counts()
        got, = traced([toks])
        counts = _launch_counts()
        gap = float(np.abs(got - eager).max())
        with tempfile.TemporaryDirectory(prefix="ptt_traced_") as d:
            traced.save_inference_model(d)
            with ptt.scope_guard(ptt.Scope()):
                exe = ptt.Executor()
                prog, feeds, fetches = ptt.io.load_inference_model(d, exe)
                reloaded, = exe.run(prog, feed={feeds[0]: toks},
                                    fetch_list=fetches)
        reload_gap = float(np.abs(reloaded - eager).max())
        x1, x2 = (rng.randn(2, T, eager.shape[-1]).astype(np.float32)
                  for _ in range(2))
        block = encoder.blocks[0]

        def f(x):
            return block(ptt.layers.scale(x, scale=2.0))

        _, traced_f = dg.TracedLayer.trace(f, [dg.to_variable(x1)])
        second, = traced_f([x2])
        input_op_gap = float(np.abs(
            second - f(dg.to_variable(x2)).numpy()).max())
        model.train()
    program = traced.program
    phase("dygraph_trace", batch=DYGRAPH_TRACE_BATCH, T=T,
          ops=len(program.global_block().ops),
          persistables=sum(v.persistable for v in program.list_vars()),
          max_abs_err=f"{gap:.3e}", reloaded_max_abs_err=f"{reload_gap:.3e}",
          input_op_max_abs_err=f"{input_op_gap:.3e}",
          tol=DYGRAPH_TRACE_ATOL, fwd_launches=counts["flash_attention_fwd"],
          seconds=f"{time.perf_counter() - t0:.2f}", card=f"'{card}'")
    n_layers = len(encoder.blocks)
    check(counts == {"flash_attention_fwd": n_layers,
                     "flash_attention_bwd_dq": 0,
                     "flash_attention_bwd_dkv": 0},
          f"[dygraph_trace] launches of a traced call {counts}; want the "
          f"forward {n_layers} times")
    check(gap <= DYGRAPH_TRACE_ATOL, f"[dygraph_trace] traced vs eager "
          f"{gap} > {DYGRAPH_TRACE_ATOL}")
    check(reload_gap <= DYGRAPH_TRACE_ATOL, f"[dygraph_trace] reloaded vs "
          f"eager {reload_gap} > {DYGRAPH_TRACE_ATOL}")
    check(input_op_gap <= DYGRAPH_TRACE_ATOL, f"[dygraph_trace] a traced "
          f"input-only op gives {input_op_gap} off eager on a new input")
    return counts


def dygraph_resnet_phase(torch, card):
    """[dygraph_resnet]: ResNet-50 (make_dygraph_resnet) at bench.py's
    width (3x224x224, 1000 classes), batch DYGRAPH_RESNET_BATCH, float32,
    on the card through the dygraph entry points under PaddlePaddle/
    models' recipe in eager form: Momentum 0.9 with L2Decay(1e-4) and a
    dygraph PiecewiseDecay (DYGRAPH_RESNET_LRS at epochs 30, 60, 90).
    DYGRAPH_WARMUP + DYGRAPH_STEPS steps, then eval() on the same batch.
    Gates: finite losses; flat peak memory; every running mean moved
    from its start and finite; the eval() loss, which reads the running
    statistics, differs from a train-mode forward's and leaves them as
    they were; the optimizer holds state for exactly the trainable
    parameters, none for a running statistic. Prints images/s."""
    import statistics

    import numpy as np
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.dygraph as dg

    rng = np.random.RandomState(0)
    img = rng.rand(DYGRAPH_RESNET_BATCH, *RESNET_IMAGE).astype(np.float32)
    label = rng.randint(0, RESNET_CLASSES, (DYGRAPH_RESNET_BATCH, 1))
    t0 = time.perf_counter()
    with dg.guard():
        model = make_dygraph_resnet(dg, ptt.layers, RESNET_CLASSES)
        inputs = (dg.to_variable(img), dg.to_variable(label))
        bounds = [e * RESNET_STEPS_PER_EPOCH for e in (30, 60, 90)]
        opt = ptt.optimizer.Momentum(
            learning_rate=dg.PiecewiseDecay(bounds, list(DYGRAPH_RESNET_LRS)),
            momentum=0.9, regularization=ptt.regularizer.L2Decay(1e-4))

        def step():
            return _dygraph_step(model, opt, inputs)

        with dg.no_grad():
            model(*inputs)  # FC's weights are made on the first call
        stats = {n: p for n, p in model.named_parameters()
                 if not p.trainable}
        start = {n: p.numpy() for n, p in stats.items()}
        runs = _dygraph_run(torch, step, DYGRAPH_WARMUP + DYGRAPH_STEPS)
        with dg.no_grad():
            train_mode = float(model(*inputs).numpy())
            model.eval()
            trained = {n: p.numpy() for n, p in stats.items()}
            eval_mode = float(model(*inputs).numpy())
            model.train()
        after_eval = {n: p.numpy() for n, p in stats.items()}
        trainable = {p.name for p in model.parameters() if p.trainable}
        stat_names = {p.name for p in stats.values()}
        state_names = set(opt._dy_state)
    growth = _dygraph_gates("dygraph_resnet", runs)
    timed = runs[DYGRAPH_WARMUP:]
    step_ms = statistics.median(r[2] for r in timed)
    means = [n for n in stats if n.endswith("_mean")]
    moved = sum(not np.array_equal(start[n], trained[n]) for n in means)
    phase("dygraph_resnet", batch=DYGRAPH_RESNET_BATCH,
          image="x".join(map(str, RESNET_IMAGE)), classes=RESNET_CLASSES,
          params=len(trainable), stats=len(stats), steps=DYGRAPH_STEPS,
          step_ms_median=f"{step_ms:.3f}",
          host_ms_median=f"{statistics.median(r[1] for r in timed):.3f}",
          images_per_s=f"{DYGRAPH_RESNET_BATCH / (step_ms / 1e3):.1f}",
          losses=",".join(f"{r[0]:.4f}" for r in runs),
          train_mode_loss=f"{train_mode:.4f}", eval_loss=f"{eval_mode:.4f}",
          means_moved=f"{moved}/{len(means)}",
          peak_gb=",".join(f"{r[3]:.3f}" for r in runs),
          peak_growth=f"{growth:.4f}",
          seconds=f"{time.perf_counter() - t0:.2f}", card=f"'{card}'")
    check(moved == len(means) and all(np.isfinite(v).all()
                                      for v in trained.values()),
          f"[dygraph_resnet] {moved} of {len(means)} running means moved")
    check(train_mode != eval_mode, "[dygraph_resnet] eval() gives the "
          "train-mode loss: the running statistics were not read")
    check(all(np.array_equal(trained[n], after_eval[n]) for n in stats),
          "[dygraph_resnet] eval() changed the running statistics")
    check(state_names == trainable and not state_names & stat_names,
          f"[dygraph_resnet] optimizer state for {len(state_names)} "
          f"parameters ({len(state_names & stat_names)} running "
          f"statistics); {len(trainable)} trainable")


def dygraph_layer_cases(rng):
    """The 18 dygraph.nn layers at small shapes, for [dygraph_layers] and
    the CPU parity tests: (name, make(dg) -> layer, inputs as (numpy
    array, takes a gradient)). NCE and Dropout draw random numbers:
    dygraph_nce_run and check_dropout check them."""
    import numpy as np

    def f32(*shape):
        return rng.randn(*shape).astype(np.float32)

    edges = np.array([[[1, 2], [1, 3], [2, 4], [2, 5], [0, 0]]],
                     dtype=np.int64)
    return [
        ("Conv2D", lambda dg: dg.Conv2D(num_channels=3, num_filters=4,
                                        filter_size=3, padding=1,
                                        act="relu"),
         [(f32(2, 3, 8, 8), True)]),
        ("Pool2D", lambda dg: dg.Pool2D(pool_size=2, pool_type="avg",
                                        pool_stride=2),
         [(f32(2, 3, 8, 8), True)]),
        ("FC", lambda dg: dg.FC(size=5, num_flatten_dims=1, act="tanh"),
         [(f32(3, 4, 2), True)]),
        ("Linear", lambda dg: dg.Linear(6, 4, act="sigmoid"),
         [(f32(3, 6), True)]),
        ("BatchNorm", lambda dg: dg.BatchNorm(num_channels=3, act="relu"),
         [(f32(4, 3, 5, 5), True)]),
        ("Embedding", lambda dg: dg.Embedding(size=[11, 6]),
         [(rng.randint(0, 11, (3, 4)).astype(np.int64), False)]),
        ("LayerNorm", lambda dg: dg.LayerNorm(normalized_shape=6),
         [(f32(3, 4, 6), True)]),
        ("Dropout", lambda dg: dg.Dropout(p=0.3), [(f32(64, 64), True)]),
        ("GroupNorm", lambda dg: dg.GroupNorm(channels=6, groups=3),
         [(f32(2, 6, 4, 4), True)]),
        ("PRelu", lambda dg: dg.PRelu(mode="channel", channel=3),
         [(f32(2, 3, 4, 4), True)]),
        ("Conv3D", lambda dg: dg.Conv3D(num_channels=2, num_filters=3,
                                        filter_size=3, padding=1),
         [(f32(1, 2, 4, 4, 4), True)]),
        ("Conv2DTranspose", lambda dg: dg.Conv2DTranspose(
            num_channels=2, num_filters=3, filter_size=3, stride=2,
            output_size=[12, 12]), [(f32(1, 2, 5, 5), True)]),
        ("Conv3DTranspose", lambda dg: dg.Conv3DTranspose(
            num_channels=2, num_filters=3, filter_size=2, stride=2),
         [(f32(1, 2, 3, 3, 3), True)]),
        ("GRUUnit", lambda dg: dg.GRUUnit(size=12),
         [(f32(2, 12), True), (f32(2, 4), True)]),
        ("NCE", lambda dg: dg.NCE(num_total_classes=20, dim=6,
                                  num_neg_samples=5),
         [(f32(4, 6), True),
          (rng.randint(0, 20, (4, 1)).astype(np.int64), False)]),
        ("BilinearTensorProduct", lambda dg: dg.BilinearTensorProduct(
            size=3, x_dim=4, y_dim=5),
         [(f32(2, 4), True), (f32(2, 5), True)]),
        ("SpectralNorm", lambda dg: dg.SpectralNorm(
            weight_shape=[4, 3, 2], dim=1, power_iters=3),
         [(f32(4, 3, 2), True)]),
        ("TreeConv", lambda dg: dg.TreeConv(output_size=4, num_filters=2,
                                            max_depth=3),
         [(f32(1, 6, 5), True), (edges, False)]),
    ]


def _set_up_layer(dg, make, arrays, state, carry):
    """The layer and its input vars in the current guard: one forward
    without gradients (FC and TreeConv make their weights on the first
    call), then `state` carried in (`carry(state, layer)`), or taken
    from the layer where it is None. Returns (layer, vars, state)."""
    layer = make(dg)
    xs = [dg.to_variable(a) for a, _ in arrays]
    for x, (_, differentiable) in zip(xs, arrays):
        x.stop_gradient = not differentiable
    with dg.no_grad():
        layer(*xs)
    if state is None:
        state = layer.state_dict()
    else:
        carry(state, layer)
    return layer, xs, state


def dygraph_layer_run(dg, make, arrays, place, state=None,
                      carry=lambda state, layer: layer.set_dict(state)):
    """One forward and backward of a layer of dygraph_layer_cases on
    `place` (the package `dg`'s guard; the JAX package ignores it),
    from `state` (None: the layer's own), the loss the sum of its
    floating outputs' mean squares. Returns {"state": the state it
    started from, "out": outputs, "grad": trainable parameters'
    gradients, "in_grad": differentiable inputs' gradients, "after":
    the state after the step}, as numpy."""
    import numpy as np
    with dg.guard(place):
        layer, xs, state = _set_up_layer(dg, make, arrays, state, carry)
        outs = layer(*xs)
        outs = outs if isinstance(outs, (list, tuple)) else [outs]
        loss = None
        for o in outs:
            if np.issubdtype(o.numpy().dtype, np.floating):
                term = (o * o).mean()
                loss = term if loss is None else loss + term
        loss.backward()
        return {"state": state, "out": [o.numpy() for o in outs],
                "grad": {n: p.gradient() for n, p in layer.named_parameters()
                         if p.trainable},
                "in_grad": [x.gradient() for x in xs if not x.stop_gradient],
                "after": layer.state_dict()}


def dygraph_nce_run(dg, make, arrays, place, state=None,
                    carry=lambda state, layer: layer.set_dict(state)):
    """The NCE case of dygraph_layer_cases on `place`: the nce op run
    through trace_op on the layer's parameters, for its negatives
    (SampleLabels) beside its cost; backward from the cost's sum.
    Returns {"state", "cost", "ids", "grad": {Input, weight, bias}}."""
    with dg.guard(place):
        layer, (x, label), state = _set_up_layer(dg, make, arrays, state,
                                                 carry)
        outs = dg.trace_op("nce", {"Input": [x], "Label": [label],
                                   "Weight": [layer.weight],
                                   "Bias": [layer.bias]}, layer._attrs)
        outs["Cost"][0].sum().backward()
        return {"state": state, "cost": outs["Cost"][0].numpy(),
                "ids": outs["SampleLabels"][0].numpy(),
                "grad": {"Input": x.gradient(),
                         "weight": layer.weight.gradient(),
                         "bias": layer.bias.gradient()}}


def nce_formula(x, w, b, ids):
    """NCE's cost on the negatives `ids` ([B, 1 + n], the true class
    first) and its gradients in x, w and b, in plain torch on the CPU:
    logits x · w[id] + b[id] less log(n / total) (total: w's rows), the
    logistic loss with the true class positive. Returns (cost [B, 1],
    {Input, weight, bias}) as numpy."""
    import numpy as np
    import torch
    x, w, b = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    ids = torch.tensor(np.asarray(ids)).long()
    logits = torch.einsum("bd,bkd->bk", x, w[ids]) + b[ids] \
        - math.log((ids.shape[1] - 1) / w.shape[0])
    pos = torch.zeros_like(logits)
    pos[:, 0] = 1.0
    cost = torch.sum(torch.logaddexp(torch.zeros(()), logits)
                     - logits * pos, dim=1)
    cost.sum().backward()
    return cost.detach().numpy()[:, None], {
        "Input": x.grad.numpy(), "weight": w.grad.numpy(),
        "bias": b.grad.numpy()}


def check_dropout(run, x, p):
    """A Dropout(p) (downgrade_in_infer) step of dygraph_layer_run on
    `x`: each output is 0 or its input, the kept share within
    DYGRAPH_KEEP_TOL of 1 - p, and the input's gradient 2 * out / size
    (out * out averaged). Returns the kept share."""
    import numpy as np
    out, = run["out"]
    kept = out != 0
    check(np.array_equal(out[kept], x[kept]),
          "Dropout changed a value it kept")
    share = float(kept.mean())
    check(abs(share - (1 - p)) <= DYGRAPH_KEEP_TOL,
          f"Dropout({p}) kept {share} of the values")
    grad, = run["in_grad"]
    check(np.allclose(grad, 2 * out / out.size, rtol=1e-6, atol=0),
          "Dropout's input gradient is not the kept mask's")
    return share


def max_gap(got, want):
    """The largest |got - want| / max(1, max|want|) over matching
    entries of two nested lists / dicts of arrays (None equal to None)."""
    import numpy as np
    if isinstance(want, dict):
        check(set(got) == set(want), f"keys {sorted(got)} != "
              f"{sorted(want)}")
        return max([max_gap(got[k], want[k]) for k in want] or [0.0])
    if isinstance(want, (list, tuple)):
        check(len(got) == len(want), "lengths differ")
        return max([max_gap(a, b) for a, b in zip(got, want)] or [0.0])
    if want is None or got is None:
        check(want is None and got is None, "a gradient is missing")
        return 0.0
    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape, f"shapes {got.shape} != {want.shape}")
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    return float(np.abs(got.astype(np.float64) - want).max() / scale) \
        if want.size else 0.0


def dygraph_layers_phase(torch, card):
    """[dygraph_layers]: each of the 18 dygraph.nn layers
    (dygraph_layer_cases) forward and backward on the card against the
    CPU port from one state dict (the CPU's, carried by
    convert.layer_from_numpy): outputs, parameter and input gradients
    and the state after the step (a BatchNorm's running statistics)
    within DYGRAPH_LAYER_TOL of max(1, max|CPU|). NCE against
    nce_formula on the card's own negatives; Dropout by check_dropout."""
    import numpy as np
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.dygraph as dg
    from paddle_tpu_torch.convert import layer_from_numpy

    t0 = time.perf_counter()
    gaps = {}
    for name, make, arrays in dygraph_layer_cases(np.random.RandomState(7)):
        if name == "NCE":
            run = dygraph_nce_run(dg, make, arrays, ptt.CUDAPlace(0))
            st = run["state"]
            cost, grads = nce_formula(arrays[0][0], st["weight"],
                                      st["bias"], run["ids"])
            gaps[name] = max(max_gap(run["cost"], cost),
                             max_gap(run["grad"], grads))
        elif name == "Dropout":
            run = dygraph_layer_run(dg, make, arrays, ptt.CUDAPlace(0))
            gaps[name] = 0.0
            keep = check_dropout(run, arrays[0][0], 0.3)
        else:
            cpu = dygraph_layer_run(dg, make, arrays, ptt.CPUPlace())
            card_run = dygraph_layer_run(dg, make, arrays, ptt.CUDAPlace(0),
                                         cpu["state"], layer_from_numpy)
            gaps[name] = max_gap({k: card_run[k] for k in
                                  ("out", "grad", "in_grad", "after")},
                                 {k: cpu[k] for k in
                                  ("out", "grad", "in_grad", "after")})
    worst = max(gaps, key=gaps.get)
    phase("dygraph_layers", layers=len(gaps), max_gap=f"{gaps[worst]:.3e}",
          worst=worst, tol=DYGRAPH_LAYER_TOL, dropout_kept=f"{keep:.4f}",
          **{f"{k}_gap": f"{v:.2e}" for k, v in gaps.items()
             if k != "Dropout"},
          seconds=f"{time.perf_counter() - t0:.2f}", card=f"'{card}'")
    check(len(gaps) == 18, f"[dygraph_layers] {len(gaps)} layers, not 18")
    check(gaps[worst] <= DYGRAPH_LAYER_TOL, f"[dygraph_layers] {worst}: "
          f"card vs CPU {gaps[worst]} > {DYGRAPH_LAYER_TOL}")


# -- slice 16: the input pipeline and the static-graph basics -------------

STARVED_STEPS = 4
READER_THREADS, READER_BUFFER = 4, 16  # xmap_readers(process_num, buffer)
MNIST_STEPS, MNIST_ACC_BAR, MNIST_SHUFFLE = 200, 0.7, 8192
CKPT_LOSS_TOL = 1e-6
DATA_LAYER_TOL = 1e-6
# ImageNet's per-channel mean and standard deviation, on the 0-255 scale
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)


def _bert_batches(vocab, batch, start, n):
    """A batch generator of n bench-shaped BERT batches: batch i (from
    `start`) is a fresh RandomState(i) draw of tokens, labels = tokens."""
    import numpy as np

    def gen():
        for i in range(start, start + n):
            toks = np.random.RandomState(i).randint(
                0, vocab, (batch, T)).astype(np.int64)
            yield toks, toks
    return gen


def _goodput_waits(snap):
    """Each step's input wait in ms, from the goodput waterfall."""
    return [r["input_wait_s"] * 1e3 for r in snap["step_records"]]


class _Hooks:
    """FLAGS_enable_goodput and FLAGS_enable_monitor (and a fault spec)
    on for a with-block around one goodput run; the flags, stats and
    ledger put back after it, whether the block passed or raised."""

    def __init__(self, label, fault_spec=""):
        self.label, self.fault_spec = label, fault_spec

    def __enter__(self):
        import paddle_tpu_torch as ptt
        from paddle_tpu_torch import goodput, monitor
        ptt.set_flags({"enable_goodput": True, "enable_monitor": True,
                       "fault_spec": self.fault_spec})
        monitor.reset_stats()
        goodput.start_run(self.label)
        return self

    def __exit__(self, *exc):
        import paddle_tpu_torch as ptt
        from paddle_tpu_torch import goodput, monitor
        ptt.set_flags({"enable_goodput": False, "enable_monitor": False,
                       "fault_spec": ""})
        goodput.reset()
        monitor.reset_stats()
        return False

    def end(self):
        from paddle_tpu_torch import goodput, monitor
        return goodput.end_run(), monitor.get_stats_snapshot()


def loader_bert_phase(torch, card, train_info):
    """[loader_bert]: [train]'s BERT-base step (b32, T512, bf16 AMP,
    AdamW, dropout 0.1) fed by fluid.io.DataLoader.from_generator over
    the program's data vars (capacity 2) and set_batch_generator, each
    batch a fresh RandomState(step) draw; 3 warm-up and 10 timed steps
    through run_steps with FLAGS_enable_goodput on. Gates: run_steps'
    (flash 12 / 12 / 12 a step, no cache miss after the first step,
    finite losses), reader.batches equal to the steps run, the goodput
    ledger summing to its wall clock within 5%, and the losses equal to
    those of the same program fed the same arrays directly, from the
    same startup state in a fresh scope (max |diff| 0; where a second
    direct run differs from the first, their gap is the bar), both runs
    under torch's deterministic algorithms. Prints
    host and device ms a step beside [train]'s and the input wait's p50
    and max. Returns (the timed steps' launches, what [loader_starved]
    runs on)."""
    import statistics

    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import goodput
    from paddle_tpu_torch.models import transformer

    batch, warmup, steps, symbols, _ = TRAIN_RUNS[True]
    cfg = transformer.bert_base(dropout=0.1, attn_dropout=0.0,
                                use_flash=True)
    main, startup, loss = _build_train(ptt, transformer, cfg, batch, True)
    scope = ptt.Scope()
    ptt.Executor().run(startup, scope=scope)
    init = {n: scope.get(n).clone() for n in scope.names()}
    blk = main.global_block()
    n_batches = warmup + steps + 1  # and run_steps' profiled step

    def direct():
        """The warm-up and timed steps' losses fed directly, from the
        startup state in a fresh scope and executor."""
        sc = ptt.Scope()
        for n, t in init.items():
            sc.set(n, t.clone())
        ex = ptt.Executor()
        return [float(ex.run(main, feed={"tokens": a, "labels": b},
                             fetch_list=[loss], scope=sc,
                             return_numpy=False)[0])
                for a, b in _bert_batches(cfg.vocab_size, batch, 0,
                                          warmup + steps)()]

    loader = ptt.io.DataLoader.from_generator(
        feed_list=[blk.var("tokens"), blk.var("labels")], capacity=2)
    loader.set_batch_generator(
        _bert_batches(cfg.vocab_size, batch, 0, n_batches))
    exe = ptt.Executor()
    # the embedding gradient's index_add sums by atomics unless torch's
    # deterministic algorithms are on; on, two runs of one feed agree
    # bit for bit, so the loader's feed can be held to the direct one
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with _Hooks("loader_bert") as hooks:
            batches = iter(loader)
            run = run_steps(torch, card, "loader_bert", exe, main, scope,
                            lambda: next(batches), loss, cfg.n_layers,
                            warmup, steps, symbols, batch * T,
                            model_flops_per_token(cfg, T), BF16_FLOPS)
            snap, stats = hooks.end()
        check(next(batches, None) is None,
              "[loader_bert] the loader yielded a batch more")
        fed = direct()
        gap = max(abs(a - b) for a, b in zip(run.losses, fed))
        bar = max(abs(a - b) for a, b in zip(direct(), fed)) if gap else 0.0
    finally:
        torch.use_deterministic_algorithms(was)

    waits = _goodput_waits(snap)
    cats = snap["categories"]
    phase("loader_bert", steps=steps, host_ms_median=f"{run.host_ms:.3f}",
          train_host_ms=f"{train_info['host_ms']:.3f}",
          device_ms=f"{run.device_ms:.3f}",
          train_device_ms=f"{train_info['device_ms']:.3f}",
          input_wait_ms_p50=f"{statistics.median(waits):.3f}",
          input_wait_ms_max=f"{max(waits):.3f}",
          reader_batches=stats["counters"].get("reader.batches"),
          loss_gap_vs_direct=f"{gap:.3e}", direct_run_gap=f"{bar:.3e}",
          deterministic_algorithms=True,
          **{f"goodput_{k}_s": f"{v:.3f}" for k, v in cats.items()},
          sum_frac_err=snap["sum_frac_err"], card=f"'{card}'")
    check(gap <= bar, f"[loader_bert] losses differ from the direct-fed "
          f"run by {gap} (two direct runs by {bar})")
    check(stats["counters"].get("reader.batches") == n_batches,
          f"[loader_bert] reader.batches "
          f"{stats['counters'].get('reader.batches')} != {n_batches}")
    check(goodput.check_invariant(snap, 0.05),
          f"[loader_bert] goodput categories do not sum to the wall clock "
          f"(sum_frac_err {snap['sum_frac_err']})")
    return run.launches, {"exe": exe, "main": main, "scope": scope,
                          "loss": loss, "loader": loader, "cfg": cfg,
                          "batch": batch, "next": n_batches,
                          "host_ms": run.host_ms}


def loader_starved_phase(torch, card, ctx):
    """[loader_starved]: [loader_bert]'s loader and program for
    STARVED_STEPS more steps under FLAGS_fault_spec=slow_step:ms=<2 x
    [loader_bert]'s median host step>:site=reader, a slow data source.
    Gates: input_wait is the largest goodput category, and every batch
    counts as starved (goodput_starved_ms 50)."""
    import statistics

    from paddle_tpu_torch.resilience import faults

    stall_ms = 2 * ctx["host_ms"]
    ctx["loader"].set_batch_generator(_bert_batches(
        ctx["cfg"].vocab_size, ctx["batch"], ctx["next"], STARVED_STEPS))
    t0 = time.perf_counter()
    with _Hooks("loader_starved",
                f"slow_step:ms={stall_ms:.1f}:site=reader") as hooks:
        losses = [float(ctx["exe"].run(
            ctx["main"], feed=feed, fetch_list=[ctx["loss"]],
            scope=ctx["scope"], return_numpy=False)[0])
            for feed in ctx["loader"]]
        snap, stats = hooks.end()
    faults.reset_injector()
    cats = snap["categories"]
    top = max(cats, key=cats.get)
    waits = _goodput_waits(snap)
    phase("loader_starved", steps=len(losses), stall_ms=f"{stall_ms:.1f}",
          input_wait_ms_p50=f"{statistics.median(waits):.3f}",
          largest=top, starved_steps=snap["starved_steps"],
          input_batches=snap["input_batches"],
          **{f"goodput_{k}_s": f"{v:.3f}" for k, v in cats.items()},
          seconds=f"{time.perf_counter() - t0:.2f}", card=f"'{card}'")
    check(len(losses) == STARVED_STEPS and
          all(math.isfinite(x) for x in losses),
          f"[loader_starved] losses {losses}")
    check(top == "input_wait", f"[loader_starved] the largest goodput "
          f"category is {top}, not input_wait: {cats}")
    check(snap["starved_steps"] == snap["input_batches"] == STARVED_STEPS,
          f"[loader_starved] {snap['starved_steps']} of "
          f"{snap['input_batches']} batches starved, not {STARVED_STEPS}")


def _imagenet_samples(n, seed):
    """A sample reader of n ImageNet-shaped samples as a decoder gives
    them: a uint8 3x224x224 image and an int label, from
    RandomState(seed)."""
    import numpy as np

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            yield (rng.randint(0, 256, RESNET_IMAGE, dtype=np.uint8),
                   int(rng.randint(0, RESNET_CLASSES)))
    return reader


def _normalize(sample):
    """Per-sample preprocessing: the image to float32, less the channel
    mean, over the channel deviation (a 602 KB float32 sample)."""
    import numpy as np
    img, label = sample
    mean = np.asarray(IMAGENET_MEAN, np.float32).reshape(3, 1, 1)
    std = np.asarray(IMAGENET_STD, np.float32).reshape(3, 1, 1)
    return (img.astype(np.float32) - mean) / std, label


def _build_reader_resnet(ptt):
    """ResNet-50 as resnet.build_train builds it (bf16 AMP, Momentum lr
    0.1, momentum 0.9), its image and label from
    read_file(double_buffer(py_reader(...)))."""
    from paddle_tpu_torch.contrib import mixed_precision as mp
    from paddle_tpu_torch.models import resnet
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        reader = ptt.layers.py_reader(
            capacity=4, shapes=[[-1, *RESNET_IMAGE], [-1, 1]],
            dtypes=["float32", "int64"], name="imagenet")
        img, label = ptt.layers.read_file(ptt.layers.double_buffer(reader))
        logits = resnet.resnet(img, RESNET_CLASSES, 50)
        loss = ptt.layers.mean(
            ptt.layers.softmax_with_cross_entropy(logits, label))
        ptt.layers.accuracy(ptt.layers.softmax(logits), label)
        mp.decorate(ptt.optimizer.Momentum(0.1, 0.9)).minimize(loss)
    return main, startup, loss, reader


def reader_resnet_phase(torch, card, resnet_info):
    """[reader_resnet]: ResNet-50 at bench.py's b64 3x224x224 bf16 AMP
    Momentum step over a py_reader, fed by decorate_sample_list_generator
    from io.batch(reader_decorator.xmap_readers(_normalize,
    _imagenet_samples, 4, 16, order=True), 64, drop_last=True), so
    DataFeeder stacks 64 float32 samples of 602 KB a batch; 3 warm-up
    and 10 timed steps through run_steps with goodput on. Gates:
    run_steps' (finite losses, no cache miss after the first step), one
    executor cache entry, and the first batch equal to np.stack of its
    64 samples. Prints host and device ms beside [resnet_train]'s and
    the input wait's p50."""
    import statistics

    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import resnet

    main, startup, loss, reader = _build_reader_resnet(ptt)
    scope = ptt.Scope()
    ptt.Executor().run(startup, scope=scope)
    n_batches = 3 + 10 + 1
    rd = ptt.reader_decorator
    reader.decorate_sample_list_generator(ptt.io.batch(
        rd.xmap_readers(_normalize,
                        _imagenet_samples(RESNET_BATCH * n_batches, 0),
                        READER_THREADS, READER_BUFFER, order=True),
        RESNET_BATCH, drop_last=True))
    exe = ptt.Executor()
    first = []

    def next_feed():
        feed = next(batches)
        if not first:
            first.append(feed)
        return feed

    with _Hooks("reader_resnet") as hooks:
        batches = iter(reader)
        run = run_steps(
            torch, card, "reader_resnet", exe, main, scope, next_feed, loss,
            0, 3, 10, (), RESNET_BATCH,
            3 * resnet.flops_per_image(50, RESNET_IMAGE[1], RESNET_CLASSES),
            BF16_FLOPS, unit="images", must_fall=False,
            classes=("conv", "matmul", "norm", "other"))
        snap, stats = hooks.end()
    samples = [_normalize(s) for s in _imagenet_samples(RESNET_BATCH, 0)()]
    img, label = (v.name for v in reader.feed_list)
    same = np.array_equal(first[0][img], np.stack([s[0] for s in samples])) \
        and np.array_equal(first[0][label],
                           np.array([[s[1]] for s in samples], np.int64))
    waits = _goodput_waits(snap)
    phase("reader_resnet", steps=10, host_ms_median=f"{run.host_ms:.3f}",
          resnet_train_host_ms=f"{resnet_info['host_ms']:.3f}",
          device_ms=f"{run.device_ms:.3f}",
          resnet_train_device_ms=f"{resnet_info['device_ms']:.3f}",
          input_wait_ms_p50=f"{statistics.median(waits):.3f}",
          input_wait_ms_max=f"{max(waits):.3f}",
          batch_mb=f"{first[0][img].nbytes / 1e6:.1f}",
          reader_batches=stats["counters"].get("reader.batches"),
          cache_entries=exe.cache_stats()["size"],
          sum_frac_err=snap["sum_frac_err"], card=f"'{card}'")
    check(same, "[reader_resnet] the first batch is not np.stack of its "
          "samples")
    check(exe.cache_stats()["size"] == 1,
          f"[reader_resnet] {exe.cache_stats()['size']} cache entries")


def mnist_book_phase(torch, card):
    """[mnist_book]: examples/train_mnist.py's path through the port:
    LeNet (convolutional_neural_network, Adam 1e-3, b128) on
    datasets.mnist.train() through reader_decorator.shuffle, io.batch
    and DataLoader.set_sample_list_generator, the loader iterated afresh
    each epoch, for MNIST_STEPS steps; metrics.Accuracy fed each step's
    fetched accuracy over the last 50 steps must exceed 0.7 (the JAX
    package's bar for this corpus). Then checkpoints: io.save and
    io.load into a fresh Scope, after which two more steps give the
    continuing run's losses within 1e-6; save_params and load_params
    into a fresh startup scope, whose for_test loss on a test batch
    equals the trained scope's within 1e-6."""
    import random

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import lenet

    random.seed(SEED)
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        img = ptt.layers.data("img", shape=[1, 28, 28], dtype="float32")
        label = ptt.layers.data("label", shape=[1], dtype="int64")
        loss, predict = lenet.convolutional_neural_network(img, label)
        acc = ptt.layers.accuracy(predict, label)
        ptt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    scope = ptt.Scope()
    exe = ptt.Executor()  # the card
    exe.run(startup, scope=scope)
    mnist = ptt.datasets.mnist
    loader = ptt.io.DataLoader.from_generator(feed_list=[img, label],
                                              capacity=8)
    loader.set_sample_list_generator(ptt.io.batch(
        ptt.reader_decorator.shuffle(mnist.train(), MNIST_SHUFFLE),
        LENET_BATCH, drop_last=True))
    last50 = ptt.metrics.Accuracy()
    t0 = time.perf_counter()
    step = epochs = 0
    losses = []
    while step < MNIST_STEPS:
        epochs += 1
        for feed in loader:
            lv, av = exe.run(main, feed=feed, fetch_list=[loss, acc],
                             scope=scope)
            step += 1
            losses.append(float(lv.reshape(-1)[0]))
            if step > MNIST_STEPS - 50:
                last50.update(float(av.reshape(-1)[0]), LENET_BATCH)
            if step >= MNIST_STEPS:
                break
    seconds = time.perf_counter() - t0
    acc50 = last50.eval()

    feeder = ptt.DataFeeder([img, label])
    test = [feeder.feed(b) for _, b in zip(range(2), ptt.io.batch(
        mnist.test(), LENET_BATCH)())]
    test_prog = main.clone(for_test=True)
    with tempfile.TemporaryDirectory(prefix="ptt_ckpt_") as d:
        path = os.path.join(d, "lenet")
        with ptt.scope_guard(scope):
            ptt.io.save(main, path)
            ptt.io.save_params(exe, os.path.join(d, "params"), main)
        loaded = ptt.Scope()
        with ptt.scope_guard(loaded):
            ptt.io.load(main, path, exe)
        params = ptt.Scope()
        exe.run(startup, scope=params)
        with ptt.scope_guard(params):
            ptt.io.load_params(exe, os.path.join(d, "params"), main)
    eval_gap = abs(
        float(exe.run(test_prog, feed=test[0], fetch_list=[loss],
                      scope=params)[0].reshape(-1)[0]) -
        float(exe.run(test_prog, feed=test[0], fetch_list=[loss],
                      scope=scope)[0].reshape(-1)[0]))
    ckpt_gap = max(abs(float(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=loaded)[0].reshape(-1)[0]) -
                       float(exe.run(main, feed=f, fetch_list=[loss],
                                     scope=scope)[0].reshape(-1)[0]))
                   for f in test)
    phase("mnist_book", steps=step, epochs=epochs, batch=LENET_BATCH,
          acc_last50=f"{acc50:.4f}", loss_first=f"{losses[0]:.4f}",
          loss_last=f"{losses[-1]:.4f}",
          images_per_s=f"{step * LENET_BATCH / seconds:.1f}",
          ckpt_loss_gap=f"{ckpt_gap:.3e}",
          params_eval_loss_gap=f"{eval_gap:.3e}",
          seconds=f"{seconds:.2f}", card=f"'{card}'")
    check(step == MNIST_STEPS and epochs == 4,
          f"[mnist_book] {step} steps over {epochs} epochs")
    check(acc50 > MNIST_ACC_BAR, f"[mnist_book] accuracy over the last 50 "
          f"steps {acc50} <= {MNIST_ACC_BAR}")
    check(ckpt_gap <= CKPT_LOSS_TOL, f"[mnist_book] io.load: loss differs "
          f"from the continuing run's by {ckpt_gap}")
    check(eval_gap <= CKPT_LOSS_TOL, f"[mnist_book] load_params: loss "
          f"differs from the trained scope's by {eval_gap}")


def _dl_x(ptt, shape=(2, 3, 8, 8)):
    x = ptt.layers.data("x", list(shape[1:]), dtype="float32")
    x.stop_gradient = False
    return x


def _dl_loss(ptt, *outs):
    loss = ptt.layers.mean(outs[0])
    for o in outs[1:]:
        loss = loss + ptt.layers.mean(o)
    ptt.backward.append_backward(loss)


def data_layer_cases():
    """[data_layers]' cases: {name: (build(ptt) -> fetch vars, the names
    of the vars whose gradients are fetched too, x's shape or None)}."""
    import numpy as np

    def arg(ptt):
        x = _dl_x(ptt)
        return [ptt.layers.argmax(x, axis=1), ptt.layers.argmin(x, axis=-1),
                ptt.layers.argmax(x)]

    def fills(ptt):
        x = _dl_x(ptt)
        return [ptt.layers.fill_constant_batch_size_like(
                    x, [-1, 5], "float32", 2.5),
                ptt.layers.fill_constant_batch_size_like(
                    x, [4, -1], "int64", 7, input_dim_idx=1,
                    output_dim_idx=1),
                ptt.layers.zeros_like(x), ptt.layers.ones_like(x),
                ptt.layers.ones([2, 3], "float32"),
                ptt.layers.zeros([4], "int64")]

    def ranges(ptt):
        return [ptt.layers.linspace(-3.5, 11.25, 33, "float32"),
                ptt.layers.eye(3, 5), ptt.layers.eye(4, 2, dtype="int64"),
                ptt.layers.diag(ptt.layers.assign(
                    np.array([1.5, -2.0, 3.25], np.float32))),
                ptt.layers.assign(np.arange(6, dtype=np.int64)
                                  .reshape(2, 3))]

    def checks(ptt):
        # x is finite; sqrt(x) has NaNs (x < 0), x * 1e60 infinities
        x = _dl_x(ptt)
        nan = ptt.layers.sqrt(x)
        inf = ptt.layers.scale(ptt.layers.scale(x, 1e30), 1e30)
        return [ptt.layers.isfinite(x), ptt.layers.has_inf(x),
                ptt.layers.has_nan(x), ptt.layers.isfinite(nan),
                ptt.layers.has_nan(nan), ptt.layers.has_inf(inf),
                ptt.layers.has_nan(inf)]

    def reverse_diag(ptt):
        x = _dl_x(ptt)
        r1, r2 = ptt.layers.reverse(x, 1), ptt.layers.reverse(x, [2, 3])
        v = ptt.layers.reshape(ptt.layers.slice(
            x, [1, 2, 3], [0, 0, 0], [1, 1, 1]), [-1])
        d = ptt.layers.diag(v)
        _dl_loss(ptt, r1 * r1, r2, d * d)
        return [r1, r2, d]

    def create(ptt):
        t = ptt.layers.create_tensor("float32", name="t0")
        p = ptt.layers.create_parameter(
            [8, 4], "float32", name="p0",
            default_initializer=ptt.initializer.Constant(0.5))
        b = ptt.layers.create_parameter([4], "float32", is_bias=True)
        x = _dl_x(ptt, (2, 8))
        y = ptt.layers.elementwise_add(ptt.layers.matmul(x, p), b)
        ptt.layers.assign(y, t)
        _dl_loss(ptt, y * y)
        return [t, y]

    def adaptive(ptype):
        def build(ptt):
            x = _dl_x(ptt)
            a = ptt.layers.adaptive_pool2d(x, [2, 4], ptype)
            b = ptt.layers.adaptive_pool2d(x, 4, ptype)
            _dl_loss(ptt, a * a, b * b)
            return [a, b]
        return build

    def inits(ptt):
        init = ptt.initializer
        return [ptt.layers.create_parameter(
                    [2, 3, 4, 4], "float32", name="bl",
                    default_initializer=init.Bilinear()),
                ptt.layers.create_parameter(
                    [3, 4], "float32", name="na",
                    default_initializer=init.NumpyArrayInitializer(
                        np.linspace(-2, 2, 12).reshape(3, 4)))]

    return {"arg": (arg, (), (2, 3, 8, 8)),
            "fills": (fills, (), (2, 3, 8, 8)),
            "ranges": (ranges, (), None),
            "checks": (checks, (), (2, 3, 8, 8)),
            "reverse_diag": (reverse_diag, ("x",), (2, 3, 8, 8)),
            "create": (create, ("x", "p0.w_0"), (2, 8)),
            "adaptive_max": (adaptive("max"), ("x",), (2, 3, 8, 8)),
            "adaptive_avg": (adaptive("avg"), ("x",), (2, 3, 8, 8)),
            "inits": (inits, (), None)}


def data_layer_run(ptt, build, grads, shape, place, state=None):
    """One case's fetches (and gradients) on `place`: the startup run
    there, then its state replaced by `state` (numpy, when given), then
    one run of the program on x from RandomState(3). Returns (the fetched
    arrays, the startup state as numpy)."""
    import numpy as np
    from paddle_tpu_torch.convert import scope_from_numpy
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        fetch = build(ptt)
    exe = ptt.Executor(place)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    own = {n: scope.get_numpy(n) for n in scope.names()}
    if state is not None:
        scope_from_numpy(state, scope, place, program=main)
    feed = {} if shape is None else {"x": np.random.RandomState(3).randn(
        *shape).astype(np.float32)}
    names = [v.name for v in fetch] + [f"{n}@GRAD" for n in grads]
    return exe.run(main, feed=feed, fetch_list=names, scope=scope), own


def data_layer_gap(got, want):
    """The largest gap over the arrays: finite floats relative to max(1,
    max|want|), non-finite ones as 0 when equal; integers and bools as 0
    when equal; anything else inf."""
    import numpy as np
    worst = 0.0
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            return float("inf")
        if b.dtype.kind == "f":
            # non-finite values (unique's +inf padding) must be equal
            fin = np.isfinite(b)
            if not (np.array_equal(fin, np.isfinite(a)) and
                    np.array_equal(a[~fin], b[~fin])):
                return float("inf")
            worst = max(worst, float(np.abs(a[fin] - b[fin]).max(
                initial=0.0)) / max(1.0, float(np.abs(b[fin]).max(
                    initial=0.0))))
        elif not np.array_equal(a, b):
            return float("inf")
    return worst


def random_init_gaps(ptt, place):
    """TruncatedNormal(0.5, 0.02) and MSRA (uniform and normal) drawn by
    the startup program on `place`: (the largest |z| of the truncated
    draws in standard deviations, which must be <= 2, and each moment's
    relative gap to its closed form)."""
    import numpy as np
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        tn = ptt.layers.create_parameter(
            [512, 512], "float32", name="tn",
            default_initializer=ptt.initializer.TruncatedNormal(0.5, 0.02))
        mu = ptt.layers.create_parameter(
            [512, 512], "float32", name="mu",
            default_initializer=ptt.initializer.MSRA())
        mn = ptt.layers.create_parameter(
            [64, 32, 3, 3], "float32", name="mn",
            default_initializer=ptt.initializer.MSRA(uniform=False))
    scope = ptt.Scope()
    ptt.Executor(place).run(startup, scope=scope)
    z = (scope.get_numpy(tn.name).astype(np.float64) - 0.5) / 0.02
    trunc_std = math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                          / math.erf(2 / math.sqrt(2)))
    u = scope.get_numpy(mu.name).astype(np.float64)
    g = scope.get_numpy(mn.name).astype(np.float64)
    lim = math.sqrt(6.0 / 512)
    return float(np.abs(z).max()), {
        "trunc_std": abs(z.std() / trunc_std - 1),
        "trunc_mean": abs(z.mean()) / trunc_std,
        "msra_uniform_bound": float(np.abs(u).max()) / lim,
        "msra_uniform_std": abs(u.std() / (lim / math.sqrt(3)) - 1),
        "msra_normal_std": abs(g.std() / math.sqrt(2.0 / (32 * 9)) - 1)}


def data_layers_phase(torch, card):
    """[data_layers]: each new tensor layer and op type and adaptive
    pool2d (max and avg, with gradients) on the card against the port on
    the CPU from the CPU's startup state (data_layer_cases; floats within
    DATA_LAYER_TOL of max(1, max|CPU|), integers, indices and bools
    exact); the deterministic initializers (Bilinear, NumpyArray) equal;
    the random ones by distribution (random_init_gaps: the truncated
    normal inside 2 standard deviations, exactly, its mean and standard
    deviation, MSRA's bound and standard deviations); and the save_combine
    and load_combine ops round-tripping a card tensor through a file."""
    import numpy as np
    import paddle_tpu_torch as ptt

    t0 = time.perf_counter()
    gaps = {}
    for name, (build, grads, shape) in data_layer_cases().items():
        cpu, state = data_layer_run(ptt, build, grads, shape,
                                    ptt.CPUPlace())
        if name == "inits":  # the card's own startup, not the CPU's
            card_out, card_state = data_layer_run(ptt, build, grads, shape,
                                                  ptt.CUDAPlace(0))
            gaps[name] = data_layer_gap(
                [card_state[k] for k in sorted(state)],
                [state[k] for k in sorted(state)])
        else:
            card_out, _ = data_layer_run(ptt, build, grads, shape,
                                         ptt.CUDAPlace(0), state)
            gaps[name] = data_layer_gap(card_out, cpu)
    zmax, moments = random_init_gaps(ptt, ptt.CUDAPlace(0))
    with tempfile.TemporaryDirectory(prefix="ptt_io_ops_") as d:
        main = ptt.Program()
        blk = main.global_block()
        vals = {"a": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
                "b": np.arange(5, dtype=np.int64) - 2}
        for n, v in vals.items():
            blk.create_var(name=n, shape=list(v.shape), dtype=str(v.dtype),
                           is_data=True)
            blk.create_var(name=f"l{n}", shape=list(v.shape),
                           dtype=str(v.dtype))
        blk.create_var(name="tok", shape=[], dtype="int32")
        blk.append_op("save_combine", inputs={"X": ["a", "b"]},
                      outputs={"Out": ["tok"]},
                      attrs={"file_path": os.path.join(d, "ab"),
                             "var_names": ["a", "b"]}, infer_shape=False)
        blk.append_op("load_combine", inputs={}, outputs={"Out": ["la",
                                                                  "lb"]},
                      attrs={"file_path": os.path.join(d, "ab"),
                             "var_names": ["a", "b"],
                             "shapes": [[3, 4], [5]],
                             "dtypes": ["float32", "int64"]},
                      infer_shape=False)
        la, lb = ptt.Executor().run(main, feed=vals, fetch_list=["la", "lb"],
                                    scope=ptt.Scope())
    io_ok = np.array_equal(la, vals["a"]) and np.array_equal(lb, vals["b"])
    worst = max(gaps, key=gaps.get)
    phase("data_layers", cases=len(gaps), max_gap=f"{gaps[worst]:.3e}",
          worst=worst, tol=DATA_LAYER_TOL,
          **{f"{k}_gap": f"{v:.2e}" for k, v in gaps.items()},
          trunc_max_z=f"{zmax:.6f}",
          **{k: f"{v:.2e}" for k, v in moments.items()},
          io_ops_equal=io_ok, seconds=f"{time.perf_counter() - t0:.2f}",
          card=f"'{card}'")
    check(gaps[worst] <= DATA_LAYER_TOL, f"[data_layers] {worst}: card vs "
          f"CPU {gaps[worst]} > {DATA_LAYER_TOL}")
    check(zmax <= 2.0, f"[data_layers] a truncated normal draw at "
          f"{zmax} standard deviations")
    check(moments["msra_uniform_bound"] <= 1.0,
          "[data_layers] an MSRA draw outside its bound")
    for k in ("trunc_std", "trunc_mean", "msra_uniform_std",
              "msra_normal_std"):
        check(moments[k] < 0.02, f"[data_layers] {k} off by {moments[k]}")
    check(io_ok, "[data_layers] save_combine / load_combine round trip "
          "differs")


# --- slice 17: the dense layers' op types -----------------------------------

# the op types slice 17 adds (109): [dense_layers] runs each on the card
# and fails if one did not run
DENSE_OP_TYPES = (
    # math.py
    "unsqueeze2", "squeeze2", "flatten2", "reshape", "transpose", "squeeze",
    "unsqueeze", "flatten", "split", "stack", "unstack", "shape", "size",
    "strided_slice", "expand", "expand_as", "gather_nd", "scatter",
    "scatter_nd_add", "cumsum", "argsort", "l2_normalize", "norm", "pad",
    "pad2d", "cos_sim", "matmul_v2",
    # loss_ops.py
    "cross_entropy2", "sigmoid_cross_entropy_with_logits",
    "square_error_cost", "huber_loss", "smooth_l1_loss", "log_loss",
    "kldiv_loss", "hinge_loss", "rank_loss", "margin_rank_loss",
    "bpr_loss", "npair_loss", "dice_loss", "mse_loss", "center_loss",
    # activations.py
    "logsigmoid", "atan", "rsqrt", "acos", "sin", "asin", "round", "log",
    "relu6", "softplus", "softsign", "tanh_shrink", "elu", "leaky_relu",
    "brelu", "soft_relu", "stanh", "softshrink", "hard_shrink",
    "hard_sigmoid", "swish", "hard_swish", "thresholded_relu", "erf",
    "logical_not", "maxout",
    # elementwise.py
    "minus", "less_than", "greater_than", "greater_equal", "not_equal",
    "logical_and", "logical_or", "logical_xor",
    # reduce.py
    "reduce_prod", "reduce_all", "reduce_any",
    # nn_ops.py
    "log_softmax", "depthwise_conv2d", "max_pool2d_with_index",
    "instance_norm", "data_norm", "selu", "lrn", "pixel_shuffle",
    "space_to_depth", "temporal_shift", "shuffle_channel",
    "affine_channel", "unfold",
    # tensor_ops.py
    "uniform_random_batch_size_like", "randint", "sampling_id",
    "one_hot_v2", "is_empty", "where_index", "multiplex", "shard_index",
    # misc_ops.py, vision_extra.py and metrics_ops.py (part)
    "where", "unique", "unique_with_counts", "hash", "fsp", "pool3d",
    "max_pool3d_with_index", "grid_sampler", "auc")
# the random ones, held by their range and distribution, not by values
DENSE_RANDOM_OPS = ("uniform_random_batch_size_like", "randint",
                    "sampling_id")


def dense_op_cases():
    """One case for each op type of DENSE_OP_TYPES at a small shape:
    {op type: (inputs {slot: [numpy arrays]}, attrs, outputs {slot:
    count}, the input slots differentiated)}. Inputs come from
    RandomState(17), inside each op's domain and away from the points
    where an op's two frameworks' gradients may differ (a ReLU-like
    kink, a clip's edge)."""
    import numpy as np
    rng = np.random.RandomState(17)

    def f(*shape, lo=None, hi=None):
        if lo is not None:
            return rng.uniform(lo, hi, shape).astype(np.float32)
        return rng.randn(*shape).astype(np.float32)

    def i64(lo, hi, *shape):
        return rng.randint(lo, hi, shape).astype(np.int64)

    def b(*shape):
        return rng.rand(*shape) > 0.5

    def probs(*shape):
        e = np.exp(f(*shape))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    out, xs, x = {"Out": 1}, {"Out": 1, "XShape": 1}, ("X",)
    cases = {
        "unsqueeze2": ({"X": [f(2, 3, 4)]}, {"axes": [0, 2]}, xs, x),
        "squeeze2": ({"X": [f(2, 1, 3, 1)]}, {"axes": [1, 3]}, xs, x),
        "flatten2": ({"X": [f(2, 3, 4)]}, {"axis": 2}, xs, x),
        "reshape": ({"X": [f(2, 3, 4)]}, {"shape": [4, 6]}, out, x),
        "transpose": ({"X": [f(2, 3, 4)]}, {"axis": [2, 0, 1]}, out, x),
        "squeeze": ({"X": [f(2, 1, 3)]}, {"axes": []}, out, x),
        "unsqueeze": ({"X": [f(2, 3)]}, {"axes": [-1]}, out, x),
        "flatten": ({"X": [f(2, 3, 4)]}, {"axis": 1}, out, x),
        "split": ({"X": [f(2, 6, 3)]}, {"sections": [1, 2, 3], "axis": 1},
                  {"Out": 3}, x),
        "stack": ({"X": [f(2, 4), f(2, 4), f(2, 4)]}, {"axis": 1},
                  {"Y": 1}, x),
        "unstack": ({"X": [f(2, 3, 4)]}, {"axis": 1, "num": 3}, {"Y": 3},
                    x),
        "shape": ({"Input": [f(2, 3, 4)]}, {}, out, ()),
        "size": ({"Input": [f(2, 3, 4)]}, {}, out, ()),
        "strided_slice": ({"Input": [f(6, 8)]},
                          {"axes": [0, 1], "starts": [5, 1],
                           "ends": [0, 7], "strides": [-2, 3]}, out,
                          ("Input",)),
        "expand": ({"X": [f(2, 3)]}, {"expand_times": [2, 3]}, out, x),
        "expand_as": ({"X": [f(2, 3)], "target_tensor": [f(4, 6)]}, {},
                      out, x),
        "gather_nd": ({"X": [f(4, 5, 6)],
                       "Index": [np.array([[0, 1], [3, 4], [2, 0]],
                                          np.int32)]}, {}, out, x),
        "scatter": ({"X": [f(5, 4)],
                     "Ids": [np.array([3, 0, 4], np.int32)],
                     "Updates": [f(3, 4)]}, {"overwrite": True}, out,
                    ("X", "Updates")),
        "scatter_nd_add": ({"X": [f(4, 5)],
                            "Index": [np.array([[0, 1], [3, 4], [0, 1],
                                                [2, 2]], np.int32)],
                            "Updates": [f(4)]}, {}, out,
                           ("X", "Updates")),
        "cumsum": ({"X": [f(3, 5)]}, {"axis": 1, "exclusive": True,
                                      "reverse": True}, out, x),
        # ties: values on a grid of 4
        "argsort": ({"X": [np.round(f(3, 8)).astype(np.float32)]},
                    {"axis": 1, "descending": True},
                    {"Out": 1, "Indices": 1}, x),
        "l2_normalize": ({"X": [f(3, 5)]}, {"axis": 1, "epsilon": 1e-12},
                         {"Out": 1, "Norm": 1}, x),
        "norm": ({"X": [f(3, 5)]}, {"axis": 0, "epsilon": 1e-10},
                 {"Out": 1, "Norm": 1}, x),
        "pad": ({"X": [f(2, 3)]}, {"paddings": [1, 0, 2, 1],
                                   "pad_value": 0.5}, out, x),
        "pad2d": ({"X": [f(1, 2, 4, 5)]}, {"paddings": [1, 2, 2, 1],
                                           "mode": "reflect"}, out, x),
        "cos_sim": ({"X": [f(4, 6)], "Y": [f(1, 6)]}, {},
                    {"Out": 1, "XNorm": 1, "YNorm": 1}, ("X", "Y")),
        "matmul_v2": ({"X": [f(2, 3, 4)], "Y": [f(2, 5, 4)]},
                      {"trans_y": True}, out, ("X", "Y")),
        "cross_entropy2": ({"X": [probs(4, 5)], "Label": [i64(0, 5, 4, 1)]},
                           {}, {"Y": 1, "XShape": 1, "MatchX": 1}, x),
        "sigmoid_cross_entropy_with_logits": (
            {"X": [f(4, 5)],
             "Label": [np.where(rng.rand(4, 5) < 0.2, -100.0,
                                rng.rand(4, 5) > 0.5)
                       .astype(np.float32)]},
            {"ignore_index": -100, "normalize": True}, out, x),
        "square_error_cost": ({"X": [f(4, 3)], "Y": [f(4, 3)]}, {}, out,
                              ("X", "Y")),
        "huber_loss": ({"X": [f(6, 1)], "Y": [f(6, 1)]}, {"delta": 0.5},
                       {"Out": 1, "Residual": 1}, ("X", "Y")),
        "smooth_l1_loss": ({"X": [f(4, 3)], "Y": [f(4, 3)],
                            "InsideWeight": [f(4, 3, lo=0.5, hi=1.5)],
                            "OutsideWeight": [f(4, 3, lo=0.5, hi=1.5)]},
                           {"sigma": 2.0}, {"Out": 1, "Diff": 1},
                           ("X", "Y")),
        "log_loss": ({"Predicted": [f(5, 1, lo=0.05, hi=0.95)],
                      "Labels": [(rng.rand(5, 1) > 0.5)
                                 .astype(np.float32)]},
                     {"epsilon": 1e-4}, {"Loss": 1}, ("Predicted",)),
        "kldiv_loss": ({"X": [np.log(probs(3, 4))],
                        "Target": [probs(3, 4) * np.array(
                            [1, 0, 1, 1], np.float32)]},
                       {"reduction": "batchmean"}, {"Loss": 1}, x),
        "hinge_loss": ({"Logits": [f(5, 1)],
                        "Labels": [(rng.rand(5, 1) > 0.5)
                                   .astype(np.float32)]}, {},
                       {"Loss": 1}, ("Logits",)),
        "rank_loss": ({"Label": [(rng.rand(5, 1) > 0.5)
                                 .astype(np.float32)],
                       "Left": [f(5, 1)], "Right": [f(5, 1)]}, {}, out,
                      ("Left", "Right")),
        "margin_rank_loss": ({"Label": [np.sign(f(5, 1))],
                              "X1": [f(5, 1)], "X2": [f(5, 1)]},
                             {"margin": 0.1}, {"Out": 1, "Activated": 1},
                             ("X1", "X2")),
        "bpr_loss": ({"X": [f(4, 6)], "Label": [i64(0, 6, 4, 1)]}, {},
                     {"Y": 1}, x),
        "npair_loss": ({"Anchor": [f(4, 3)], "Positive": [f(4, 3)],
                        "Labels": [np.array([0, 1, 0, 2], np.float32)]},
                       {"l2_reg": 0.002}, out, ("Anchor", "Positive")),
        "dice_loss": ({"X": [probs(3, 4)],
                       "Label": [(rng.rand(3, 4) > 0.5)
                                 .astype(np.float32)]}, {}, out, x),
        "mse_loss": ({"X": [f(4, 3)], "Y": [f(4, 3)]}, {}, out,
                     ("X", "Y")),
        "center_loss": ({"X": [f(4, 3)], "Label": [i64(0, 5, 4, 1)],
                         "Centers": [f(5, 3)],
                         "CenterUpdateRate": [np.array([0.1], np.float32)]},
                        {"need_update": True},
                        {"Loss": 1, "SampleCenterDiff": 1,
                         "CentersOut": 1}, x),
        "minus": ({"X": [f(3, 4)], "Y": [f(3, 4)]}, {}, out, ("X", "Y")),
        "reduce_prod": ({"X": [f(2, 3, 4, lo=0.5, hi=1.5)]},
                        {"dim": [0, 2], "keep_dim": True}, out, x),
        "reduce_all": ({"X": [b(2, 3, 4)]}, {"dim": [1]}, out, ()),
        "reduce_any": ({"X": [b(2, 3, 4)]}, {"dim": [0],
                                             "reduce_all": True}, out, ()),
        "log_softmax": ({"X": [f(3, 5)]}, {"axis": 1}, out, x),
        "depthwise_conv2d": ({"Input": [f(2, 3, 6, 6)],
                              "Filter": [f(3, 1, 3, 3)]},
                             {"strides": [1, 1], "paddings": [1, 1],
                              "dilations": [1, 1], "groups": 3},
                             {"Output": 1}, ("Input", "Filter")),
        "max_pool2d_with_index": ({"X": [f(2, 3, 6, 6)]},
                                  {"ksize": [3, 3], "strides": [2, 2],
                                   "paddings": [1, 1]},
                                  {"Out": 1, "Mask": 1}, x),
        "instance_norm": ({"X": [f(2, 3, 4, 4)], "Scale": [f(3)],
                           "Bias": [f(3)]}, {"epsilon": 1e-5},
                          {"Y": 1, "SavedMean": 1, "SavedVariance": 1},
                          ("X", "Scale", "Bias")),
        "data_norm": ({"X": [f(4, 3)],
                       "BatchSize": [np.full(3, 100.0, np.float32)],
                       "BatchSum": [f(3) * 10],
                       "BatchSquareSum": [f(3, lo=50.0, hi=150.0)]}, {},
                      {"Y": 1, "Means": 1, "Scales": 1}, x),
        "selu": ({"X": [f(3, 5)]}, {}, out, x),
        "lrn": ({"X": [f(2, 6, 3, 3)]}, {"n": 5, "k": 2.0, "alpha": 1e-3,
                                         "beta": 0.75},
                {"Out": 1, "MidOut": 1}, x),
        "pixel_shuffle": ({"X": [f(1, 8, 3, 3)]}, {"upscale_factor": 2},
                          out, x),
        "space_to_depth": ({"X": [f(1, 2, 4, 6)]}, {"blocksize": 2}, out,
                           x),
        "temporal_shift": ({"X": [f(4, 8, 2, 2)]}, {"seg_num": 2,
                                                    "shift_ratio": 0.25},
                           out, x),
        "shuffle_channel": ({"X": [f(2, 6, 2, 2)]}, {"group": 3}, out, x),
        "affine_channel": ({"X": [f(2, 3, 4, 4)], "Scale": [f(3)],
                            "Bias": [f(3)]}, {}, out,
                           ("X", "Scale", "Bias")),
        "unfold": ({"X": [f(1, 2, 5, 5)]},
                   {"kernel_sizes": [2, 3], "strides": [1, 2],
                    "paddings": [1, 0, 0, 1], "dilations": [1, 1]},
                   {"Y": 1}, x),
        "uniform_random_batch_size_like": (
            {"Input": [f(6, 3)]}, {"shape": [-1, 500], "min": -2.0,
                                   "max": 3.0}, out, ()),
        "randint": ({}, {"shape": [40, 50], "low": -3, "high": 7}, out, ()),
        "sampling_id": ({"X": [probs(2000, 4)]}, {}, out, ()),
        "one_hot_v2": ({"X": [i64(-1, 5, 2, 3)]}, {"depth": 4}, out, ()),
        "is_empty": ({"X": [f(2, 3)]}, {}, out, ()),
        "where_index": ({"Condition": [b(3, 4)]}, {}, out, ()),
        "multiplex": ({"X": [f(4, 5), f(4, 5), f(4, 5)],
                       "Ids": [np.array([[2], [0], [1], [2]], np.int32)]},
                      {}, out, x),
        "shard_index": ({"X": [i64(0, 20, 5, 1)]},
                        {"index_num": 20, "nshards": 3, "shard_id": 1},
                        out, ()),
        "where": ({"Condition": [np.round(f(2, 3, 2))]}, {}, out, ()),
        "unique": ({"X": [i64(0, 4, 10)]}, {}, {"Out": 1, "Index": 1}, ()),
        "unique_with_counts": ({"X": [np.round(f(8))]}, {},
                               {"Out": 1, "Index": 1, "Count": 1}, ()),
        "hash": ({"X": [i64(0, 10 ** 6, 4, 2)]},
                 {"num_hash": 3, "mod_by": 1000}, out, ()),
        "fsp": ({"X": [f(2, 3, 4, 4)], "Y": [f(2, 5, 4, 4)]}, {}, out,
                ("X", "Y")),
        "pool3d": ({"X": [f(1, 2, 4, 4, 4)]},
                   {"ksize": [2, 2, 2], "strides": [2, 2, 2],
                    "paddings": [1, 1, 1], "pooling_type": "avg",
                    "exclusive": True}, out, x),
        "max_pool3d_with_index": ({"X": [f(1, 2, 4, 4, 4)]},
                                  {"ksize": [2, 2, 2],
                                   "strides": [1, 1, 1],
                                   "paddings": [0, 0, 0]},
                                  {"Out": 1, "Mask": 1}, x),
        # grid points on the corners, the edges and outside
        "grid_sampler": ({"X": [f(1, 2, 4, 5)],
                          "Grid": [np.concatenate([
                              np.array([[-1.0, -1.0], [1.0, 1.0],
                                        [1.0, -0.3], [-1.1, 0.2]],
                                       np.float32),
                              f(5, 2, lo=-1.2, hi=1.2)])
                              .reshape(1, 3, 3, 2)]}, {},
                         {"Output": 1}, ("X", "Grid")),
        "auc": ({"Predict": [np.stack([1 - (p := f(8, lo=0.0, hi=1.0)), p],
                                      1)],
                 "Label": [i64(0, 2, 8, 1)],
                 "StatPos": [np.zeros(16, np.int64)],
                 "StatNeg": [np.zeros(16, np.int64)]},
                {"num_thresholds": 15},
                {"AUC": 1, "StatPosOut": 1, "StatNegOut": 1}, ()),
    }
    acts = {"logsigmoid": {}, "atan": {}, "sin": {}, "round": {},
            "softplus": {}, "softsign": {}, "tanh_shrink": {},
            "elu": {"alpha": 0.5}, "leaky_relu": {"alpha": 0.1},
            "soft_relu": {"threshold": 1.5},
            "stanh": {"scale_a": 0.5, "scale_b": 1.5},
            "softshrink": {"lambda": 0.3}, "hard_shrink": {"threshold": 0.3},
            "hard_sigmoid": {"slope": 0.3, "offset": 0.4},
            "swish": {"beta": 1.5},
            "hard_swish": {"threshold": 5.0, "scale": 5.0, "offset": 2.0},
            "thresholded_relu": {"threshold": 0.4}, "erf": {}}
    for name, attrs in acts.items():
        cases[name] = ({"X": [f(3, 5) * 2]}, attrs, out, x)
    cases["rsqrt"] = ({"X": [f(3, 5, lo=0.2, hi=3.0)]}, {}, out, x)
    cases["log"] = ({"X": [f(3, 5, lo=0.2, hi=3.0)]}, {}, out, x)
    cases["acos"] = ({"X": [f(3, 5, lo=-0.9, hi=0.9)]}, {}, out, x)
    cases["asin"] = ({"X": [f(3, 5, lo=-0.9, hi=0.9)]}, {}, out, x)
    cases["relu6"] = ({"X": [f(3, 5) * 5]}, {"threshold": 6.0}, out, x)
    cases["brelu"] = ({"X": [f(3, 5) * 2]}, {"t_min": 0.5, "t_max": 1.5},
                      out, x)
    cases["logical_not"] = ({"X": [b(3, 4)]}, {}, out, ())
    cases["maxout"] = ({"X": [f(2, 6, 3, 3)]}, {"groups": 3, "axis": 1},
                       out, x)
    # comparisons against a broadcast row with equal values in it
    xc = np.round(f(3, 4))
    for name in ("less_than", "greater_than", "greater_equal", "not_equal"):
        cases[name] = ({"X": [xc], "Y": [xc[1]]}, {}, out, ())
    for name in ("logical_and", "logical_or", "logical_xor"):
        cases[name] = ({"X": [b(3, 4)], "Y": [b(3, 4)]}, {}, out, ())
    assert set(cases) == set(DENSE_OP_TYPES), \
        set(cases) ^ set(DENSE_OP_TYPES)
    return {k: cases[k] for k in DENSE_OP_TYPES}


# --- slice 17: SE-ResNeXt-50, BERT-large, the book models, dense layers ----

# SE-ResNeXt-50 32x4d (models/se_resnext.py's defaults: 3x224x224, 1000
# classes, stages (3, 4, 6, 3), cardinality 32, base 256, Momentum 0.9 at
# lr 0.1, float32) at batch 32; the card-vs-CPU check at the JAX package's
# test size (3x32x32, 10 classes, stages (1, 1), cardinality 4, base 32,
# lr 0.01), batch 4, dropout off (the two devices draw other masks).
SE_BATCH, SE_CHECK_BATCH = 32, 4
SE_CHECK_CFG = {"img_shape": (3, 32, 32), "class_dim": 10,
                "layers_per_stage": (1, 1), "cardinality": 4,
                "base_ch": 32, "lr": 0.01}
# [se_resnext_cpu_check]: the loss's relative gap, each parameter
# gradient's and update's Frobenius gap over its norm. On the CPU
# (tools/torch_rounding_sensitivity.py se_resnext) the JAX package's own
# step moves by 3.4e-7 (loss), 1.1e-5 (gradients) and 6.6e-5 (updates
# after two steps) when the image moves by 1e-6 of each value, and the
# port's parts from it by 2.2e-7, 4.7e-6 and 1.5e-5 (PERF.md); the bars
# are [recipe_cpu_check]'s float32 ones, 15-90 times those readings.
SE_RESNEXT_BARS = {"loss": 1e-5, "grad": 1e-3, "update": 1e-3}
PEAK_FLAT_RTOL = 0.05    # each step's peak memory against step 2's
# [book_models]: the book's word2vec (embedding 32, hidden 256, N 5) over
# a 2073-word dictionary at batch 100, and the recommender at its table
# sizes at batch 256, BOOK_STEPS SGD steps each; the first BOOK_CHECK
# steps' losses on the card against the CPU's from one carried scope
BOOK_STEPS, BOOK_CHECK, BOOK_LOSS_RTOL = 100, 3, 1e-4
W2V_DICT, W2V_BATCH, W2V_LR, W2V_SAMPLES = 2073, 100, 0.05, 2000
REC_BATCH = 256
# [dense_layers]: card against CPU, floats within DENSE_TOL of max(1,
# max|CPU|); integers, indices, bools and the padded outputs exactly
DENSE_TOL = 1e-5


def forward_flops_per_sample(main):
    """Operations of one sample's forward pass: 2 per multiply-add of
    every convolution (depthwise too) and every `mul` (fc) before the
    first gradient op, from the program's var shapes."""
    blk = main.global_block()
    total = 0
    for op in blk.ops:
        if op.type == "grad::generic":
            break
        if op.type in ("conv2d", "depthwise_conv2d"):
            out = blk.var(op.output("Output")[0]).shape
            filt = blk.var(op.input("Filter")[0]).shape
            total += 2 * math.prod(out[1:]) * math.prod(filt[1:])
        elif op.type == "mul":
            out = blk.var(op.output("Out")[0]).shape
            y = blk.var(op.input("Y")[0]).shape
            k = math.prod(y[:op.attrs.get("y_num_col_dims", 1)])
            total += 2 * math.prod(out[1:]) * k
    return total


def _op_ids(main, pred):
    """The indices of the forward ops matching `pred` and of their grad
    ops."""
    ops = main.global_block().ops
    fwd = {i for i, op in enumerate(ops) if op.type != "grad::generic"
           and pred(op)}
    ids = {op.id for i, op in enumerate(ops) if i in fwd}
    return fwd | {i for i, op in enumerate(ops)
                  if op.type == "grad::generic" and
                  op.attrs.get("fwd_id") in ids}


def _peak_gate(tag, peaks):
    """Each step's peak memory from step 2 on within PEAK_FLAT_RTOL of
    step 2's; returns the largest relative gap."""
    gap = max(abs(p - peaks[1]) / peaks[1] for p in peaks[1:])
    check(gap <= PEAK_FLAT_RTOL, f"[{tag}] peak memory per step "
          f"{[round(p, 3) for p in peaks]} GB moves {gap:.3f} from step "
          f"2's")
    return gap


def _build_se_resnext(ptt, batch_cfg=None, no_dropout=False):
    """models.se_resnext.build_train at RESNET_IMAGE and RESNET_CLASSES,
    its defaults (SE-ResNeXt-50 32x4d at ImageNet width), or at
    `batch_cfg`'s sizes; with `no_dropout` its dropout is built with
    probability 0."""
    from paddle_tpu_torch.models import se_resnext
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    drop = ptt.layers.dropout
    if no_dropout:
        ptt.layers.dropout = lambda x, dropout_prob, **kw: drop(x, 0.0,
                                                                **kw)
    try:
        with ptt.program_guard(main, startup), ptt.unique_name.guard():
            loss, _ = se_resnext.build_train(**(batch_cfg or {
                "img_shape": RESNET_IMAGE, "class_dim": RESNET_CLASSES}))
    finally:
        ptt.layers.dropout = drop
    return main, startup, loss


def se_resnext_train_phase(torch, card):
    """[se_resnext_train]: SE-ResNeXt-50 32x4d training at ImageNet width
    through build_train (batch SE_BATCH, float32, Momentum 0.9 at lr
    0.1), the startup program on the card, images and labels from
    RandomState(0), then 2 warm-up and 5 timed steps through run_steps:
    images/s, the host step, MFU (3 x the program's forward operations a
    image against the float32 peak), device ms by class and, on the
    [se_resnext_train_parts] line, the grouped convolutions (forward and
    gradient ops) apart from the rest. Gates: finite losses, no executor
    cache miss after the first step, each step's peak memory within
    PEAK_FLAT_RTOL of step 2's, every batch_norm's running statistics
    moved and finite. Returns {ops, host_ms, device_ms, peak_gb}."""
    import paddle_tpu_torch as ptt

    t0 = time.perf_counter()
    main, startup, loss = _build_se_resnext(ptt)
    scope = ptt.Scope()
    exe = ptt.Executor()  # the card
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    ops = main.global_block().ops
    grouped = _op_ids(main, lambda op: op.type == "conv2d" and
                      op.attrs.get("groups", 1) > 1)
    conv = _op_ids(main, lambda op: op.type == "conv2d") - grouped
    update = _step_parts(main)["update"]
    flops = forward_flops_per_sample(main)
    phase("se_resnext_train_build", stages="3,4,6,3", cardinality=32,
          batch=SE_BATCH, image="x".join(map(str, RESNET_IMAGE)),
          classes=RESNET_CLASSES, ops=len(ops),
          grouped_conv2d=sum(op.type == "conv2d" and
                             op.attrs.get("groups", 1) > 1 for op in ops),
          forward_gflop_per_image=f"{flops / 1e9:.3f}",
          params_m=f"{sum(math.prod(p.shape) for p in
                          main.all_parameters()) / 1e6:.2f}",
          seconds=f"{time.perf_counter() - t0:.2f}")
    run = run_steps(
        torch, card, "se_resnext_train", exe, main, scope,
        _resnet_feed(SE_BATCH, 0), loss, 0, 2, 5, (), SE_BATCH, 3 * flops,
        F32_FLOPS, unit="images", must_fall=False,
        classes=("conv", "matmul", "norm", "other"),
        parts={"grouped_conv": grouped, "conv": conv, "update": update,
               "other": set(range(len(ops))) - grouped - conv - update})
    gap = _peak_gate("se_resnext_train", run.peaks)
    phase("se_resnext_memory", peaks_gb=",".join(f"{p:.3f}"
                                                 for p in run.peaks),
          flat_gap=f"{gap:.4f}", tol=PEAK_FLAT_RTOL)
    _check_stats(torch, "se_resnext_stats", main, scope)
    return {"ops": len(ops), "host_ms": run.host_ms,
            "device_ms": run.device_ms, "peak_gb": run.peak_gb}


def se_resnext_cpu_check(torch):
    """[se_resnext_cpu_check]: SE-ResNeXt at SE_CHECK_CFG, batch
    SE_CHECK_BATCH, dropout off, one step on the card and one on the CPU
    from the same startup values (the startup run once on the CPU, its
    values carried to both): the loss, every parameter's gradient and
    every parameter's update within SE_RESNEXT_BARS; float32 convolutions
    on both (cuDNN's TF32 stays off)."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy

    check(not torch.backends.cudnn.allow_tf32,
          "cudnn.allow_tf32 is on: the float32 convolutions would be TF32")
    t0 = time.perf_counter()
    main, startup, loss = _build_se_resnext(ptt, SE_CHECK_CFG, True)
    names = sorted(p.name for p in main.all_parameters())
    fetch = [loss.name] + [f"{n}@GRAD" for n in names]
    init_scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(startup, scope=init_scope)
    init = {n: init_scope.get_numpy(n) for n in init_scope.names()}
    rng = np.random.RandomState(0)
    feed = {"image": rng.randn(SE_CHECK_BATCH, *SE_CHECK_CFG["img_shape"])
            .astype(np.float32),
            "label": rng.randint(0, SE_CHECK_CFG["class_dim"],
                                 (SE_CHECK_BATCH, 1)).astype(np.int64)}
    out, after = {}, {}
    for where, place in (("card", ptt.CUDAPlace(0)),
                         ("cpu", ptt.CPUPlace())):
        scope = scope_from_numpy(init, ptt.Scope(), place)
        got = ptt.Executor(place).run(main, feed=feed, fetch_list=fetch,
                                      scope=scope)
        out[where] = [np.asarray(x, np.float64) for x in got]
        after[where] = {n: scope.get_numpy(n).astype(np.float64)
                        for n in names}
    loss_rel = _loss_rel(out["card"], out["cpu"])
    grads = _grad_rel(fetch[1:], out["card"], out["cpu"])
    updates = _grad_rel(
        names, [0] + [after["card"][n] - init[n] for n in names],
        [0] + [after["cpu"][n] - init[n] for n in names])
    worst_g = max(grads, key=grads.get)
    worst_u = max(updates, key=updates.get)
    phase("se_resnext_cpu_check", batch=SE_CHECK_BATCH,
          loss_card=f"{float(out['card'][0]):.6f}",
          loss_cpu=f"{float(out['cpu'][0]):.6f}", loss_rel=f"{loss_rel:.3e}",
          grad_gap_median=f"{np.median(list(grads.values())):.3e}",
          grad_gap_max=f"{grads[worst_g]:.3e}", grad_worst=worst_g,
          update_gap_max=f"{updates[worst_u]:.3e}", update_worst=worst_u,
          bars=",".join(f"{k}:{v}" for k, v in SE_RESNEXT_BARS.items()),
          seconds=f"{time.perf_counter() - t0:.2f}")
    check(all(np.isfinite(x).all() for x in out["card"]),
          "non-finite values in the card's SE-ResNeXt step")
    check(loss_rel <= SE_RESNEXT_BARS["loss"], f"SE-ResNeXt card vs CPU "
          f"loss differs by {loss_rel} > {SE_RESNEXT_BARS['loss']}")
    check(grads[worst_g] <= SE_RESNEXT_BARS["grad"], f"SE-ResNeXt card vs "
          f"CPU gradient of {worst_g} differs by {grads[worst_g]}")
    check(updates[worst_u] <= SE_RESNEXT_BARS["update"], f"SE-ResNeXt "
          f"card vs CPU update of {worst_u} differs by {updates[worst_u]}")


def mlm_flops_per_token(cfg, seq_len, n_mask):
    """Matmul operations per token of an MLM step, forward and backward
    (3x forward): the encoder's 6*N_mat + attention 12*L*T*d, and the LM
    head at the n_mask masked positions of each seq_len tokens only."""
    d, n_layers = cfg.d_model, cfg.n_layers
    dense = n_layers * (4 * d * d + 2 * d * cfg.d_ff)
    return (6 * dense + 12 * n_layers * seq_len * d
            + 6 * cfg.vocab_size * d * n_mask / seq_len)


def bert_large_train_phase(torch, card, kernels):
    """[bert_large_train]: BERT-large (24 layers, d 1024, 16 heads, d_ff
    4096; dropout 0.1, the flash kernels) MLM pretraining through
    build_train_mlm at batch BERT_LARGE_BATCH, T 512, N_MASK masked
    positions, bf16 AMP and AdamW at lr 1e-4, on bench.py's MLM feed
    (_mlm_feed), 2 warm-up and 5 timed steps through run_steps:
    tokens/s, MFU (mlm_flops_per_token against the bf16 peak), device ms
    by class and by part. Gates: finite losses, each flash kernel 24
    times a step and no other, no executor cache miss after the first
    step, each step's peak memory within PEAK_FLAT_RTOL of step 2's.
    Prints the three flash kernels' ms at this path's shape from
    `kernels` (bwd_kernel_phase's bert_large records). Returns (the
    timed steps' launches, {ops, host_ms, device_ms, peak_gb})."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import transformer

    cfg = transformer.bert_large(dropout=0.1, attn_dropout=0.0,
                                 use_flash=True)
    t0 = time.perf_counter()
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss, _ = transformer.build_train_mlm(cfg, BERT_LARGE_BATCH, T,
                                              N_MASK, lr=1e-4, amp=True)
    scope = ptt.Scope()
    exe = ptt.Executor()  # the card
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    n_params = sum(math.prod(p.shape) for p in main.all_parameters())
    phase("bert_large_train_build", layers=cfg.n_layers,
          d_model=cfg.d_model, heads=cfg.n_heads, d_ff=cfg.d_ff,
          vocab=cfg.vocab_size, batch=BERT_LARGE_BATCH, T=T, n_mask=N_MASK,
          amp=True, params_m=f"{n_params / 1e6:.2f}",
          ops=len(main.global_block().ops),
          seconds=f"{time.perf_counter() - t0:.2f}")
    warmup, steps = 2, 5
    run = run_steps(torch, card, "bert_large_train", exe, main, scope,
                    _mlm_feed(cfg, BERT_LARGE_BATCH, 0), loss, cfg.n_layers,
                    warmup, steps, BF16_KERNEL_SYMBOLS, BERT_LARGE_BATCH * T,
                    mlm_flops_per_token(cfg, T, N_MASK), BF16_FLOPS,
                    parts=_step_parts(main))
    gap = _peak_gate("bert_large_train", run.peaks)
    phase("bert_large_memory", peaks_gb=",".join(f"{p:.3f}"
                                                 for p in run.peaks),
          flat_gap=f"{gap:.4f}", tol=PEAK_FLAT_RTOL,
          params_m=f"{n_params / 1e6:.2f}")
    phase("bert_large_kernels",
          shape=f"[{','.join(map(str, BERT_LARGE_SHAPE))}] bf16",
          **{f"{n}_ms": f"{r['ms']:.4f}" for n, r in kernels.items()},
          **{f"{n}_launches_per_step": run.launches[n] // steps
             for n in kernels})
    return run.launches, {"ops": len(main.global_block().ops),
                          "host_ms": run.host_ms,
                          "device_ms": run.device_ms,
                          "peak_gb": run.peak_gb}


def w2v_batches(names, n_batches, dict_size=W2V_DICT, batch=W2V_BATCH,
                samples=W2V_SAMPLES):
    """word2vec's feeds: W2V_SAMPLES seeded n-grams whose next word is
    the sum of the four context words modulo the dictionary (the corpus
    of tests/test_models.py), `batch` at a time, cycling."""
    import numpy as np
    rng = np.random.RandomState(0)
    ctx = rng.randint(0, dict_size, (samples, 4)).astype(np.int64)
    nxt = (ctx.sum(axis=1) % dict_size).astype(np.int64)
    out = []
    for i in range(n_batches):
        rows = np.arange(i * batch, (i + 1) * batch) % samples
        feed = {n: ctx[rows, j:j + 1] for j, n in enumerate(names[:4])}
        feed[names[4]] = nxt[rows, None]
        out.append(feed)
    return out


def movielens_batches(ptt, main, feed_names, batch, n_batches):
    """The recommender's feeds: the port's movielens reader (category ids
    padded to 4, title ids to 8) through io.batch and DataFeeder, passes
    repeated until `n_batches`."""
    from paddle_tpu_torch.datasets import movielens

    def pad(sample):
        s = list(sample)
        s[5] = (list(s[5]) + [0] * 4)[:4]
        s[6] = (list(s[6]) + [0] * 8)[:8]
        return tuple([[v] for v in s[:5]] + s[5:7] + [[s[7]]])

    reader = ptt.io.batch(ptt.reader_decorator.map_readers(
        pad, movielens.train()), batch, drop_last=True)
    feeder = ptt.DataFeeder(feed_names, program=main)
    out = []
    while len(out) < n_batches:
        out += [feeder.feed(b) for b in reader()][:n_batches - len(out)]
    return out


def _book_run(torch, ptt, build, make_feeds):
    """One book model: `build()` (its loss), the feeds `make_feeds(main)`,
    the startup run once (card) and its values carried to a card scope
    that takes every feed and to a CPU scope that takes the first
    BOOK_CHECK. Returns (card losses, CPU losses, seconds of the card
    steps)."""
    from paddle_tpu_torch.convert import scope_from_numpy
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss = build()
    feeds = make_feeds(main)
    init_scope = ptt.Scope()
    ptt.Executor().run(startup, scope=init_scope)
    init = {n: init_scope.get_numpy(n) for n in init_scope.names()}
    losses = {}
    for where, place, fds in (("card", ptt.CUDAPlace(0), feeds),
                              ("cpu", ptt.CPUPlace(), feeds[:BOOK_CHECK])):
        scope = scope_from_numpy(init, ptt.Scope(), place)
        exe = ptt.Executor(place)
        t0 = time.perf_counter()
        losses[where] = [float(exe.run(main, feed=fd, fetch_list=[loss],
                                       scope=scope)[0]) for fd in fds]
        if where == "card":
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    return losses["card"], losses["cpu"], seconds


def book_models_phase(torch, card):
    """[book_models]: the book's word2vec (W2V_DICT words, batch
    W2V_BATCH, SGD at W2V_LR) on seeded n-grams and the recommender (its
    default tables, batch REC_BATCH, SGD at its lr 0.2) on the movielens
    reader through io.batch and DataFeeder, BOOK_STEPS steps each on the
    card. Gates: the mean of the last 10 losses below the first 10's,
    and the first BOOK_CHECK losses within BOOK_LOSS_RTOL of the CPU's
    from one carried startup."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.models import recommender, word2vec

    w2v_names = ["firstw", "secondw", "thirdw", "fourthw", "nextw"]
    rec_names = recommender.USER_FEATURES + recommender.MOVIE_FEATURES + \
        ["score"]
    runs = {
        "word2vec": (lambda: word2vec.build_train(W2V_DICT, lr=W2V_LR)[0],
                     lambda main: w2v_batches(w2v_names, BOOK_STEPS),
                     W2V_BATCH),
        "recommender": (lambda: recommender.build_train()[0],
                        lambda main: movielens_batches(
                            ptt, main, rec_names, REC_BATCH, BOOK_STEPS),
                        REC_BATCH)}
    for name, (build, make_feeds, batch) in runs.items():
        card_l, cpu_l, seconds = _book_run(torch, ptt, build, make_feeds)
        gap = max(abs(a - b) / abs(b) for a, b in zip(card_l, cpu_l))
        first, last = np.mean(card_l[:10]), np.mean(card_l[-10:])
        phase("book_models", model=name, steps=len(card_l), batch=batch,
              seconds=f"{seconds:.3f}",
              samples_per_s=f"{batch * len(card_l) / seconds:.1f}",
              loss_first10=f"{first:.5f}", loss_last10=f"{last:.5f}",
              cpu_check_steps=len(cpu_l), cpu_loss_gap=f"{gap:.3e}",
              tol=BOOK_LOSS_RTOL, card=f"'{card}'")
        check(all(math.isfinite(x) for x in card_l),
              f"[book_models] {name}: non-finite losses")
        check(last < first, f"[book_models] {name}: the loss did not fall "
              f"({first} -> {last})")
        check(gap <= BOOK_LOSS_RTOL, f"[book_models] {name}: card vs CPU "
              f"losses {card_l[:BOOK_CHECK]} / {cpu_l} differ by {gap}")


def dense_op_program(ptt, op_type, ins, attrs, outs, grads):
    """A one-op program of `op_type` over data vars for `ins`, with
    `grads` differentiated: the mean of the square of each
    differentiable float output summed into a loss, append_backward.
    Returns (main, startup, feed, fetch names)."""
    from paddle_tpu_torch.core.registry import REGISTRY
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    feed, in_names = {}, {}
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        blk = main.global_block()
        for slot, arrs in ins.items():
            in_names[slot] = []
            for i, a in enumerate(arrs):
                n = f"{slot.lower()}_{i}"
                blk.create_var(name=n, shape=list(a.shape),
                               dtype=str(a.dtype), is_data=True,
                               stop_gradient=slot not in grads)
                feed[n] = a
                in_names[slot].append(n)
        out_names = {slot: [f"{slot.lower()}_out_{i}" for i in range(k)]
                     for slot, k in outs.items()}
        for ns in out_names.values():
            for n in ns:
                blk.create_var(name=n)
        blk.append_op(op_type, inputs=in_names, outputs=out_names,
                      attrs=dict(attrs))
        if grads:
            nondiff = REGISTRY.get(op_type).nondiff_outputs
            diff = [blk.var(n) for slot, ns in out_names.items()
                    if slot not in nondiff for n in ns
                    if blk.var(n).dtype == "float32"]
            loss = ptt.layers.mean(diff[0] * diff[0])
            for v in diff[1:]:
                loss = loss + ptt.layers.mean(v * v)
            ptt.backward.append_backward(loss)
    fetch = [n for ns in out_names.values() for n in ns] + \
        [f"{n}@GRAD" for s in grads for n in in_names[s]]
    return main, startup, feed, fetch


def dense_random_gaps(got, ins, attrs, op_type):
    """A random op's card draws by its range and distribution: (within
    range, the largest moment gap). randint: every value of [low, high)
    and no other, each value's share within 0.05 of uniform's;
    sampling_id: an index a row, each class's share within 0.05 of the
    rows' mean probability; uniform_random_batch_size_like: [min, max),
    the batch dim from Input, the mean within 0.1 of the middle."""
    import numpy as np
    x = np.asarray(got[0])
    if op_type == "randint":
        lo, hi = attrs["low"], attrs["high"]
        share = np.bincount(x.reshape(-1) - lo, minlength=hi - lo) / x.size
        return (x.min() == lo and x.max() == hi - 1,
                float(np.abs(share - 1 / (hi - lo)).max()) / 0.05)
    if op_type == "sampling_id":
        p = ins["X"][0]
        share = np.bincount(x, minlength=p.shape[1]) / len(x)
        return (x.shape == (p.shape[0],) and x.min() >= 0,
                float(np.abs(share - p.mean(0)).max()) / 0.05)
    ref = ins["Input"][0]
    return (x.shape[0] == ref.shape[0] and x.min() >= attrs["min"] and
            x.max() < attrs["max"],
            abs(float(x.mean()) - (attrs["min"] + attrs["max"]) / 2) / 0.1)


def dense_layers_phase(torch, card):
    """[dense_layers]: each op type of DENSE_OP_TYPES as a one-op program
    (dense_op_program on dense_op_cases' inputs, the case's inputs
    differentiated) on the card against the same program on the CPU:
    floats within DENSE_TOL of max(1, max|CPU|), integers, indices,
    bools, hash and the padded where/unique outputs exactly; the random
    ops by dense_random_gaps. Fails if an op type did not run on the
    card."""
    import paddle_tpu_torch as ptt

    t0 = time.perf_counter()
    gaps, ran = {}, set()
    for op_type, (ins, attrs, outs, grads) in dense_op_cases().items():
        main, startup, feed, fetch = dense_op_program(ptt, op_type, ins,
                                                      attrs, outs, grads)
        got = {}
        places = (("card", ptt.CUDAPlace(0)),) + (
            () if op_type in DENSE_RANDOM_OPS else
            (("cpu", ptt.CPUPlace()),))
        for where, place in places:
            exe, scope = ptt.Executor(place), ptt.Scope()
            exe.run(startup, scope=scope)
            got[where] = exe.run(main, feed=feed, fetch_list=fetch,
                                 scope=scope)
        ran |= {op.type for op in main.global_block().ops}
        if op_type in DENSE_RANDOM_OPS:
            in_range, gap = dense_random_gaps(got["card"], ins, attrs,
                                              op_type)
            gaps[op_type] = gap if in_range else math.inf
        else:
            gaps[op_type] = data_layer_gap(got["card"], got["cpu"])
    missing = [t for t in DENSE_OP_TYPES if t not in ran]
    worst = max((t for t in gaps if t not in DENSE_RANDOM_OPS),
                key=gaps.get)
    phase("dense_layers", op_types=len(gaps), ran=len(DENSE_OP_TYPES) -
          len(missing), max_gap=f"{gaps[worst]:.3e}", worst=worst,
          tol=DENSE_TOL, exact_gaps=sum(g == 0 for g in gaps.values()),
          random_ops=",".join(f"{t}:{gaps[t]:.3f}"
                              for t in DENSE_RANDOM_OPS),
          seconds=f"{time.perf_counter() - t0:.2f}", card=f"'{card}'")
    check(not missing, f"[dense_layers] op types not run: {missing}")
    bad = {t: g for t, g in gaps.items()
           if g > (1.0 if t in DENSE_RANDOM_OPS else DENSE_TOL)}
    check(not bad, f"[dense_layers] card vs CPU (random ops: range and "
          f"share, 1.0 the bar): {bad}")


# -- slice 23: the CRF and CTC family ------------------------------------

CRF_CTC_OP_TYPES = (
    "modified_huber_loss", "sigmoid_focal_loss",
    "teacher_student_sigmoid_loss", "cvm", "positive_negative_pair",
    "warpctc", "ctc_align", "edit_distance", "linear_chain_crf",
    "crf_decoding", "sample_logits", "chunk_eval")
CRF_CTC_TOL = 1e-5       # [crf_ctc_ops]: card vs CPU, of max(1, max|CPU|)
CTC_SPEECH = (16, 200, 29, 50)  # batch, T, classes, label length
# warpctc at CTC_SPEECH rounds at each of its 200 steps on each side:
# the CPU's float32 fetches (Loss, the gradient of mean(Loss^2)) read
# 6.016e-05 from float64's, the card's 1.725e-05 from the CPU's (23A);
# the phase prints both sides' float64 gaps beside this bar
CTC_SPEECH_TOL = 1e-4


def crf_ctc_op_cases():
    """The cases of CRF_CTC_OP_TYPES at small shapes: {case: (op type,
    inputs {slot: [numpy arrays]}, attrs, outputs {slot: count}, the
    input slots differentiated)}. Sequences are shorter than T with
    -1-padded labels; CTC has a repeated label and a label longer than
    T/2; one Viterbi case is all ties (integer scores). sample_logits
    draws its classes: sample_logits_gap checks it."""
    import numpy as np
    rng = np.random.RandomState(23)

    def f(*shape, lo=None, hi=None):
        if lo is not None:
            return rng.uniform(lo, hi, shape).astype(np.float32)
        return rng.randn(*shape).astype(np.float32)

    def i64(lo, hi, *shape):
        return rng.randint(lo, hi, shape).astype(np.int64)

    def pad(rows, width):
        out = np.full((len(rows), width), -1, np.int64)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return out

    ctc_labels = pad([[1, 1, 2], [3, 1, 4, 2, 5, 3, 1], [2, 2, 2, 4]], 7)
    crf_len = np.array([8, 5, 3], np.int64)
    crf_label = i64(0, 4, 3, 8)
    crf_label[np.arange(8)[None, :] >= crf_len[:, None]] = -1
    ties = rng.randint(0, 2, (2, 6, 3)).astype(np.float32)
    iob = np.array([[0, 1, 4, 2, 3, 3, 4, 0, 4, 4],
                    [2, 3, 4, 0, 1, 1, 4, 2, 2, 4],
                    [4, 0, 1, 4, 2, 3, 0, 4, 4, 4]], np.int64)
    iob_inf = iob.copy()
    iob_inf[0, 4] = 2
    iob_inf[1, 3:5] = (4, 0)
    iob_inf[2, 6] = 1
    ctc_out = {"Loss": 1, "WarpCTCGrad": 1}
    crf_out = {"LogLikelihood": 1, "Alpha": 1, "EmissionExps": 1,
               "TransitionExps": 1}
    chunk_out = {k: 1 for k in ("Precision", "Recall", "F1-Score",
                                "NumInferChunks", "NumLabelChunks",
                                "NumCorrectChunks")}
    return {
        "modified_huber_loss": (
            "modified_huber_loss",
            {"X": [f(8, 1, lo=-3, hi=3)],
             "Y": [i64(0, 2, 8, 1).astype(np.float32)]},
            {}, {"Out": 1, "IntermediateVal": 1}, ("X",)),
        "sigmoid_focal_loss": (
            "sigmoid_focal_loss",
            {"X": [f(6, 3)], "Label": [i64(0, 4, 6, 1).astype(np.int32)],
             "FgNum": [np.array([4], np.int32)]},
            {"gamma": 2.0, "alpha": 0.25}, {"Out": 1}, ("X",)),
        "teacher_student_sigmoid_loss": (
            "teacher_student_sigmoid_loss",
            {"X": [f(8, 1)], "Label": [np.array(
                [[-2.0], [-1.5], [-0.5], [-0.2], [0.3], [0.8], [1.2],
                 [1.9]], np.float32)]},
            {"soft_max_up_bound": 15.0, "soft_max_lower_bound": -15.0},
            {"Y": 1}, ("X",)),
        "cvm": ("cvm", {"X": [f(4, 5, lo=0.1, hi=3)],
                        "CVM": [f(4, 2, lo=0.1, hi=3)]},
                {"use_cvm": True}, {"Y": 1}, ("X",)),
        "cvm_no_cvm": ("cvm", {"X": [f(4, 5, lo=0.1, hi=3)],
                               "CVM": [f(4, 2, lo=0.1, hi=3)]},
                       {"use_cvm": False}, {"Y": 1}, ("X",)),
        "positive_negative_pair": (
            "positive_negative_pair",
            {"Score": [np.round(f(10, 1), 1)],
             "Label": [i64(0, 3, 10, 1).astype(np.float32)],
             "QueryID": [i64(0, 3, 10, 1)]},
            {}, {"PositivePair": 1, "NegativePair": 1, "NeutralPair": 1},
            ()),
        "warpctc": (
            "warpctc",
            {"Logits": [f(3, 12, 6)], "Label": [ctc_labels],
             "LogitsLength": [np.array([12, 9, 10], np.int64)]},
            {"blank": 0, "norm_by_times": False}, ctc_out, ("Logits",)),
        "warpctc_label_length": (
            "warpctc",
            {"Logits": [f(3, 12, 6)], "Label": [ctc_labels],
             "LogitsLength": [np.array([12, 11, 10], np.int64)],
             "LabelLength": [np.array([3, 6, 2], np.int64)]},
            {"blank": 5, "norm_by_times": True}, ctc_out, ("Logits",)),
        "ctc_align": (
            "ctc_align",
            {"Input": [np.array([[0, 1, 1, 0, 2, 2, 2, 0, 1, 0],
                                 [3, 3, 0, 0, 3, 1, 0, 1, 1, 1],
                                 [0, 0, 0, 0, 0, 0, 0, 0, 0, 0]],
                                np.int64)]},
            {"blank": 0}, {"Output": 1}, ()),
        "edit_distance": (
            "edit_distance",
            {"Hyps": [pad([[1, 2, 3, 4], [5, 5], [], [2, 1, 2, 1, 2, 7]],
                          6)],
             "Refs": [pad([[1, 3, 4, 5, 6], [5], [1, 2], [1, 2, 1, 2]],
                          7)]},
            {"normalized": True}, {"Out": 1, "SequenceNum": 1}, ()),
        "edit_distance_raw": (
            "edit_distance",
            {"Hyps": [pad([[1, 2, 3], [4, 4, 4, 4], [3]], 5)],
             "Refs": [pad([[3, 2, 1], [], [3]], 4)]},
            {"normalized": False}, {"Out": 1, "SequenceNum": 1}, ()),
        "linear_chain_crf": (
            "linear_chain_crf",
            {"Emission": [f(3, 8, 4)], "Transition": [f(6, 4) * 0.5],
             "Label": [crf_label], "Length": [crf_len]},
            {}, crf_out, ("Emission", "Transition")),
        "linear_chain_crf_full": (
            "linear_chain_crf",
            {"Emission": [f(2, 5, 3)], "Transition": [f(5, 3) * 0.5],
             "Label": [i64(0, 3, 2, 5)]},
            {}, crf_out, ("Emission", "Transition")),
        "crf_decoding": (
            "crf_decoding",
            {"Emission": [f(3, 8, 4)], "Transition": [f(6, 4) * 0.5],
             "Length": [crf_len]},
            {}, {"ViterbiPath": 1}, ()),
        "crf_decoding_label": (
            "crf_decoding",
            {"Emission": [f(3, 8, 4)], "Transition": [f(6, 4) * 0.5],
             "Label": [i64(0, 4, 3, 8)], "Length": [crf_len]},
            {}, {"ViterbiPath": 1}, ()),
        "crf_decoding_ties": (
            "crf_decoding",
            {"Emission": [ties],
             "Transition": [rng.randint(0, 2, (5, 3)).astype(np.float32)],
             "Length": [np.array([6, 4], np.int64)]},
            {}, {"ViterbiPath": 1}, ()),
        "sample_logits": (
            "sample_logits",
            {"Logits": [f(4, 12)], "Labels": [i64(0, 12, 4, 2)]},
            {"num_samples": 6, "remove_accidental_hits": True, "seed": 0},
            {"SampledLogits": 1, "SampledLabels": 1, "Samples": 1,
             "Probabilities": 1, "LogitsDim": 1, "LabelsDim": 1},
            ("Logits",)),
        "chunk_eval": (
            "chunk_eval",
            {"Inference": [iob_inf], "Label": [iob],
             "SeqLength": [np.array([10, 9, 7], np.int64)]},
            {"chunk_scheme": "IOB", "num_chunk_types": 2,
             "excluded_chunk_types": []}, chunk_out, ()),
        "chunk_eval_iobes": (
            "chunk_eval",
            {"Inference": [i64(0, 9, 3, 12)], "Label": [i64(0, 9, 3, 12)]},
            {"chunk_scheme": "IOBES", "num_chunk_types": 2,
             "excluded_chunk_types": [1]}, chunk_out, ()),
    }


def sample_logits_gap(got, ins, attrs):
    """sample_logits' outputs against its formula on its own draws:
    SampledLogits = Logits[row, Samples] - log(num_samples / N), a drawn
    class equal to a true label at -1e30 (or below -1e29), labels
    0..nt-1, Probabilities 1 / N, every draw in [0, N). Returns the
    largest gap (inf for a wrong integer or shape)."""
    import numpy as np
    picked, labels, ids, probs = (np.asarray(g) for g in got[:4])
    logits, true = ins["Logits"][0], ins["Labels"][0]
    n, nt = logits.shape[1], true.shape[1]
    if not (np.array_equal(ids[:, :nt], true) and ids.min() >= 0 and
            ids.max() < n and np.array_equal(
                labels, np.broadcast_to(np.arange(nt), labels.shape))):
        return float("inf")
    want = np.take_along_axis(logits, ids, 1) - np.log(
        attrs["num_samples"] / n)
    hit = (ids[:, nt:, None] == true[:, None, :]).any(-1)
    if not (picked[:, nt:][hit] < -1e29).all():
        return float("inf")
    keep = np.concatenate([np.ones((len(ids), nt), bool), ~hit], 1)
    return max(float(np.abs(picked[keep] - want[keep]).max()),
               float(np.abs(probs - 1.0 / n).max()))


def crf_ctc_ops_phase(torch, card):
    """[crf_ctc_ops]: each case of crf_ctc_op_cases as a one-op program
    (dense_op_program, the case's inputs differentiated) on the card
    against the same program on the CPU, forward and gradients: floats
    within CRF_CTC_TOL of max(1, max|CPU|), integers exactly;
    sample_logits by its formula on the card's draws. Then warpctc at a
    DeepSpeech-like shape (CTC_SPEECH: batch 16, T 200, 29 classes,
    labels of 50) forward and backward, card against CPU, with the
    card's ms of a forward and backward. Fails if an op type did not
    run on the card."""
    import numpy as np
    import paddle_tpu_torch as ptt

    t0 = time.perf_counter()
    gaps, ran = {}, set()
    for name, (op_type, ins, attrs, outs, grads) in \
            crf_ctc_op_cases().items():
        main, startup, feed, fetch = dense_op_program(ptt, op_type, ins,
                                                      attrs, outs, grads)
        got = {}
        for where, place in (("card", ptt.CUDAPlace(0)),
                             ("cpu", ptt.CPUPlace())):
            exe, scope = ptt.Executor(place), ptt.Scope()
            exe.run(startup, scope=scope)
            got[where] = exe.run(main, feed=feed, fetch_list=fetch,
                                 scope=scope)
        ran |= {op.type for op in main.global_block().ops}
        gaps[name] = sample_logits_gap(got["card"], ins, attrs) \
            if op_type == "sample_logits" else \
            data_layer_gap(got["card"], got["cpu"])
    b, t, c, n_lab = CTC_SPEECH
    rng = np.random.RandomState(SEED)
    ins = {"Logits": [rng.randn(b, t, c).astype(np.float32)],
           "Label": [rng.randint(1, c, (b, n_lab)).astype(np.int64)],
           "LogitsLength": [rng.randint(t * 3 // 4, t + 1, b)
                            .astype(np.int64)],
           "LabelLength": [rng.randint(n_lab // 2, n_lab + 1, b)
                           .astype(np.int64)]}
    main, startup, feed, fetch = dense_op_program(
        ptt, "warpctc", ins, {"blank": 0}, {"Loss": 1, "WarpCTCGrad": 1},
        ("Logits",))
    got = {}
    for where, place in (("card", ptt.CUDAPlace(0)),
                         ("cpu", ptt.CPUPlace())):
        exe, scope = ptt.Executor(place), ptt.Scope()
        exe.run(startup, scope=scope)
        got[where] = exe.run(main, feed=feed, fetch_list=fetch,
                             scope=scope)
        if where == "card":
            ms = cuda_ms(lambda: exe.run(main, feed=feed,
                                         fetch_list=fetch[:1],
                                         scope=scope, return_numpy=False),
                         iters=5, warmup=1)
    speech = data_layer_gap(got["card"], got["cpu"])
    f64 = _ctc_float64(torch, ins)
    f64_gaps = {w: data_layer_gap([got[w][0], got[w][2]], f64)
                for w in got}
    missing = [o for o in CRF_CTC_OP_TYPES if o not in ran]
    worst = max(gaps, key=gaps.get)
    phase("crf_ctc_ops", cases=len(gaps), op_types=len(ran & set(
        CRF_CTC_OP_TYPES)), max_gap=f"{gaps[worst]:.3e}", worst=worst,
          tol=CRF_CTC_TOL, exact=sum(g == 0 for g in gaps.values()),
          speech_shape="x".join(map(str, CTC_SPEECH)),
          speech_gap=f"{speech:.3e}", speech_tol=CTC_SPEECH_TOL,
          speech_card_vs_f64=f"{f64_gaps['card']:.3e}",
          speech_cpu_vs_f64=f"{f64_gaps['cpu']:.3e}",
          speech_fwd_bwd_ms=f"{ms:.3f}",
          speech_loss_mean=f"{float(np.mean(got['card'][0])):.4f}",
          seconds=f"{time.perf_counter() - t0:.2f}", card=f"'{card}'")
    check(not missing, f"[crf_ctc_ops] op types not run: {missing}")
    bad = {k: g for k, g in gaps.items() if not g <= CRF_CTC_TOL}
    check(not bad, f"[crf_ctc_ops] card vs CPU past {CRF_CTC_TOL}: {bad}")
    check(speech <= CTC_SPEECH_TOL, f"[crf_ctc_ops] warpctc at "
          f"{CTC_SPEECH}: card vs CPU {speech} past {CTC_SPEECH_TOL}")


def _ctc_float64(torch, ins):
    """warpctc's Loss and the Logits gradient of dense_op_program's
    objective (the mean of Loss squared) in float64 on the CPU."""
    from paddle_tpu_torch.ops.loss_extra import ctc_loss
    x = torch.tensor(ins["Logits"][0], dtype=torch.float64,
                     requires_grad=True)
    lab, n = torch.tensor(ins["Label"][0]), ins["Label"][0].shape[1]
    lab = torch.where(torch.arange(n)[None, :] <
                      torch.tensor(ins["LabelLength"][0])[:, None], lab, -1)
    loss = ctc_loss(torch.log_softmax(x, -1), lab, 0,
                    torch.tensor(ins["LogitsLength"][0]))
    (loss ** 2).mean().backward()
    return [loss.detach().numpy().reshape(-1, 1), x.grad.numpy()]


# -- control flow, RNNs and ragged sequences -------------------------------

# RNNsearch-50's published widths (Bahdanau, Cho and Bengio, ICLR 2015):
# 1000 hidden units, 620-dim embeddings, 30,000-word vocabularies,
# sentences up to 50 words, minibatches of 80
S2S_VOCAB = 30000
S2S_LEN = 50
S2S_HIDDEN = 1000
S2S_EMB = 620
S2S_BATCH = 80
S2S_CHECK_BATCH = 4
S2S_BEAM_BATCH = 8
S2S_BEAM = 4
# card vs CPU bars of [seq2seq_cpu_check] and [sentiment_lod]: ten times
# the larger CPU reading of tools/torch_rounding_sensitivity.py seq2seq
# and sentiment (PERF.md §6): the port's float32 gradients within 7.7e-7
# of the JAX package's and the JAX package's own moved 1.1e-6 by a 1e-6
# change of the embeddings; the losses within 9.3e-8 and 8.6e-8
S2S_BARS = {"loss": 1e-6, "grad": 1e-5}
SENTIMENT_LOSS_RTOL = 1e-6
BEAM_FLIP_TOL = 1e-4
# book chapter 05's stacked_lstm_net: embedding 128, hid_dim 512 (each
# dynamic_lstm of size 512 is 128 units), 3 stacked layers, 2 classes,
# Adagrad 0.002; batches of 128 reviews from datasets.imdb
SENT_EMB = 128
SENT_HID = 512
SENT_STACKED = 3
SENT_BATCH = 128
SENT_BATCHES = 6
CF_COUNT = 64          # [control_flow]'s While counts to this
CF_RNN = (32, 50, 256)  # batch, time, width of its StaticRNN / DynamicRNN
CF_TOL = 1e-5
GM_K = 4               # [grad_merge]: k micro-steps of GM_BATCH rows
GM_BATCH = 8
GM_RTOL = 1e-5


def build_seq2seq(f, lr=1e-3):
    """models.seq2seq.build_train at RNNsearch-50's widths in package `f`
    (the port or the JAX package), Adam at `lr` (build_train's default of
    0.01 overshoots at these widths: the loss rose again by the fifth
    step on the card): (main, startup, loss)."""
    from importlib import import_module
    s2s = import_module(f.__name__ + ".models.seq2seq")
    main, startup = f.Program(), f.Program()
    startup.random_seed = SEED
    with f.program_guard(main, startup), f.unique_name.guard():
        loss, _ = s2s.build_train(
            src_vocab=S2S_VOCAB, trg_vocab=S2S_VOCAB, src_len=S2S_LEN,
            trg_len=S2S_LEN, hidden=S2S_HIDDEN, emb_dim=S2S_EMB, lr=lr)
    return main, startup, loss


def seq2seq_feed(batch, seed=0):
    """Full rows of token ids from RandomState(seed), as bench.py draws
    BERT's tokens: every step trains on S2S_LEN tokens a row."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return {k: rng.randint(0, S2S_VOCAB, (batch, S2S_LEN)).astype(np.int64)
            for k in ("src_ids", "trg_in", "trg_next")}


def seq2seq_flops_per_token():
    """Training FLOPs a target token (3 x the forward's products), with
    source and target of one length: the bi-GRU encoder (input and
    recurrent products, both directions), the encoder projection, and
    the decoder's attention (its state's projection, the scores over the
    source and the context), GRU step and vocabulary projection."""
    h, e, vocab, length = S2S_HIDDEN, S2S_EMB, S2S_VOCAB, S2S_LEN
    enc = 2 * (2 * e * 3 * h + 2 * h * 3 * h) + 2 * 2 * h * h
    dec = (2 * h * h + 2 * h * length + 2 * 2 * h * length +
           2 * (e + 2 * h) * 3 * h + 2 * h * 3 * h + 2 * h * vocab)
    return 3 * (enc + dec)


def seq2seq_train_phase(torch, card):
    """[seq2seq_train]: RNNsearch-50 (models.seq2seq at its published
    widths, float32, Adam) on batch S2S_BATCH of full 50-token rows
    through Executor.run: run_steps' gates (finite losses, falling over
    the 5 steps of one repeated batch, no executor cache entry after the
    first step, no flash kernel), its [seq2seq_train] line and profile,
    [seq2seq_program] (op counts) and [seq2seq_plan] (the planner's peak
    over the measured one). Returns the trained scope."""
    import paddle_tpu_torch as ptt

    t0 = time.perf_counter()
    main, startup, loss = build_seq2seq(ptt)
    phase("seq2seq_program", ops_global=len(main.global_block().ops),
          ops_all_blocks=sum(len(b.ops) for b in main.blocks),
          blocks=len(main.blocks),
          params=sum(math.prod(p.shape) for p in main.all_parameters()))
    exe, scope = ptt.Executor(), ptt.Scope()
    exe.run(startup, scope=scope)
    run = run_steps(torch, card, "seq2seq_train", exe, main, scope,
                    seq2seq_feed(S2S_BATCH), loss, 0, 2, 3, (),
                    S2S_BATCH * S2S_LEN, seq2seq_flops_per_token(),
                    F32_FLOPS, classes=("matmul", "other"),
                    plan_tag="seq2seq_plan")
    phase("seq2seq_train_time", seconds=f"{time.perf_counter() - t0:.1f}",
          device_ms=f"{run.device_ms:.3f}", host_ms=f"{run.host_ms:.3f}",
          card=f"'{card}'")
    return scope


def _card_cpu_values(ptt, startup):
    """The startup program's values, run once on the card, as numpy."""
    scope = ptt.Scope()
    ptt.Executor().run(startup, scope=scope)
    return {n: scope.get_numpy(n) for n in scope.names()}


def _run_card_cpu(ptt, main, init, feed, fetch, places=None):
    """One run of `main` on the card and one on the CPU, each from `init`:
    {"card" | "cpu": [numpy of each fetch]}."""
    import numpy as np
    from paddle_tpu_torch.convert import scope_from_numpy
    out = {}
    for where, place in places or (("card", ptt.CUDAPlace(0)),
                                   ("cpu", ptt.CPUPlace())):
        scope = scope_from_numpy(init, ptt.Scope(), place)
        got = ptt.Executor(place).run(main, feed=feed, fetch_list=fetch,
                                      scope=scope)
        out[where] = [np.asarray(x) for x in got]
    return out


def _fro_rel(a, b):
    import numpy as np
    n = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / n if n else \
        (0.0 if not np.any(a) else math.inf)


S2S_CHECK_GRADS = ("embedding_0.w_0", "embedding_1.w_0")


def seq2seq_cpu_check(torch):
    """[seq2seq_cpu_check]: the full-width program at batch
    S2S_CHECK_BATCH, one step on the card and one on the CPU from one
    startup: the loss within S2S_BARS["loss"] relative, and the gradients
    of the two embeddings, the output projection and the decoder GRU's
    recurrent weight within S2S_BARS["grad"] (Frobenius gap over the
    norm)."""
    import paddle_tpu_torch as ptt

    t0 = time.perf_counter()
    main, startup, loss = build_seq2seq(ptt)
    params = [p.name for p in main.all_parameters()]
    # the two embeddings, the output projection's weight and the decoder
    # GRU's recurrent weight (the last GRUCell parameter made)
    grads = [n for n in params if n in S2S_CHECK_GRADS] + [params[-2], [
        n for n in params if n.startswith("GRUCell") and
        n.endswith(".w_0")][-1]]
    fetch = [loss.name] + [f"{n}@GRAD" for n in grads]
    out = _run_card_cpu(ptt, main, _card_cpu_values(ptt, startup),
                        seq2seq_feed(S2S_CHECK_BATCH, seed=1), fetch)
    card, cpu = out["card"], out["cpu"]
    loss_rel = abs(card[0] - cpu[0]) / abs(cpu[0])
    errs = {n: _fro_rel(a, b) for n, a, b in zip(grads, card[1:], cpu[1:])}
    phase("seq2seq_cpu_check", batch=S2S_CHECK_BATCH,
          loss_card=f"{float(card[0]):.6f}", loss_cpu=f"{float(cpu[0]):.6f}",
          loss_rel=f"{loss_rel:.3e}", loss_tol=S2S_BARS["loss"],
          **{f"{n}_rel": f"{e:.3e}" for n, e in errs.items()},
          grad_tol=S2S_BARS["grad"], seconds=f"{time.perf_counter() - t0:.1f}")
    check(loss_rel <= S2S_BARS["loss"],
          f"[seq2seq_cpu_check] loss card vs CPU {loss_rel}")
    check(all(e <= S2S_BARS["grad"] and math.isfinite(e)
              for e in errs.values()),
          f"[seq2seq_cpu_check] gradients card vs CPU {errs}")


def build_seq2seq_beam(f, batch):
    """Beam search over build_seq2seq's parameters from public entry
    points: seq2seq.encoder, an AttentionDecoderCell over the encoder
    output tiled with BeamSearchDecoder.tile_beam_merge_with_batch, a
    BeamSearchDecoder (start 0, end 1) embedding with the trained target
    table and projecting with the trained output layer, and
    dynamic_decode. Built in the training program's order, so its
    parameters get the training program's names. Beam S2S_BEAM, up to
    S2S_LEN steps. Returns (main, [ids, scores, lengths, the per-step
    selected ids, parents])."""
    from importlib import import_module
    s2s = import_module(f.__name__ + ".models.seq2seq")
    L = f.layers
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        src = L.data("src_ids", shape=[batch, S2S_LEN], dtype="int64",
                     append_batch_size=False)
        enc = s2s.encoder(src, S2S_VOCAB, S2S_HIDDEN, S2S_EMB)
        enc_b = L.rnn.BeamSearchDecoder.tile_beam_merge_with_batch(
            enc, S2S_BEAM)
        proj = L.fc(enc_b, size=S2S_HIDDEN, num_flatten_dims=2)
        cell = s2s.AttentionDecoderCell(S2S_HIDDEN, enc_b, proj)
        emb_name = f.unique_name.generate("embedding") + ".w_0"

        def embed(ids):
            return L.embedding(L.unsqueeze(ids, [1]),
                               size=[S2S_VOCAB, S2S_EMB],
                               param_attr=f.ParamAttr(name=emb_name))

        names = {}

        def project(h):
            if not names:
                names["fc"] = f.unique_name.generate("fc")
            return L.fc(h, size=S2S_VOCAB,
                        param_attr=f.ParamAttr(name=names["fc"] + ".w_0"),
                        bias_attr=f.ParamAttr(name=names["fc"] + ".b_0"))

        dec = L.rnn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                      beam_size=S2S_BEAM,
                                      embedding_fn=embed,
                                      output_fn=project)
        init = L.fill_constant([batch, S2S_HIDDEN], "float32", 0.0)
        ids, scores, lens = L.rnn.dynamic_decode(
            dec, inits=init, max_step_num=S2S_LEN, return_length=True)
    rec = [op for op in main.global_block().ops if op.type == "recurrent"][-1]
    step_ids, step_parents = rec.output("Out")[:2]
    return main, [ids.name, scores.name, lens.name, step_ids, step_parents]


def beam_flips(card, cpu, tol=BEAM_FLIP_TOL):
    """Rows whose beams differ between the card and the CPU: [(row, first
    step whose selected (id, parent) pairs differ, the largest gap there
    between the two sides' selected scores)]. A rounding flip is a near
    tie: its step's scores agree within `tol`."""
    import numpy as np
    ids_c, sc_c, _, sel_c, par_c = card
    ids_p, sc_p, _, sel_p, par_p = cpu
    flips = []
    for b in range(ids_c.shape[0]):
        if np.array_equal(ids_c[b], ids_p[b]) and \
                np.array_equal(sel_c[b], sel_p[b]):
            continue
        diff = np.nonzero((sel_c[b] != sel_p[b]).any(-1) |
                          (par_c[b] != par_p[b]).any(-1))[0]
        t = int(diff[0]) if len(diff) else 0
        flips.append((b, t, float(np.abs(sc_c[b, t] - sc_p[b, t]).max())))
    return flips


def seq2seq_beam_phase(torch, card, trained):
    """[seq2seq_beam]: beam search (build_seq2seq_beam, beam S2S_BEAM,
    50 steps) over [seq2seq_train]'s trained parameters, batch
    S2S_BEAM_BATCH of source rows, on the card and on the CPU. Gate: the
    ids equal, or equal up to a first flip whose step's selected scores
    agree within BEAM_FLIP_TOL on both sides (a rounding flip, the rule
    of [gen_serve]); the flips are printed."""
    import numpy as np
    import paddle_tpu_torch as ptt

    t0 = time.perf_counter()
    main, fetch = build_seq2seq_beam(ptt, S2S_BEAM_BATCH)
    params = {p.name for p in main.all_parameters()}
    missing = sorted(params - set(trained.names()))
    check(not missing, f"[seq2seq_beam] parameters not in the trained "
          f"scope: {missing}")
    init = {n: trained.get_numpy(n) for n in params}
    feed = {"src_ids": seq2seq_feed(S2S_BEAM_BATCH, seed=2)["src_ids"]}
    out, times = {}, {}
    for where, place in (("card", ptt.CUDAPlace(0)), ("cpu", ptt.CPUPlace())):
        t1 = time.perf_counter()
        out.update(_run_card_cpu(ptt, main, init, feed, fetch,
                                 [(where, place)]))
        times[where] = time.perf_counter() - t1
    flips = beam_flips(out["card"], out["cpu"])
    phase("seq2seq_beam", batch=S2S_BEAM_BATCH, beam=S2S_BEAM,
          steps=S2S_LEN, ids_equal_rows=S2S_BEAM_BATCH - len(flips),
          flips=";".join(f"row{b}@t{t}:{g:.2e}" for b, t, g in flips)
          or "none",
          card_s=f"{times['card']:.2f}", cpu_s=f"{times['cpu']:.2f}",
          mean_len=f"{out['card'][2].mean():.2f}",
          best_score_mean=f"{out['card'][1][:, -1, 0].mean():.4f}",
          seconds=f"{time.perf_counter() - t0:.1f}", card=f"'{card}'")
    check(out["card"][0].shape == (S2S_BEAM_BATCH, S2S_LEN, S2S_BEAM),
          f"[seq2seq_beam] ids shape {out['card'][0].shape}")
    check(np.isfinite(out["card"][1]).all(), "[seq2seq_beam] scores")
    check(all(g <= BEAM_FLIP_TOL for _, _, g in flips),
          f"[seq2seq_beam] beams differ beyond a rounding flip: {flips}")


def build_sentiment(f, vocab, lr=0.002):
    """Book chapter 05's stacked_lstm_net (understand_sentiment) in
    package `f`: embedding SENT_EMB, fc + dynamic_lstm of size SENT_HID,
    SENT_STACKED of them alternating direction, a max sequence_pool of
    the last fc and the last lstm, a softmax fc over 2 classes, Adagrad.
    The ragged input's lengths companion ("words.lengths") masks every
    lstm and pool. Returns (main, startup, loss, [words, label])."""
    L = f.layers
    main, startup = f.Program(), f.Program()
    startup.random_seed = SEED
    with f.program_guard(main, startup), f.unique_name.guard():
        words = L.data("words", shape=[1], dtype="int64", lod_level=1)
        label = L.data("label", shape=[1], dtype="int64")
        lens = main.global_block().var(main.lod_link[words.name])
        emb = L.embedding(words, size=[vocab, SENT_EMB])
        fc = L.fc(emb, size=SENT_HID, num_flatten_dims=2)
        lstm, _ = L.dynamic_lstm(fc, size=SENT_HID, sequence_length=lens)
        for i in range(2, SENT_STACKED + 1):
            fc = L.fc([fc, lstm], size=SENT_HID, num_flatten_dims=2)
            lstm, _ = L.dynamic_lstm(fc, size=SENT_HID,
                                     is_reverse=(i % 2) == 0,
                                     sequence_length=lens)
        pooled = [L.sequence_pool(x, "max", lengths=lens)
                  for x in (fc, lstm)]
        pred = L.fc(pooled, size=2, act="softmax")
        loss = L.mean(L.cross_entropy(pred, label))
        f.optimizer.Adagrad(learning_rate=lr).minimize(loss)
    return main, startup, loss, [words, label]


def imdb_batches(f, main, feed_vars, n, batch=SENT_BATCH):
    """`n` DataFeeder feeds of `batch` reviews from f.datasets.imdb's
    train reader, bucketed by length as a bucketing reader batches them:
    the reviews sorted by length (stably), batch i the `batch` reviews
    from the i-th of `n` evenly spaced starts, so the batches' longest
    reviews, and their padded T, differ. Ragged id rows (LoDTensors) and
    labels."""
    import numpy as np
    from importlib import import_module
    imdb = import_module(f.__name__ + ".datasets.imdb")
    feeder = f.DataFeeder(feed_list=feed_vars, program=main)
    rows = sorted(((np.asarray(ids, np.int64).reshape(-1, 1), [label])
                   for ids, label in imdb.train()()),
                  key=lambda r: len(r[0]))
    starts = [i * (len(rows) - batch) // max(n - 1, 1) for i in range(n)]
    return [feeder.feed(rows[s:s + batch]) for s in starts]


def sentiment_lod_phase(torch, card):
    """[sentiment_lod]: build_sentiment at the book's widths (vocabulary
    of the port's datasets.imdb, 5147) on SENT_BATCHES batches of
    SENT_BATCH ragged reviews (lengths 8-63) through DataFeeder, two
    passes, on the card. Gates: the feeds name no lengths var, yet the
    executor feeds each batch's lengths to "words.lengths"; every padded
    T is a multiple of 8; the executor's cache gains an entry only at a
    padded T's first step; losses finite, the second pass's mean below
    the first's; the first batch's loss on the card and on the CPU, from
    one startup, within SENTIMENT_LOSS_RTOL."""
    import statistics

    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.datasets import imdb

    t0 = time.perf_counter()
    vocab = len(imdb.word_dict())
    main, startup, loss, feed_vars = build_sentiment(ptt, vocab)
    batches = imdb_batches(ptt, main, feed_vars, SENT_BATCHES)
    check(all(set(b) == {"words", "label"} for b in batches),
          "[sentiment_lod] the feeds name more than words and label")
    emb = next(op.output("Out")[0] for op in main.global_block().ops
               if op.type in ("lookup_table", "lookup_table_v2"))
    exe, scope = ptt.Executor(), ptt.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.get_numpy(n) for n in scope.names()}
    losses, seen, times = [], set(), []
    for epoch in range(2):
        for fd in batches:
            misses = exe.cache_stats()["misses"]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lv, lens, e = exe.run(main, feed=fd,
                                  fetch_list=[loss, "words.lengths", emb],
                                  scope=scope)
            times.append(time.perf_counter() - t1)
            losses.append(float(lv))
            want = fd["words"].recursive_sequence_lengths()[0]
            t_pad = e.shape[1]
            check(list(lens) == list(want), "[sentiment_lod] the lengths "
                  "fed to words.lengths are not the batch's")
            check(t_pad % 8 == 0 and max(want) <= t_pad < max(want) + 8,
                  f"[sentiment_lod] padded T {t_pad} for longest "
                  f"{max(want)}")
            new = exe.cache_stats()["misses"] - misses
            check(new == (t_pad not in seen), f"[sentiment_lod] {new} "
                  f"cache entries at padded T {t_pad} (seen: {seen})")
            seen.add(t_pad)
    n = len(batches)
    first, second = np.mean(losses[:n]), np.mean(losses[n:])
    check(all(math.isfinite(x) for x in losses),
          f"[sentiment_lod] losses {losses}")
    check(second < first, f"[sentiment_lod] loss did not fall: {first} "
          f"-> {second}")
    out = _run_card_cpu(ptt, main, init, batches[0], [loss.name])
    gap = abs(out["card"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    check(gap <= SENTIMENT_LOSS_RTOL,
          f"[sentiment_lod] card vs CPU loss {out['card']} / {out['cpu']}")
    tokens = sum(int(np.sum(b["words"].recursive_sequence_lengths()[0]))
                 for b in batches)
    step_s = statistics.median(times[n:])
    phase("sentiment_lod", vocab=vocab, batch=SENT_BATCH, steps=len(losses),
          padded_ts=",".join(str(t) for t in sorted(seen)),
          cache_entries=exe.cache_stats()["size"],
          step_ms_median=f"{step_s * 1e3:.3f}",
          tokens_per_s=f"{tokens / n / step_s:.1f}",
          loss_first_pass=f"{first:.5f}", loss_second_pass=f"{second:.5f}",
          cpu_loss_gap=f"{float(gap):.3e}", tol=SENTIMENT_LOSS_RTOL,
          seconds=f"{time.perf_counter() - t0:.1f}", card=f"'{card}'")


def control_flow_programs(ptt):
    """[control_flow]'s programs: {name: (main, startup, feed, fetch)}: a
    While that counts to CF_COUNT and writes a tensor array; IfElse;
    a Switch with first match (three feeds); StaticRNN (time-major) and
    DynamicRNN (batch-major) over CF_RNN, each with one SGD step."""
    import numpy as np
    L = ptt.layers
    rng = np.random.RandomState(SEED)
    b, t, d = CF_RNN
    progs = {}

    def make(name, body, feeds):
        main, startup = ptt.Program(), ptt.Program()
        startup.random_seed = SEED
        with ptt.program_guard(main, startup), ptt.unique_name.guard():
            fetch = [v.name for v in body()]
        progs[name] = (main, startup, feeds, fetch)

    def while_array():
        x = L.data("x", shape=[d], dtype="float32")
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", CF_COUNT)
        arr = L.create_array("float32")
        L.array_write(x, i, array=arr)
        acc = L.scale(x, scale=1.0)
        cond = L.less_than(i, n)
        loop = L.While(cond)
        with loop.block():
            L.assign(L.tanh(L.scale(acc, scale=0.9, bias=0.1)), acc)
            L.array_write(acc, i, array=arr)
            L.increment(i, in_place=True)
            L.less_than(i, n, cond=cond)
        flat, _ = L.tensor_array_to_tensor(arr, axis=0)
        return [i, acc, L.array_length(arr), flat,
                L.array_read(arr, L.fill_constant([1], "int64", 40))]

    def if_else():
        x = L.data("x", shape=[d], dtype="float32")
        cond = L.greater_than(L.reduce_sum(x, dim=1, keep_dim=True),
                              L.fill_constant([1], "float32", 0.0))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.fc(ie.input(x), size=d, act="relu"))
        with ie.false_block():
            ie.output(L.scale(ie.input(x), scale=-1.0))
        return ie()

    def switch():
        v = L.data("v", shape=[1], dtype="float32", append_batch_size=False)
        out = L.fill_constant([1], "float32", -1.0)
        sw = L.Switch()
        for k, bound in enumerate((1.0, 2.0)):
            with sw.case(L.less_than(v, L.fill_constant([1], "float32",
                                                         bound))):
                L.assign(L.fill_constant([1], "float32", k + 1.0), out)
        with sw.default():
            L.assign(L.fill_constant([1], "float32", 3.0), out)
        return [out]

    def static_rnn():
        x = L.data("x", shape=[t, b, d], dtype="float32",
                   append_batch_size=False)
        h0 = L.fill_constant([b, d], "float32", 0.0)
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(init=h0)
            nh = L.fc([xt, h], size=d, act="tanh")
            rnn.update_memory(h, nh)
            rnn.step_output(nh)
        out = rnn()
        loss = L.mean(out)
        ptt.optimizer.SGD(0.1).minimize(loss)
        return [loss, out]

    def dynamic_rnn():
        x = L.data("x", shape=[t, d], dtype="float32")
        h0 = L.fill_constant_batch_size_like(x, [-1, d], "float32", 0.0)
        drnn = L.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(x)
            h = drnn.memory(init=h0)
            nh = L.fc([xt, h], size=d, act="tanh")
            drnn.update_memory(h, nh)
            drnn.output(nh)
        out = drnn()
        loss = L.mean(out)
        ptt.optimizer.SGD(0.1).minimize(loss)
        return [loss, out]

    x2 = rng.randn(b, d).astype(np.float32)
    make("while_array", while_array, [{"x": x2}])
    make("if_else", if_else, [{"x": x2}])
    make("switch", switch, [{"v": np.asarray([v], np.float32)}
                            for v in (0.5, 1.5, 5.0)])
    make("static_rnn", static_rnn,
         [{"x": rng.randn(t, b, d).astype(np.float32)}])
    make("dynamic_rnn", dynamic_rnn,
         [{"x": rng.randn(b, t, d).astype(np.float32)}])
    return progs


def control_flow_phase(torch, card):
    """[control_flow]: control_flow_programs on the card against the same
    programs on the CPU from one startup: integers exactly, floats within
    CF_TOL of max(1, max|CPU|); a Switch takes its first matching case;
    the parameters after the RNNs' SGD step too. Prints the host syncs an
    iteration of the While (1: its condition's read) and its ms an
    iteration (the program's run over CF_COUNT iterations, warm)."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import controlflow as cf

    t0 = time.perf_counter()
    gaps = {}
    for name, (main, startup, feeds, fetch) in \
            control_flow_programs(ptt).items():
        init = _card_cpu_values(ptt, startup)
        params = [p.name for p in main.all_parameters()]
        for k, fd in enumerate(feeds):
            out = _run_card_cpu(ptt, main, init, fd, fetch + params)
            gap = 0.0
            for a, c in zip(out["card"], out["cpu"]):
                if a.dtype.kind == "f":
                    scale = max(1.0, float(np.abs(c).max(initial=0.0)))
                    gap = max(gap, float(np.abs(a - c).max(initial=0.0))
                              / scale)
                else:
                    check(np.array_equal(a, c), f"[control_flow] {name}: "
                          f"card {a.ravel()[:8]} vs CPU {c.ravel()[:8]}")
            gaps[f"{name}{k if len(feeds) > 1 else ''}"] = gap
            if name == "switch":
                check(float(out["card"][0][0]) == (1.0, 2.0, 3.0)[k],
                      f"[control_flow] switch case {k}: {out['card'][0]}")
            if name == "while_array":
                check(int(out["card"][0][0]) == CF_COUNT and
                      int(out["card"][2][0]) == 64,
                      f"[control_flow] while: i {out['card'][0]}, array "
                      f"length {out['card'][2]}")
    main, startup, feeds, fetch = control_flow_programs(ptt)["while_array"]
    exe, scope = ptt.Executor(), ptt.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=feeds[0], fetch_list=fetch, scope=scope)
    before = dict(cf.HOST_SYNCS)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    exe.run(main, feed=feeds[0], fetch_list=fetch, scope=scope)
    per_iter_ms = (time.perf_counter() - t1) * 1e3 / CF_COUNT
    iters = cf.HOST_SYNCS["while_iterations"] - before["while_iterations"]
    syncs = cf.HOST_SYNCS["while"] - before["while"]
    check(iters == CF_COUNT, f"[control_flow] {iters} While iterations")
    phase("control_flow", **{f"{k}_gap": f"{v:.3e}" for k, v in
                             gaps.items()},
          tol=CF_TOL, while_iterations=iters,
          host_syncs_per_iteration=f"{syncs / iters:.3f}",
          ms_per_iteration=f"{per_iter_ms:.3f}",
          seconds=f"{time.perf_counter() - t0:.1f}", card=f"'{card}'")
    check(all(g <= CF_TOL for g in gaps.values()),
          f"[control_flow] card vs CPU gaps {gaps} > {CF_TOL}")


def build_grad_merge(ptt, transformer, cfg, batch, k):
    """BERT-base MLM (build_train_mlm, N_MASK positions a row, float32,
    dropout 0) at `batch` under AdamW (lr 1e-4), wrapped in
    GradientMergeOptimizer(k_steps=k) when k > 1: (main, startup, loss)."""
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED

    def opt(learning_rate):
        inner = ptt.optimizer.AdamW(learning_rate=learning_rate)
        return ptt.optimizer.GradientMergeOptimizer(inner, k_steps=k) \
            if k > 1 else inner

    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss, _ = transformer.build_train_mlm(cfg, batch, T, N_MASK,
                                              optimizer_cls=opt)
    return main, startup, loss


def grad_merge_phase(torch, card):
    """[grad_merge]: BERT-base float32 at T 512 (dropout 0) under
    GradientMergeOptimizer(AdamW, k_steps=GM_K) on GM_K micro-batches of
    GM_BATCH rows, against one AdamW step on the GM_K * GM_BATCH rows
    together, from the same state (the MLM feed masks N_MASK positions a
    row, so the mean of the micro-batch means is the big batch's mean).
    Gates: micro-steps 1..k-1 leave every parameter and AdamW moment and
    beta power bit-equal; the mean of the micro-batch losses is the big
    batch's; at step k the gradient the update applies, (buffer +
    gradient) / k, within GM_RTOL (Frobenius gap over the norm) of the
    big batch's gradient, and after it every parameter within GM_RTOL
    of the big step's; each float32 flash kernel launches 12 times a
    micro-step. The attention key biases' gradients (zero but for
    rounding) and the parameters that start at zero (their value after
    one AdamW step is the update, +-lr an element even where the
    gradient is rounding) are printed, not gated. Returns the
    launches."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.models import transformer

    t0 = time.perf_counter()
    cfg = transformer.bert_base(dropout=0.0, attn_dropout=0.0,
                                use_flash=True)
    rows = _mlm_feed(cfg, GM_K * GM_BATCH, seed=5)
    micro = []
    for i in range(GM_K):
        sl = slice(i * GM_BATCH, (i + 1) * GM_BATCH)
        pos = rows["mask_pos"].reshape(GM_K * GM_BATCH, N_MASK)[sl]
        micro.append({"tokens": rows["tokens"][sl],
                      "mask_pos": (pos - i * GM_BATCH * T).reshape(-1)
                      .astype(np.int32),
                      "mask_label": rows["mask_label"].reshape(
                          GM_K * GM_BATCH, N_MASK, 1)[sl].reshape(-1, 1)})
    main, startup, loss = build_grad_merge(ptt, transformer, cfg, GM_BATCH,
                                           GM_K)
    exe, scope = ptt.Executor(), ptt.Scope()
    exe.run(startup, scope=scope)
    init = {n: scope.get_numpy(n) for n in scope.names()}
    params = [p.name for p in main.all_parameters()]
    merge = {n for n in scope.names() if "_gradient_merge" in n
             or "@GRADIENT_MERGE_STEP@" in n}
    watched = [n for n in scope.names() if n not in merge]
    acc_of = {p: next(n for n in merge if n.startswith(p + "_gradient_merge"))
              for p in params}
    grads = [f"{p}@GRAD" for p in params]
    before = {n: scope.get(n).clone() for n in watched}
    _zero_launch_counts()
    losses = []
    for i, fd in enumerate(micro):
        last = i == GM_K - 1
        if last:  # the buffers before the last micro-step adds to them
            acc = {p: scope.get(acc_of[p]).clone() for p in params}
        got = exe.run(main, feed=fd, fetch_list=[loss] + (grads if last
                                                          else []),
                      scope=scope, return_numpy=False)
        losses.append(float(got[0]))
        if last:
            # the gradient the update applied: (acc + grad) / k, as the
            # program's elementwise_add and scale compute it
            applied = {p: ((acc[p] + g) * (1.0 / GM_K)).cpu().numpy()
                       for p, g in zip(params, got[1:])}
            del acc, got
        if not last:
            changed = [n for n in watched
                       if not torch.equal(scope.get(n), before[n])]
            check(not changed, f"[grad_merge] micro-step {i + 1} changed "
                  f"{changed[:5]}")
    launches = _launch_counts()
    check(all(n == 12 * GM_K for n in launches.values()),
          f"[grad_merge] flash launches {launches}, not 12 x {GM_K}")
    merged = {n: scope.get_numpy(n) for n in params}
    del scope, before
    big_main, big_startup, big_loss = build_grad_merge(
        ptt, transformer, cfg, GM_K * GM_BATCH, 1)
    names = {v.name for v in big_startup.list_vars() if v.persistable}

    sc = scope_from_numpy({n: v for n, v in init.items() if n in names},
                          ptt.Scope(), ptt.CUDAPlace(0))
    got = exe.run(big_main, feed=rows, fetch_list=[big_loss] + grads,
                  scope=sc)
    big = float(got[0])
    grad_gaps = {n: _fro_rel(applied[n], g) for n, g in zip(params, got[1:])}
    gaps = {n: _fro_rel(merged[n], sc.get_numpy(n)) for n in params}
    del got, sc
    moved = {n: _fro_rel(merged[n], init[n]) for n in params}
    # held apart: the attention key biases, whose gradients are zero but
    # for rounding (the softmax ignores a shift of a row's scores), and
    # the parameters that start at zero (the biases), whose value after
    # one AdamW step is its update alone: AdamW takes each gradient
    # element to about +-lr, so an element whose gradient is within
    # rounding of zero moves by +-lr on rounding alone
    key_b = {n for n in params if n.endswith(".att.k.b")}
    zero = {n for n in params if not np.any(init[n])}
    held_g = {n: g for n, g in grad_gaps.items() if n not in key_b}
    held_p = {n: g for n, g in gaps.items() if n not in zero}
    gw, pw = max(held_g, key=held_g.get), max(held_p, key=held_p.get)
    phase("grad_merge", k=GM_K, micro_batch=GM_BATCH, T=T,
          micro_losses=",".join(f"{x:.5f}" for x in losses),
          mean_micro_loss=f"{np.mean(losses):.6f}", big_loss=f"{big:.6f}",
          max_grad_gap=f"{held_g[gw]:.3e}", grad_worst=gw,
          median_grad_gap=f"{np.median(list(held_g.values())):.3e}",
          key_bias_grad_gap_max=f"{max(grad_gaps[n] for n in key_b):.3e}",
          max_param_gap=f"{held_p[pw]:.3e}", param_worst=pw,
          zero_init_params=len(zero),
          zero_init_param_gap_max=f"{max(gaps[n] for n in zero):.3e}",
          zero_init_over_rtol=sum(gaps[n] > GM_RTOL for n in zero),
          median_param_move=f"{np.median(list(moved.values())):.3e}",
          rtol=GM_RTOL,
          launches_per_micro_step=launches["flash_attention_fwd"] // GM_K,
          seconds=f"{time.perf_counter() - t0:.1f}", card=f"'{card}'")
    check(abs(np.mean(losses) - big) <= 1e-5 * abs(big),
          f"[grad_merge] mean micro loss {np.mean(losses)} vs {big}")
    check(held_g[gw] <= GM_RTOL, f"[grad_merge] the applied gradient vs "
          f"the big batch's: {gw} {held_g[gw]}")
    check(held_p[pw] <= GM_RTOL, f"[grad_merge] parameters after {GM_K} "
          f"micro-steps vs one big step: {pw} {held_p[pw]}")
    return launches


SOURCES = ("flash_attention_fwd", "flash_attention_bwd")
# kernel -> (its source under csrc/, the line of the TPU kernel it replaces)
KERNEL_SOURCES = {
    "flash_attention_fwd": ("flash_attention_fwd.cu", 63),
    "flash_attention_bwd_dq": ("flash_attention_bwd.cu", 191),
    "flash_attention_bwd_dkv": ("flash_attention_bwd.cu", 234),
}


def _kernel_name(symbol):
    """kernel<D, ...> for the mangled symbol of a kernel template with int
    arguments in a namespace (`_ZN<len><namespace><len><kernel>I<args>E`);
    any other symbol as it is."""
    import re
    pos, name = 3, None
    while symbol.startswith("_ZN") and (m := re.match(r"\d+",
                                                      symbol[pos:])):
        pos += len(m.group())
        name = symbol[pos:pos + int(m.group())]
        pos += int(m.group())
    args = re.match(r"I((?:Li\d+E)+)E", symbol[pos:])
    if name is None or args is None:
        return symbol
    return f"{name}<{', '.join(re.findall(r'Li(\d+)E', args.group(1)))}>"


def _ptxas_kernels(log):
    """(kernel<...>, registers, spill line) per kernel instance in nvcc's
    -Xptxas=-v output."""
    import re
    out, name, spills = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+?)'", line)
        if m:
            name, spills = _kernel_name(m.group(1)), ""
        elif "spill" in line:
            spills = line.strip()
        elif (regs := re.search(r"Used (\d+) registers", line)):
            out.append((name, int(regs.group(1)), spills))
    return out


def build_phase():
    """Compile every kernel source with nvcc, one process per source, all
    started together; print each kernel instance's registers and spills
    (from the log kept beside a library found built), and fail if any
    instance spills or a source has no ptxas log to read."""
    from concurrent.futures import ThreadPoolExecutor
    from paddle_tpu_torch.ops.cuda import build

    found = [n for n in SOURCES if os.path.exists(build.library_path(n))]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        logs = dict(zip(SOURCES, pool.map(lambda n: build.build(n)[1],
                                          SOURCES)))
    phase("build", sources=len(SOURCES),
          seconds=f"{time.perf_counter() - t0:.2f}",
          found_built=",".join(found) or None)
    spilled, unread = [], []
    for source, log in logs.items():
        # nvcc's and ptxas's warnings and notes (a wgmma pipeline ptxas
        # serialized, a setmaxnreg it ignored)
        for line in log.splitlines():
            if "warning" in line.lower() or "Performance" in line:
                print(f"  {source}: {line.strip()[:300]}", flush=True)
        kernels = _ptxas_kernels(log)
        if not kernels:
            unread.append(source)
        for name, regs, spills in kernels:
            print(f"  {source}: {name} {regs} registers; {spills}",
                  flush=True)
            if "0 bytes spill stores, 0 bytes spill loads" not in spills:
                spilled.append(name)
    check(not unread, f"no ptxas log to read for {unread}: delete the "
          f"library to rebuild it")
    check(not spilled, f"kernel instances that spill registers: {spilled}")


def smem_phase():
    """Print the wgmma kernels' dynamic shared memory per head dim, from
    the built libraries (ptxas reports only static shared memory)."""
    import ctypes
    from paddle_tpu_torch.ops.cuda import build
    for source, fn, kernel in (
            ("flash_attention_fwd", "flash_attention_fwd_smem",
             "fwd_kernel_wgmma"),
            ("flash_attention_fwd", "flash_attention_fwd_f32_smem",
             "fwd_kernel_tf32wg"),
            ("flash_attention_bwd", "flash_attention_bwd_dq_smem",
             "dq_kernel_wgmma"),
            ("flash_attention_bwd", "flash_attention_bwd_dkv_smem",
             "dkv_kernel_wgmma"),
            ("flash_attention_bwd", "flash_attention_bwd_dq_f32_smem",
             "dq_kernel_tf32wg"),
            ("flash_attention_bwd", "flash_attention_bwd_dkv_f32_smem",
             "dkv_kernel_tf32wg")):
        query = getattr(build.load(source), fn)
        query.argtypes, query.restype = [ctypes.c_int], ctypes.c_longlong
        print(f"  {source}: {kernel} dynamic shared memory: " + ", ".join(
            f"d {d} {query(d)} bytes" for d in (32, 64, 128)), flush=True)


# Mutation check of the kernels' limits: (name, source under csrc/, text,
# replacement, phases). Each breaks one rule of a kernel; `python3
# chip_smoke.py --mutants` runs the phases on a broken copy of the package
# in a temporary directory, with `check` printing instead of raising, and
# fails unless every mutant fails a check in each of its phases.
MUTANTS = [
    # bf16 forward: the accumulator not rescaled when the running max grows
    ("fwd_no_alpha", "flash_attention_fwd.cu",
     "o_acc[n][e] *= alpha[e >> 1];", "o_acc[n][e] *= 1.f;",
     ("kernel_phase",)),
    # bf16 and float32 forward: LSE left in log2 units
    ("fwd_lse_log2", "flash_attention_fwd.cu",
     "mrow[r] * sm_scale + logf(l_safe)",
     "mrow[r] * sm_scale * LOG2E + log2f(l_safe)", ("kernel_phase",)),
    # bf16 forward: keys past kv_len unmasked in the ragged last tile
    ("fwd_no_ragged_mask", "flash_attention_fwd.cu",
     "if (kc >= kv_len || (causal && kc > qr)) sc[n][i] = NEG_INF;",
     "if (causal && kc > qr) sc[n][i] = NEG_INF;", ("kernel_phase",)),
    # bf16 forward: keys after the query unmasked on the diagonal tile
    ("fwd_no_causal_mask", "flash_attention_fwd.cu",
     "if (kc >= kv_len || (causal && kc > qr)) sc[n][i] = NEG_INF;",
     "if (kc >= kv_len) sc[n][i] = NEG_INF;", ("kernel_phase",)),
    # bf16 dK/dV: dS from the bf16-rounded P instead of the float32 P
    ("dkv_ds_from_rounded_p", "flash_attention_bwd.cu",
     "dp[nn][e] = s[nn][e] * (dp[nn][e] - dcol) * sm_scale;",
     "dp[nn][e] = __bfloat162float(__float2bfloat16(s[nn][e])) * "
     "(dp[nn][e] - dcol) * sm_scale;", ("bwd_kernel_phase",)),
    # bf16 dK/dV: queries before the key unmasked on the diagonal tile
    ("dkv_no_causal_mask", "flash_attention_bwd.cu",
     "if (qr >= t || (causal && qr < kr)) s[nn][e] = NEG_INF;",
     "if (qr >= t) s[nn][e] = NEG_INF;",
     ("bwd_kernel_phase",)),
    # bf16 dQ: dS from the bf16-rounded P
    ("dq_ds_from_rounded_p", "flash_attention_bwd.cu",
     "dp[n][i] = s[n][i] * (dp[n][i] - dl[i >> 1]) * sm_scale;",
     "dp[n][i] = __bfloat162float(__float2bfloat16(s[n][i])) * "
     "(dp[n][i] - dl[i >> 1]) * sm_scale;", ("bwd_kernel_phase",)),
    # bf16 dQ: keys after the query unmasked on the diagonal tile. (Keys
    # past T unmasked in the ragged tile change nothing a check can read:
    # their rows of K are zero-filled, so their dS K terms are exactly 0.)
    ("dq_no_causal_mask", "flash_attention_bwd.cu",
     "if (kc >= t || (causal && kc > qr)) s[n][i] = NEG_INF;",
     "if (kc >= t) s[n][i] = NEG_INF;", ("bwd_kernel_phase",)),
    # bf16 dQ: a lane takes the LSE and delta of its first accumulator row
    # (g) for its second (g + 8), the slip the fragment layout invites
    ("dq_lse_first_row", "flash_attention_bwd.cu",
     "const int qr = row0 + g + 8 * h;", "const int qr = row0 + g;",
     ("bwd_kernel_phase",)),
    # float32 forward: S = Q K^T by one TF32 product (hi hi) instead of
    # three, P V as it is
    ("f32_one_tf32_product", "flash_attention_fwd.cu",
     "tf::wgmma_x3_rs<KR>(s, qa[kk], ql[kk], tf::desc<D>(s0, KR, kk),\n"
     "                          tf::desc<D>(s0 + KT, KR, kk), kk > 0);",
     "tf::wgmma_rs<KR>(s, qa[kk], tf::desc<D>(s0, KR, kk), kk > 0);",
     ("kernel_phase",)),
    # float32 forward, dQ and dK/dV (the TF32 wgmma issue, sm90_tf32::x3):
    # one TF32 product (hi hi) instead of three
    ("f32_bwd_one_tf32_product", "sm90_tf32.cuh",
     "  mma(1, 0);  // lo_a hi_b\n  mma(0, 1);  // hi_a lo_b\n", "",
     ("kernel_phase", "bwd_kernel_phase")),
    # float32 forward, dQ and dK/dV: the transposed B tiles (V^T; K^T; Q^T
    # and dO^T) written in natural key order, not in the order of the
    # register A operand made from an accumulator (0, 2, 4, 6, 1, 3, 5, 7)
    ("f32_bwd_natural_key_order", "sm90_tf32.cuh",
     "return (j & 1) * 4 + (j >> 1);", "return j;",
     ("kernel_phase", "bwd_kernel_phase")),
    # float32 dQ and dK/dV: the transposed tiles' lo written as zero (K's
    # in dQ += dS K; Q's and dO's in dK and dV)
    ("f32_bwd_transposed_lo_zero", "sm90_tf32.cuh",
     "sts(lo_t + o, l[e]);", "sts(lo_t + o, 0u);", ("bwd_kernel_phase",)),
    # float32 forward: keys past kv_len unmasked in the ragged last tile
    # (its softmax told that every key of the tile is below kv_len)
    ("fwd_f32_no_ragged_mask", "flash_attention_fwd.cu",
     "fwd_softmax<KR>(s, mrow, l, alpha, kt * KR, kv_len, causal, qw0,",
     "fwd_softmax<KR>(s, mrow, l, alpha, kt * KR, kv_len + KR, causal, qw0,",
     ("kernel_phase",)),
    # float32 forward: keys after the query unmasked on the diagonal tile
    ("fwd_f32_no_causal_mask", "flash_attention_fwd.cu",
     "fwd_softmax<KR>(s, mrow, l, alpha, kt * KR, kv_len, causal, qw0,",
     "fwd_softmax<KR>(s, mrow, l, alpha, kt * KR, kv_len, 0, qw0,",
     ("kernel_phase",)),
    # float32 forward: O not rescaled when the running max grows
    ("fwd_f32_no_alpha", "flash_attention_fwd.cu",
     "o[nn][e] *= alpha[e >> 1];", "o[nn][e] *= 1.f;", ("kernel_phase",)),
    # float32 dK/dV: queries before the key unmasked on the diagonal tile
    ("dkv_f32_no_causal_mask", "flash_attention_bwd.cu",
     "if (query >= t || (causal && query < key)) s[nn][e] = NEG_INF;",
     "if (query >= t) s[nn][e] = NEG_INF;", ("bwd_kernel_phase",)),
    # float32 dQ: keys after the query unmasked on the diagonal tile
    ("dq_f32_no_causal_mask", "flash_attention_bwd.cu",
     "if (key >= t || (causal && key > query)) s[n][e] = NEG_INF;",
     "if (key >= t) s[n][e] = NEG_INF;", ("bwd_kernel_phase",)),
]


# Ablations of the wgmma kernels: (name, [(source under csrc/, text,
# replacement), ...]). Each drops one part of a kernel's work (its results
# are then wrong); `python3 chip_smoke.py --ablations` times the bf16 and
# float32 forward, dQ and dK/dV of a copy of the package with that part
# dropped, beside the unchanged copy ("none"), which says what holds each
# kernel back (PERF.md).
ABLATIONS = [
    ("none", []),
    # forward: the online softmax (masking, max, exp, sums)
    ("fwd_no_softmax", [
        ("flash_attention_fwd.cu", "      float alpha[2];\n",
         "      float alpha[2] = {1.f, 1.f};\n"),
        ("flash_attention_fwd.cu", "fwd_softmax<BK>(sc, mrow, l, alpha, 0,",
         "if (0) fwd_softmax<BK>(sc, mrow, l, alpha, 0,"),
        ("flash_attention_fwd.cu",
         "fwd_softmax<BK>(sc, mrow, l, alpha, kt * BK,",
         "if (0) fwd_softmax<BK>(sc, mrow, l, alpha, kt * BK,")]),
    # forward: the P V products
    ("fwd_no_pv", [
        ("flash_attention_fwd.cu",
         "for (int kk = 0; kk < BK / 16; ++kk)\n    wgmma_rs<D>(o_acc",
         "for (int kk = 0; kk < 0; ++kk)\n    wgmma_rs<D>(o_acc")]),
    # forward: staging and storing O. The staging is skipped on a test of
    # the accumulator, not dropped: with no reader of O's accumulator left,
    # ptxas deletes the P V wgmmas as dead code
    ("fwd_no_epilogue", [
        ("flash_attention_fwd.cu", "stage_rows<D, D>(o_tile,",
         "if (o_acc[0][0] == 0.5f) stage_rows<D, D>(o_tile,"),
        ("flash_attention_fwd.cu", "tma_store_3d(&o_map, o_tile",
         "if (0) tma_store_3d(&o_map, o_tile")]),
    # forward: the K and V loads (the ring's barriers still turn)
    ("fwd_no_kv_loads", [
        ("flash_attention_fwd.cu", "mbar_expect_tx(k_full + 8 * st, KTILE);",
         "mbar_expect_tx(k_full + 8 * st, 0); if (0)"),
        ("flash_attention_fwd.cu", "mbar_expect_tx(v_full + 8 * st, KTILE);",
         "mbar_expect_tx(v_full + 8 * st, 0); if (0)")]),
    # dK/dV: the exp of P^T
    ("dkv_no_exp", [
        ("flash_attention_bwd.cu",
         "s[nn][e] = exp2_approx(\n                  fmaf(s[nn][e], scale, "
         "-((e & 1) ? lq.y : lq.x) * LOG2E));",
         "s[nn][e] = fmaf(s[nn][e], scale, -((e & 1) ? lq.y : lq.x) * "
         "LOG2E);")]),
    # dK/dV: the dV and dK products (and with them P^T's and dS^T's bf16
    # packing, and dS^T, which only they read: ptxas drops dead code)
    ("dkv_no_dv_dk", [
        ("flash_attention_bwd.cu",
         "for (int kk = 0; kk < QC / 16; ++kk)\n            wgmma_rs<DN>(acc_v",
         "for (int kk = 0; kk < 0; ++kk)\n            wgmma_rs<DN>(acc_v"),
        ("flash_attention_bwd.cu",
         "for (int kk = 0; kk < QC / 16; ++kk)\n            wgmma_rs<DN>(acc_k",
         "for (int kk = 0; kk < 0; ++kk)\n            wgmma_rs<DN>(acc_k")]),
    # dK/dV: the Q and dO loads (the ring's barriers still turn)
    ("dkv_no_q_loads", [
        ("flash_attention_bwd.cu", "mbar_expect_tx(bar, 2 * QTILE);",
         "mbar_expect_tx(bar, 0); if (0)")]),
    # dQ: the exp of P
    ("dq_no_exp", [
        ("flash_attention_bwd.cu",
         "s[n][i] = exp2_approx(fmaf(s[n][i], scale, -lse2[i >> 1]));",
         "s[n][i] = fmaf(s[n][i], scale, -lse2[i >> 1]);")]),
    # dQ: the dP = dO V^T products
    ("dq_no_dp", [
        ("flash_attention_bwd.cu",
         "for (int kk = 0; kk < D / 16; ++kk)\n    wgmma_ss<KR>(dp,",
         "for (int kk = 0; kk < 0; ++kk)\n    wgmma_ss<KR>(dp,")]),
    # dQ: the dQ += dS K products (and with them dS and its bf16
    # packing, which only they read)
    ("dq_no_dsk", [
        ("flash_attention_bwd.cu",
         "for (int kk = 0; kk < KR / 16; ++kk)\n    wgmma_rs<D>(acc, da[kk]",
         "for (int kk = 0; kk < 0; ++kk)\n    wgmma_rs<D>(acc, da[kk]")]),
    # dQ: the K and V loads (the ring's barriers still turn)
    ("dq_no_kv_loads", [
        ("flash_attention_bwd.cu",
         "mbar_expect_tx(bar, 2 * KTILE);",
         "mbar_expect_tx(bar, 0); if (0)")]),
    # dQ: the TMA store of dQ (staged all the same)
    ("dq_no_store", [
        ("flash_attention_bwd.cu", "tma_store_3d(&dq_map, dq_stage",
         "if (0) tma_store_3d(&dq_map, dq_stage")]),
    # dQ: every tile's dQ stored to the first tile of head 0, so the
    # stores stay in L2 and add no traffic to device memory
    ("dq_store_one_tile", [
        ("flash_attention_bwd.cu", "b * G::ELEMS, qw0, bh);",
         "b * G::ELEMS, wg * 64, 0);")]),
    # dQ: staging and storing dQ (the staging skipped on a test of the
    # accumulator, as in fwd_no_epilogue, so the dS K wgmmas stay)
    ("dq_no_epilogue", [
        ("flash_attention_bwd.cu", "stage_rows<D, D>(dq_stage,",
         "if (acc[0][0] == 0.5f) stage_rows<D, D>(dq_stage,"),
        ("flash_attention_bwd.cu", "tma_store_3d(&dq_map, dq_stage",
         "if (0) tma_store_3d(&dq_map, dq_stage")]),
    # float32 forward, dQ and dK/dV: the split stage (the consumers read
    # the raw tiles as hi, and lo and transposed tiles as they stand)
    ("f32_bwd_no_split", [
        ("sm90_tf32.cuh", "idx < R * C / 4; idx += nthreads",
         "idx < 0; idx += nthreads")]),
    # float32 forward, dQ and dK/dV: the two lo products of every 3xTF32 k
    # step
    ("f32_bwd_no_lo", [
        ("sm90_tf32.cuh",
         "  mma(1, 0);  // lo_a hi_b\n  mma(0, 1);  // hi_a lo_b\n", "")]),
    # float32 dQ and dK/dV: every TMA load, the ring's and the resident
    # tiles' (the barriers still turn)
    ("f32_bwd_no_loads", [
        ("flash_attention_bwd.cu", "mbar_expect_tx(bar, 2 * KT);",
         "mbar_expect_tx(bar, 0); if (0)"),
        ("flash_attention_bwd.cu", "mbar_expect_tx(q_full, 2 * NC * CT);",
         "mbar_expect_tx(q_full, 0); if (0)"),
        ("flash_attention_bwd.cu", "mbar_expect_tx(bar, 2 * QT);",
         "mbar_expect_tx(bar, 0); if (0)"),
        ("flash_attention_bwd.cu", "mbar_expect_tx(kv_full, 2 * NC * CT);",
         "mbar_expect_tx(kv_full, 0); if (0)")]),
    # float32 dQ and dK/dV: staging and storing the results (the staging
    # skipped on a test of each accumulator, so its wgmmas stay)
    ("f32_bwd_no_epilogue", [
        ("flash_attention_bwd.cu", "tf::stage_rows<D, D>(qh,",
         "if (acc[0][0] == 0.5f) tf::stage_rows<D, D>(qh,"),
        ("flash_attention_bwd.cu", "tma_store_3d(&dq_map, qh",
         "if (0) tma_store_3d(&dq_map, qh"),
        ("flash_attention_bwd.cu", "tf::stage_rows<D, DN>(kh,",
         "if (acc_k[0][0] == 0.5f) tf::stage_rows<D, DN>(kh,"),
        ("flash_attention_bwd.cu", "tf::stage_rows<D, DN>(vh,",
         "if (acc_v[0][0] == 0.5f) tf::stage_rows<D, DN>(vh,"),
        ("flash_attention_bwd.cu", "tma_store_3d(&dk_map, kh",
         "if (0) tma_store_3d(&dk_map, kh"),
        ("flash_attention_bwd.cu", "tma_store_3d(&dv_map, vh",
         "if (0) tma_store_3d(&dv_map, vh")]),
    # float32 dQ and dK/dV (and forward): hi rounded by integer operations
    # (the same bits as cvt.rna.tf32 for finite x), a diagnostic of what the
    # conversion costs
    ("f32_bwd_int_round", [
        ("mma_tf32.cuh",
         '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(y) : "f"(x));',
         "  y = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;")]),
    # float32 forward alone: the split warps' work (K into hi and lo, V into
    # V^T's hi and lo); Q's split in the consumers' registers stays
    ("f32_fwd_no_split", [
        ("flash_attention_fwd.cu", "tf::split_transposed_task<KR, D>(",
         "if (0) tf::split_transposed_task<KR, D>("),
        ("flash_attention_fwd.cu", "tf::split_chunk<KR, D>(",
         "if (0) tf::split_chunk<KR, D>(")]),
    # float32 forward alone: S and P V by hi hi only (up to d = 64)
    ("f32_fwd_no_lo", [
        ("flash_attention_fwd.cu",
         "tf::wgmma_x3_rs<KR>(s, qa[kk], ql[kk], tf::desc<D>(s0, KR, kk),\n"
         "                          tf::desc<D>(s0 + KT, KR, kk), kk > 0);",
         "tf::wgmma_rs<KR>(s, qa[kk], tf::desc<D>(s0, KR, kk), kk > 0);"),
        ("flash_attention_fwd.cu",
         "tf::wgmma_x3_rs<D>(o, ph[j], pl[j], tf::desc<KR>(s0 + 3 * KT, D, j),"
         "\n                       tf::desc<KR>(s0 + 4 * KT, D, j));",
         "tf::wgmma_rs<D>(o, ph[j], tf::desc<KR>(s0 + 3 * KT, D, j), 1);")]),
    # float32 forward: every TMA load, Q's and the ring's (the barriers
    # still turn)
    ("f32_fwd_no_loads", [
        ("flash_attention_fwd.cu", "mbar_expect_tx(q_full, NC * CT);",
         "mbar_expect_tx(q_full, 0); if (0)"),
        ("flash_attention_fwd.cu", "mbar_expect_tx(bar, 2 * KT);",
         "mbar_expect_tx(bar, 0); if (0)")]),
    # float32 forward: the online softmax (masking, max, exp, sums); P V
    # takes the raw scores
    ("f32_fwd_no_softmax", [
        ("flash_attention_fwd.cu", "l[2] = {0.f, 0.f}, alpha[2];",
         "l[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};"),
        ("flash_attention_fwd.cu",
         "fwd_softmax<KR>(s, mrow, l, alpha, kt * KR, kv_len, causal, qw0,",
         "if (0) fwd_softmax<KR>(s, mrow, l, alpha, kt * KR, kv_len, causal, "
         "qw0,")]),
    # float32 forward: staging and storing O (the staging skipped on a test
    # of the accumulator, so the P V wgmmas stay)
    ("f32_fwd_no_epilogue", [
        ("flash_attention_fwd.cu", "tf::stage_rows<D, D>(stage,",
         "if (o[0][0] == 0.5f) tf::stage_rows<D, D>(stage,"),
        ("flash_attention_fwd.cu", "tma_store_3d(&o_map, stage",
         "if (0) tma_store_3d(&o_map, stage")]),
]


def ablation_times(torch):
    """[ablation_time] line: the bf16 forward, dQ and dK/dV of the
    paddle_tpu_torch first on sys.path, at the BERT and GPT training
    shapes, and the float32 forward, dQ and dK/dV at the float32 BERT
    training shape (mean of 50 launches each, CUDA events)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    out = {}
    for (bh, t, d), causal, key in ((TRAIN_SHAPE, False, ""),
                                    (GPT_SHAPE, True, "causal_")):
        args = _inputs(torch, fa, gen, bh, t, d, torch.bfloat16, causal)
        q, k, v = args[:3]
        out[f"{key}fwd_ms"] = cuda_ms(
            lambda: fa.flash_attention_fwd(q, k, v, causal=causal), iters=50)
        out[f"{key}dq_ms"] = cuda_ms(
            lambda: fa.flash_attention_bwd_dq(*args, causal=causal),
            iters=50)
        out[f"{key}dkv_ms"] = cuda_ms(
            lambda: fa.flash_attention_bwd_dkv(*args, causal=causal),
            iters=50)
    args = _inputs(torch, fa, gen, *F32_TRAIN_SHAPE, torch.float32, False)
    q, k, v = args[:3]
    out["f32_fwd_ms"] = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v),
                                iters=50)
    out["f32_dq_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_dq(*args),
                               iters=50)
    out["f32_dkv_ms"] = cuda_ms(lambda: fa.flash_attention_bwd_dkv(*args),
                                iters=50)
    phase("ablation_time", **{k: f"{v:.4f}" for k, v in out.items()})


def ablation_phase():
    """Build a copy of the package per entry of ABLATIONS (in parallel),
    then time each (ablation_times) in a process of its own; print
    `[ablation] <name>` lines."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="ptt_ablation_") as tmp:
        def prepare(entry):
            name, edits = entry
            tree = os.path.join(tmp, name)
            shutil.copytree(os.path.join(root, "paddle_tpu_torch"),
                            os.path.join(tree, "paddle_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            shutil.copy(os.path.join(root, "chip_smoke.py"), tree)
            for source, old, new in edits:
                path = os.path.join(tree, "paddle_tpu_torch", "csrc", source)
                with open(path) as f:
                    text = f.read()
                check(text.count(old) == 1,
                      f"ablation {name}: its text is not in {source} once")
                with open(path, "w") as f:
                    f.write(text.replace(old, new))
            env = {**os.environ,
                   "PADDLE_TPU_TORCH_BUILD_DIR": os.path.join(tree, "b")}
            subprocess.run([sys.executable, "-c", (
                "import sys; sys.path.insert(0, '.'); from paddle_tpu_torch"
                ".ops.cuda import build; [build.build(n) for n in "
                f"{SOURCES!r}]")], cwd=tree, env=env, check=True,
                capture_output=True)
            return name, tree, env

        with ThreadPoolExecutor(4) as pool:
            trees = list(pool.map(prepare, ABLATIONS))
        for name, tree, env in trees:
            proc = subprocess.run(
                [sys.executable, "-c", "import sys, torch; sys.path.insert("
                 "0, '.'); import chip_smoke as c; c.ablation_times(torch)"],
                cwd=tree, env=env, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)
            for ln in proc.stdout.splitlines():
                if ln.startswith("[ablation_time]"):
                    print(f"[ablation] {name} {ln}", flush=True)
            check(proc.returncode == 0,
                  f"ablation {name} failed:\n{proc.stdout[-2000:]}")


def mutant_phase():
    """Run each of MUTANTS; print its phases' check lines and failed
    checks as `[mutant]` lines. Returns the names of mutants that some
    phase of theirs did not catch."""
    import shutil
    root = os.path.dirname(os.path.abspath(__file__))
    missed = []
    for name, source, old, new, fns in MUTANTS:
        with tempfile.TemporaryDirectory(prefix="ptt_mutant_") as tmp:
            shutil.copytree(os.path.join(root, "paddle_tpu_torch"),
                            os.path.join(tmp, "paddle_tpu_torch"),
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            shutil.copy(os.path.join(root, "chip_smoke.py"), tmp)
            path = os.path.join(tmp, "paddle_tpu_torch", "csrc", source)
            with open(path) as f:
                text = f.read()
            check(text.count(old) == 1,
                  f"mutant {name}: its text is not in {source} once")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
            code = ("import sys, torch; sys.path.insert(0, '.'); "
                    "import chip_smoke as c; c.check = lambda ok, msg: ok "
                    "or print('[failed] ' + msg[:300], flush=True); "
                    "c.build_phase(); " + "; ".join(
                        f"print('[phase] {fn}', flush=True); "
                        f"c.{fn}(torch)" for fn in fns))
            proc = subprocess.run(
                [sys.executable, "-c", code], cwd=tmp, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                env={**os.environ,
                     "PADDLE_TPU_TORCH_BUILD_DIR": os.path.join(tmp, "b")})
        # caught per phase: a failed check in its lines, or the process
        # failing while it ran
        caught, current = {}, None
        for ln in proc.stdout.splitlines():
            if ln.startswith("[phase] "):
                current = ln.split()[1]
                caught[current] = False
            elif ln.startswith(("[kernel", "[failed]")):
                print(f"[mutant] {name} {ln}", flush=True)
                if ln.startswith("[failed]") and current:
                    caught[current] = True
        if proc.returncode != 0 and current:
            caught[current] = True
        phase("mutant", name=name, rc=proc.returncode,
              caught=all(caught.get(fn, False) for fn in fns),
              **{f"caught_{fn}": caught.get(fn, False) for fn in fns})
        if proc.returncode != 0:
            print(proc.stdout[-2000:], flush=True)
        if not all(caught.get(fn, False) for fn in fns):
            missed.append(name)
    return missed


def time_phase(torch):
    """[kernel_time] lines of the three bf16 kernels at the shapes their
    redesign is judged at: the BERT training path's [384, 512, 64], GPT's
    [384, 511, 64] causal, and [24, 512, 128] in both masks; then of the
    three float32 kernels beside float32 SDPA's forward and backward at
    the float32 training path's [192, 512, 64] and at [48, 512, 128], and
    of the float32 forward at the serving path's batch 8 and 1, [96, 512,
    64] and [12, 512, 64], each in both masks. Takes the wrappers of
    whichever paddle_tpu_torch is first on sys.path (for --compare,
    another tree's)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    for shape, causal in ((TRAIN_SHAPE, False), (GPT_SHAPE, True),
                          (D128_SHAPE, False), (D128_SHAPE, True)):
        time_kernels(torch, fa, gen, shape, torch.bfloat16, ALL3, causal)
    for shape, names in ((F32_TRAIN_SHAPE, ALL3), (F32_D128_SHAPE, ALL3),
                         ((96, T, HD), FWD), ((12, T, HD), FWD)):
        for causal in (False, True):
            time_kernels(torch, fa, gen, shape, torch.float32, names, causal)


def compare_phase(other):
    """Build and time (time_phase) the kernels of another checkout at
    `other` and of this one in turns on the same card, other, this, this,
    other, one process each; print each process's [build] and
    [kernel_time] lines prefixed `[compare] <tree>`."""
    script = os.path.abspath(__file__)
    root = os.path.dirname(script)
    other = os.path.abspath(other)
    for label, tree in (("parent", other), ("change", root),
                        ("change", root), ("parent", other)):
        code = ("import sys, torch; sys.path.insert(0, {tree!r}); "
                "import importlib.util as u; "
                "s = u.spec_from_file_location('chip_smoke', {script!r}); "
                "c = u.module_from_spec(s); s.loader.exec_module(c); "
                "c.build_phase(); c.time_phase(torch)").format(
                    tree=tree, script=script)
        env = {k: v for k, v in os.environ.items()
               if k != "PADDLE_TPU_TORCH_BUILD_DIR"}
        proc = subprocess.run([sys.executable, "-c", code], cwd=tree,
                              text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env)
        for ln in proc.stdout.splitlines():
            if ln.startswith(("[build]", "[kernel_time]", "  ")):
                print(f"[compare] {label} {ln}", flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], flush=True)
        check(proc.returncode == 0, f"the {label} tree's timing failed")


# --- data parallelism: rank processes over torch.distributed ------------

# [dp_train] / [zero_train]: bench.py's BERT-base step (b32 T512 bf16
# AMP, AdamW, dropout 0 so the ranks' random bits cannot differ from the
# one-rank run's) over DP_WORLD rank processes, DP_STEPS steps from one
# startup state, held to the one-rank b32 steps by DP_BARS:
# - loss: the largest loss gap over the steps;
# - update: |params - one-rank params| / |one-rank params - startup|
#   (2-norms over every parameter): the share of the steps' movement in
#   which the runs differ. AdamW's step is about lr wherever a gradient
#   is not rounding, so a largest-element gap cannot tell rounding from
#   an unsynced rank; this norm can;
# - grad: |g - g1| / |g1| of the first step's averaged gradient of the
#   largest dense weight against the one-rank run's (a ZeRO rank's rows
#   against the same rows). AdamW is scale-invariant, so a sum over the
#   ranks in place of the mean moves neither loss nor update: this gate
#   sees it.
# Each bar lies between two readings at this cell's size (PERF.md §6):
# the two-rank run's own (rounding: the rows are summed in another
# order) and the controls DP_CONTROLS, the same two-rank run broken on
# purpose, which dp_phases runs every time and which must fail a bar.
# On an H100 80GB HBM3 at 700 W, loss / update / grad: two ranks
# 6.771e-05 / 1.280e-02 / 2.827e-03, no_sync 1.692e-01 / 8.962e-01 /
# 9.641e-01, sum 1.266e-03 / 4.689e-02 / 1.000.
# tools/torch_rounding_sensitivity.py dp takes the same readings on the
# CPU at a small size.
DP_WORLD = 2
DP_STEPS = 5
DP_BARS = {"loss": 1e-3, "update": 0.1, "grad": 0.05}
# no_sync: each rank updates on its own rows' gradient (the sync
# skipped), caught by `update`; sum: the ranks' gradients summed, not
# averaged, caught by `grad`
DP_CONTROLS = {"no_sync": "update", "sum": "grad"}
# [zero_train] against [dp_train]: the same sums in the same order
# (reduce-scatter's block of two ranks' rows is all-reduce's), so only
# the sharded update's rounding can part them (3.725e-09 in the
# parameters, the losses equal, on the H100); the loss bar is 10 float32
# ulps at 10
ZERO_BARS = {"loss": 1e-5, "param": 1e-6}
DP_TIMEOUT_S = 900.0
# [dygraph_dp]: make_dygraph_bert at DYGRAPH_DP_LAYERS layers, global
# batch DYGRAPH_DP_BATCH, DYGRAPH_DP_STEPS eager AdamW steps, float32;
# its bars read as DP_BARS' do, between the two-rank run's reading and
# the same controls' (H100: two ranks 9.537e-07 / 2.111e-06 /
# 1.293e-06, no_sync 6.487e-02 / 7.453e-01 / 1.018, sum 3.014e-03 /
# 7.286e-02 / 1.000)
DYGRAPH_DP_LAYERS, DYGRAPH_DP_BATCH, DYGRAPH_DP_STEPS = 2, 16, 3
DYGRAPH_DP_BARS = {"loss": 1e-4, "update": 1e-3, "grad": 1e-3}
# [collectives]: each c_* op on the card against the host's result
COLLECTIVE_TOL = 1e-5


def dp_backend(torch):
    """(backend, device of each rank): NCCL with one card a rank where
    the machine has DP_WORLD cards, else gloo with every rank on cuda:0
    (NCCL refuses two ranks on one card). Chosen here and printed, never
    switched silently."""
    if torch.cuda.device_count() >= DP_WORLD:
        return "nccl", "cuda:rank"
    return "gloo", "cuda:0"


def _dp_feed(vocab, batch, t):
    import numpy as np
    toks = np.random.RandomState(0).randint(0, vocab, (batch, t)) \
        .astype("int64")
    return {"tokens": toks, "labels": toks}


def _dp_build(ptt, spec):
    from paddle_tpu_torch.models import transformer
    cfg = transformer.bert_base(dropout=0.0, attn_dropout=0.0,
                                use_flash=spec["flash"], **spec["cfg"])
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss, _ = transformer.build_train(cfg, spec["batch"], spec["T"],
                                          lr=1e-4, amp=spec["amp"])
    return cfg, main, startup, loss


def _place(ptt, spec):
    return ptt.CPUPlace() if spec["place"] == "cpu" else ptt.CUDAPlace(0)


def _dp_control(kind):
    """Break this process's data-parallel gradient sync on purpose, as a
    control for DP_BARS: 'no_sync' skips it, 'sum' leaves the ranks'
    gradients summed. Returns the function that repairs it."""
    from paddle_tpu_torch.parallel import data_parallel as dpm
    sync = dpm.DataParallelPlan._sync_grads

    def broken(self, env):
        if kind == "no_sync":
            return
        sync(self, env)
        for g in self.reduced + self.scattered:
            if g in env:
                env[g] = env[g] * self.dp
    dpm.DataParallelPlan._sync_grads = broken
    return lambda: setattr(dpm.DataParallelPlan, "_sync_grads", sync)


def _rel_gap(got, ref, base):
    """|got - ref| / |ref - base|: 2-norms over the shared keys."""
    import numpy as np
    num = sum(float(np.sum((got[k].astype(np.float64) - ref[k]) ** 2))
              for k in ref)
    den = sum(float(np.sum((ref[k].astype(np.float64) - base[k]) ** 2))
              for k in ref)
    return math.sqrt(num / den) if den > 0 else math.inf


def _grad_gap(grad, ref, rank):
    """|grad - ref| / |ref|, a ZeRO rank's rows against ref's same rows."""
    import numpy as np
    if grad.shape != ref.shape:
        n = grad.shape[0]
        ref = ref[rank * n:(rank + 1) * n]
    ref = ref.astype(np.float64)
    return float(np.linalg.norm(grad - ref) / np.linalg.norm(ref))


def dp_train_run(spec):
    """The BERT step of `spec` (cfg, batch, T, amp, flash, place, steps,
    init: an npz of the startup state, mesh: a FLAGS_sharded_mesh for
    ZeRO or None, ref: an npz of parameters to hold the final ones to,
    out: where rank 0 (or the one-rank run) writes its final parameters,
    control: a _dp_control kind or None) through
    CompiledProgram.with_data_parallel in this process: one rank of a
    process group, or the whole batch without one. The first step also
    fetches the largest dense weight's gradient (a second cache entry
    runs the later steps). Returns the losses (the loss_name fetch: the
    ranks' mean), that gradient, per step host and device ms, the flash
    launches of the steps after the first, gradient and staged bytes a
    step, the moments' bytes, the program's peak (less what the process
    held before, scope excluded) beside the planner's per-rank device
    peak, and the largest parameter gap and the update gap (_rel_gap)
    to `ref`. Runs under torch's deterministic algorithms."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.ops import collective as coll
    from paddle_tpu_torch.parallel import data_parallel as dpm
    from paddle_tpu_torch.parallel.mesh import world

    cuda = spec["place"] != "cpu"
    ptt.set_flags({"FLAGS_sharded_exec": spec["mesh"] is not None,
                   "FLAGS_sharded_mesh": spec["mesh"] or ""})
    repair = _dp_control(spec["control"]) if spec.get("control") \
        else None
    # the embedding's backward scatter-adds with atomics on the card:
    # without this, two runs of the same sums differ by their order
    # (zero_train's parameters read 1.463e-05 and 3.725e-09 from
    # dp_train's in two runs of one tree)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg, main, startup, loss = _dp_build(ptt, spec)
        place = _place(ptt, spec)
        scope = ptt.Scope()
        exe = ptt.Executor(place)
        exe.run(startup, scope=scope)
        init = dict(np.load(spec["init"]))
        scope_from_numpy(init, scope, place, program=main)
        prog = ptt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        feed = _dp_feed(cfg.vocab_size, spec["batch"], spec["T"])
        dense = max((p for p in main.all_parameters()
                     if len(p.shape) == 2 and p.shape[0] != cfg.vocab_size),
                    key=lambda p: int(np.prod(p.shape)))
        first = exe.run(prog, feed=feed, fetch_list=[loss,
                                                     dense.name + "@GRAD"],
                        scope=scope)
        losses = [float(first[0])]
        coll.reset_counts()
        dpm.GRAD_SYNC_BYTES["bytes"] = 0
        _zero_launch_counts()
        host, device, peaks = [], [], []
        for _ in range(spec["steps"] - 1):
            if cuda:
                torch.cuda.synchronize()
                foreign = torch.cuda.memory_allocated() - \
                    scope_device_bytes(torch, scope)
                torch.cuda.reset_peak_memory_stats()
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                ev[0].record()
            t0 = time.perf_counter()
            out = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope,
                          return_numpy=False)
            host.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(out[0]))
            if cuda:
                ev[1].record()
                torch.cuda.synchronize()
                device.append(ev[0].elapsed_time(ev[1]))
                peaks.append((torch.cuda.max_memory_allocated() - foreign)
                              / 1e9)
        launches = _launch_counts()
        n = max(spec["steps"] - 1, 1)
        params = {v.name: scope.get_numpy(v.name) for v in main.list_vars()
                  if getattr(v, "is_parameter", False)}
        gap = update_gap = None
        if spec.get("ref"):
            ref = dict(np.load(spec["ref"]))
            gap = max(float(np.abs(params[k].astype(np.float64)
                                   - ref[k]).max()) for k in params)
            update_gap = _rel_gap(params, ref, init)
        size, rank = world()
        if spec.get("out") and rank == 0:
            np.savez(spec["out"], **params)
        moments = sum(int(np.prod(scope.find_var(k).shape)) *
                      scope.find_var(k).element_size()
                      for k in scope.names() if "_moment" in k)
        res = {"rank": rank, "world": size, "losses": losses,
               "grad": np.asarray(first[1], np.float32),
               "update_gap": update_gap,
               "host_ms": host, "device_ms": device, "launches": launches,
               "grad_bytes_step": dpm.GRAD_SYNC_BYTES["bytes"] // n,
               "staged_bytes_step": coll.STAGED_BYTES["bytes"] // n,
               "moment_bytes": moments, "param_gap": gap,
               "peak_gb": max(peaks) if peaks else None}
        if prog.layout() is not None or size > 1:
            from paddle_tpu_torch.parallel.data_parallel import \
                local_program
            from paddle_tpu_torch.parallel.layout import MeshDims, \
                SpecLayout
            layout = prog.layout()
            if layout is None:
                layout = SpecLayout(MeshDims((size,))).add_program(main)
            res["layout_grad_sync_bytes"] = layout.gradient_sync_bytes(main)
            res["collective_bytes_estimate"] = \
                layout.collective_bytes_estimate(main)
            res["fallbacks"] = len(layout.fallbacks)
            rows = spec["batch"] // size
            local = {k: v[rank * rows:(rank + 1) * rows]
                     for k, v in feed.items()}
            plan = planned_plan(local_program(main, spec["batch"], rows),
                                local, [loss], layout=prog.layout())
            res["plan"] = {"device_peak_bytes": plan.device_peak_bytes,
                           "peak_bytes": plan.peak_bytes,
                           "device_charges": plan.device_charges}
        return res
    finally:
        if repair is not None:
            repair()
        torch.use_deterministic_algorithms(was)
        ptt.set_flags({"FLAGS_sharded_exec": False,
                       "FLAGS_sharded_mesh": ""})


def dp_startup_state(spec, path):
    """Run the startup of `spec`'s program on its place and write every
    persistable to `path` (an npz)."""
    import numpy as np
    import paddle_tpu_torch as ptt
    _, main, startup, _ = _dp_build(ptt, spec)
    scope = ptt.Scope()
    ptt.Executor(_place(ptt, spec)).run(startup, scope=scope)
    np.savez(path, **{n: scope.get_numpy(n) for n in scope.names()})


def _plan_gate_of(tag, res, card):
    """plan_gate on a rank's result dict."""
    class _Plan:
        pass
    p = _Plan()
    p.device_peak_bytes = res["plan"]["device_peak_bytes"]
    p.peak_bytes = res["plan"]["peak_bytes"]
    p.device_charges = res["plan"]["device_charges"]
    return plan_gate(tag, p, res["peak_gb"], 0.0, card)


def _dp_gaps(res, ref_losses, one_grad):
    """(loss gap, update gap, gradient gap) of a rank's result."""
    loss_gap = max(abs(a - b) for a, b in zip(res["losses"], ref_losses))
    return (loss_gap, res["update_gap"],
            _grad_gap(res["grad"], one_grad, res["rank"]))


def _dp_line(tag, res, one, backend, card, zero_ref=None, **extra):
    """The per-rank line of a data-parallel training phase and its bars:
    the loss, update and gradient gaps to the one-rank run `one` within
    DP_BARS (for [zero_train], its losses and parameters against the
    [dp_train] rank `zero_ref`'s within ZERO_BARS instead of the first
    two), each flash kernel 12 times a step."""
    import statistics
    loss_gap, update_gap, grad_gap = _dp_gaps(res, one["losses"],
                                              one["grad"])
    steps = DP_STEPS - 1
    gates = {"grad_gap": (grad_gap, DP_BARS["grad"])}
    if zero_ref is None:
        gates.update(loss_gap=(loss_gap, DP_BARS["loss"]),
                     update_gap=(update_gap, DP_BARS["update"]))
    else:
        dp_loss = max(abs(a - b) for a, b in zip(res["losses"],
                                                 zero_ref["losses"]))
        gates.update(loss_gap_to_dp=(dp_loss, ZERO_BARS["loss"]),
                     param_gap_to_dp=(res["param_gap"],
                                      ZERO_BARS["param"]))
    phase(tag, rank=res["rank"], world=res["world"], backend=backend,
          steps=DP_STEPS,
          host_ms_median=f"{statistics.median(res['host_ms']):.3f}",
          device_ms_median=f"{statistics.median(res['device_ms']):.3f}",
          **{f"{k}_launches": v for k, v in res["launches"].items()},
          grad_bytes_step=res["grad_bytes_step"],
          layout_gradient_sync_bytes=res["layout_grad_sync_bytes"],
          collective_bytes_estimate=res["collective_bytes_estimate"],
          gloo_host_staged_bytes_step=res["staged_bytes_step"],
          moment_bytes=res["moment_bytes"], fallbacks=res["fallbacks"],
          loss_gap=f"{loss_gap:.3e}", update_gap=f"{update_gap:.3e}",
          grad_gap=f"{grad_gap:.3e}", param_gap=f"{res['param_gap']:.3e}",
          **{f"{k}_bar": f"{bar:g}" for k, (_, bar) in gates.items()},
          **({} if zero_ref is None else {
              k: f"{v:.3e}" for k, (v, _) in gates.items()
              if k.endswith("_to_dp")}),
          losses=",".join(f"{x:.6f}" for x in res["losses"]),
          **extra, card=f"'{card}'")
    for k, (v, bar) in gates.items():
        check(v <= bar, f"[{tag}] rank {res['rank']}: {k} {v} > {bar}")
    for name, n in res["launches"].items():
        check(n == 12 * steps, f"[{tag}] rank {res['rank']}: {name} "
              f"launched {n} times, not 12 x {steps}")
    check(all(math.isfinite(x) for x in res["losses"]),
          f"[{tag}] non-finite loss")


def _control_line(tag, kind, gaps, bars, card):
    """A control's line (the same run broken on purpose): its gaps beside
    the bars, and the check that the bar DP_CONTROLS names rejects it."""
    names = ("loss_gap", "update_gap", "grad_gap")
    phase(tag, control=kind,
          **{n: f"{v:.3e}" for n, v in zip(names, gaps)},
          rejected_by=",".join(n for n, v in zip(names, gaps)
                               if v > bars[n[:-4]]) or "none",
          must_be_rejected_by=DP_CONTROLS[kind], card=f"'{card}'")
    v = dict(zip(names, gaps))[DP_CONTROLS[kind] + "_gap"]
    check(v > bars[DP_CONTROLS[kind]],
          f"[{tag}] the {kind} control passes the {DP_CONTROLS[kind]} bar "
          f"{bars[DP_CONTROLS[kind]]} ({v}): the bar does not tell a "
          f"broken step from a sound one")


def collective_rank_check(device):
    """Every c_* op type on CUDA tensors in this rank process: at world
    1 the collective functions the ops lower to (ops/collective.py) over
    the one-rank process group, so its backend itself launches; above 1
    each op in a program run by the executor on the card, its output and
    its input's gradient held to the host's numpy result from every
    rank's inputs. Returns {op type: max abs error}, the staged bytes
    and the backend."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import collective as coll

    n, r = dist.get_world_size(), dist.get_rank()
    rng = np.random.RandomState(0)
    xs = [rng.uniform(0.5, 2.0, (4 * n, 3)).astype(np.float32)
          for _ in range(n)]
    xs[-1][0] = xs[0][0]    # a tie for max and min
    errs = {}
    coll.reset_counts()
    if n == 1:
        x = torch.from_numpy(xs[0]).to(device)
        for op in ("sum", "max", "min", "prod"):
            errs[f"c_allreduce_{op}"] = float(
                (coll.all_reduce(x, None, op) - x).abs().max())
        errs["c_allgather"] = float((coll.all_gather(x, None) - x)
                                    .abs().max())
        errs["c_reducescatter"] = float((coll.reduce_scatter(x, None) - x)
                                        .abs().max())
        errs["c_broadcast"] = float((coll.broadcast(x, None, 0) - x)
                                    .abs().max())
        errs["c_alltoall"] = float((coll.all_to_all(x, None) - x)
                                   .abs().max())
        torch.cuda.synchronize()
        return errs, 0, dist.get_backend()
    cs = [rng.randn(4 * n, 3).astype(np.float32) for _ in range(n)]
    total, sc = sum(xs), sum(cs)
    rows = 4
    expect = {
        "c_allreduce_sum": (total, sc), "allreduce": (total, sc),
        "c_allreduce_max": (np.maximum.reduce(xs),
                            sc * (xs[r] == np.maximum.reduce(xs))),
        "c_allreduce_min": (np.minimum.reduce(xs),
                            sc * (xs[r] == np.minimum.reduce(xs))),
        "c_allreduce_prod": (np.prod(xs, 0), sc * np.prod(xs, 0) / xs[r]),
        "c_broadcast": (xs[0], sc if r == 0 else 0 * sc),
        "c_reducescatter": (total[r * rows:(r + 1) * rows], None),
        "c_allgather": (np.concatenate(xs), None),
        "c_alltoall": (np.concatenate([np.split(x, n)[r] for x in xs]),
                       None),
        "c_sync_calc_stream": (xs[r], cs[r]),
        "c_sync_comm_stream": (xs[r], cs[r]),
        "shard_hint": (xs[r], cs[r]),
    }
    for op_type, (want, want_grad) in expect.items():
        main, startup = ptt.Program(), ptt.Program()
        attrs = {"spec": ["dp", None]} if op_type == "shard_hint" else {}
        with ptt.program_guard(main, startup), ptt.unique_name.guard():
            xv = ptt.layers.data("x", shape=list(xs[r].shape),
                                 dtype="float32", append_batch_size=False)
            xv.stop_gradient = False
            blk = main.global_block()
            out = blk.create_var(name="out", shape=None, dtype="float32")
            blk.append_op(op_type, inputs={"X": [xv.name]},
                          outputs={"Out": [out.name]}, attrs=attrs,
                          infer_shape=False)
            fetch = [out]
            if want_grad is not None:
                cv = ptt.layers.data("c", shape=list(cs[r].shape),
                                     dtype="float32",
                                     append_batch_size=False)
                prod = blk.create_var(name="prod", shape=None,
                                      dtype="float32")
                loss = blk.create_var(name="loss", shape=None,
                                      dtype="float32")
                blk.append_op("elementwise_mul",
                              inputs={"X": [out.name], "Y": [cv.name]},
                              outputs={"Out": [prod.name]},
                              attrs={"axis": -1}, infer_shape=False)
                blk.append_op("reduce_sum", inputs={"X": [prod.name]},
                              outputs={"Out": [loss.name]},
                              attrs={"reduce_all": True, "dim": [0],
                                     "keep_dim": False}, infer_shape=False)
                fetch += ptt.backward.gradients([loss], [xv])
        exe = ptt.Executor(ptt.CUDAPlace(0))
        got = exe.run(main, feed={"x": xs[r], "c": cs[r]}, fetch_list=fetch,
                      scope=ptt.Scope())
        err = float(np.abs(got[0] - want).max())
        if want_grad is not None:
            err = max(err, float(np.abs(got[1] - want_grad).max()))
        errs[op_type] = err
    return errs, coll.STAGED_BYTES["bytes"], dist.get_backend()


def dygraph_dp_run(spec):
    """Eager DataParallel over make_dygraph_bert (spec: layers, batch,
    steps, control: None, 'no_sync' (apply_collective_grads skipped) or
    'sum' (the averaged gradients times the ranks)): this rank's rows
    (all of them without a process group), apply_collective_grads, eager
    AdamW under the global-norm clip. Returns {losses: the ranks' mean,
    weights: the final ones, init: the first ones, grad: the first
    step's synced gradient of the largest dense weight, launches: the
    flash launches, rows: this rank's rows}."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    import paddle_tpu_torch.dygraph as dg
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.ops import collective as coll
    from paddle_tpu_torch.parallel.mesh import world

    n, r = world()
    control = spec.get("control")
    cfg = transformer.bert_base(dropout=0.0, attn_dropout=0.0,
                                n_layers=spec["layers"])
    rows = spec["batch"] // n
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (spec["batch"], T)).astype(np.int64)
    toks = toks[r * rows:(r + 1) * rows]
    with dg.guard(), GlobalNormClip(ptt, 1.0):
        model = dg.DataParallel(make_dygraph_bert(dg, ptt.layers, cfg))
        opt = dygraph_bert_opt(ptt, dg)
        params = model.parameters()
        init = [p.numpy() for p in params]
        dense = max((i for i, w in enumerate(init)
                     if w.ndim == 2 and cfg.vocab_size not in w.shape),
                    key=lambda i: init[i].size)
        inputs = (dg.to_variable(toks), dg.to_variable(toks.reshape(-1, 1)))
        _zero_launch_counts()
        losses, grad = [], None
        for _ in range(spec["steps"]):
            loss = model(*inputs)
            loss.backward()
            if control != "no_sync":
                model.apply_collective_grads()
            if control == "sum":
                for p in params:
                    if p.grad is not None:
                        p.grad.mul_(n)
            if grad is None:
                grad = params[dense].grad.detach().cpu().numpy()
            opt.minimize(loss, parameter_list=params)
            model.clear_gradients()
            value = loss.value.detach().reshape(1)
            if n > 1:
                value = coll.all_reduce(value, None, "sum") / n
            losses.append(float(value))
        launches = _launch_counts()
        weights = [p.numpy() for p in params]
    torch.cuda.synchronize()
    return {"losses": losses, "weights": weights, "init": init,
            "grad": grad, "launches": launches, "rows": rows}


def _dygraph_gaps(res, one):
    """(loss, update, gradient) gaps of a [dygraph_dp] rank to `one`."""
    keys = range(len(one["weights"]))
    return (max(abs(a - b) for a, b in zip(res["losses"], one["losses"])),
            _rel_gap(dict(zip(keys, res["weights"])),
                     dict(zip(keys, one["weights"])),
                     dict(zip(keys, one["init"]))),
            _grad_gap(res["grad"], one["grad"], 0))


def dp_phases(torch, card):
    """[dp_backend], [dp_train], [zero_train], [collectives] and
    [dygraph_dp]: the data-parallel paths over DP_WORLD rank processes
    (spawned once the parent has built the kernels, so no two ranks build
    at once), each held to the same work in one process. A rank or a
    build that fails fails the run. Returns the ranks' flash launches:
    ({kernel: bf16 launches}, {kernel: float32 launches})."""
    import numpy as np
    from paddle_tpu_torch.distributed.spawn import RankPool

    backend, device = dp_backend(torch)
    phase("dp_backend", backend=backend, device=device, world=DP_WORLD,
          cards=torch.cuda.device_count(),
          why="one card: NCCL refuses two ranks on one GPU" if
          backend == "gloo" else "one card a rank", card=f"'{card}'")
    tmp = tempfile.TemporaryDirectory(prefix="dp_")
    path = lambda name: os.path.join(tmp.name, name)  # noqa: E731
    spec = {"cfg": {}, "batch": TRAIN_RUNS[True][0], "T": T, "amp": True,
            "flash": True, "place": "cuda", "steps": DP_STEPS, "mesh": None,
            "init": path("init.npz"), "ref": None, "out": None,
            "control": None}
    dg_spec = {"layers": DYGRAPH_DP_LAYERS, "batch": DYGRAPH_DP_BATCH,
               "steps": DYGRAPH_DP_STEPS}
    bf16 = dict.fromkeys(KERNEL_SOURCES, 0)
    f32 = dict.fromkeys(KERNEL_SOURCES, 0)
    try:
        # the one-process references, from the same startup state
        dp_startup_state(spec, spec["init"])
        one = dp_train_run({**spec, "out": path("one.npz")})
        dg_one = dygraph_dp_run(dg_spec)
        for k in bf16:
            bf16[k] += one["launches"][k]
            f32[k] += dg_one["launches"][k]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        init = np.load(spec["init"])
        full = {k: init[k].nbytes for k in init.files if "_moment" in k}
        half = sum(b // 2 if init[k].shape[0] % DP_WORLD == 0 else b
                   for k, b in full.items())
        t0 = time.perf_counter()
        pool = RankPool(DP_WORLD, path("store"), backend=backend,
                        timeout_s=DP_TIMEOUT_S, device=device)
        try:
            start_s = time.perf_counter() - t0
            dp = pool.run(dp_train_run, {**spec, "ref": path("one.npz"),
                                         "out": path("dp.npz")})
            for res in dp:
                _dp_line("dp_train", res, one, backend, card,
                         start_s=f"{start_s:.1f}",
                         one_rank_host_ms=f"{np.median(one['host_ms']):.3f}",
                         one_rank_device_ms=
                         f"{np.median(one['device_ms']):.3f}")
                check(res["moment_bytes"] == sum(full.values()),
                      f"[dp_train] rank {res['rank']}: moments "
                      f"{res['moment_bytes']} B, not the whole "
                      f"{sum(full.values())}")
            zero = pool.run(dp_train_run, {**spec, "mesh": str(DP_WORLD),
                                           "ref": path("dp.npz")})
            for res in zero:
                _dp_line("zero_train", res, one, backend, card,
                         zero_ref=dp[res["rank"]],
                         moments_vs_dp=f"{res['moment_bytes'] / sum(full.values()):.4f}",
                         moments_expected=half)
                check(res["moment_bytes"] == half,
                      f"[zero_train] rank {res['rank']}: moments "
                      f"{res['moment_bytes']} B, not {half} (half of each "
                      f"moment whose dim 0 divides)")
                _plan_gate_of("zero_train_plan", res, card)
            for kind in DP_CONTROLS:
                res = pool.run(dp_train_run, {**spec, "control": kind,
                                              "ref": path("one.npz")})[0]
                _control_line("dp_control", kind,
                              _dp_gaps(res, one["losses"], one["grad"]),
                              DP_BARS, card)
            for res in dp + zero:
                for k in bf16:
                    bf16[k] += res["launches"][k]
            ranks = pool.run(collective_rank_check, "cuda:0")
            errs2 = {k: max(r[0][k] for r in ranks) for k in ranks[0][0]}
            staged = sum(r[1] for r in ranks)
            be2 = ranks[0][2]
            dgdp = pool.run(dygraph_dp_run, dg_spec)
            for kind in DP_CONTROLS:
                res = pool.run(dygraph_dp_run,
                               {**dg_spec, "control": kind})[0]
                _control_line("dygraph_dp_control", kind,
                              _dygraph_gaps(res, dg_one), DYGRAPH_DP_BARS,
                              card)
        finally:
            pool.close()
        pool1 = RankPool(1, path("store1"), backend="nccl",
                         timeout_s=DP_TIMEOUT_S, device="cuda:0")
        try:
            errs1, _, be1 = pool1.run(collective_rank_check, "cuda:0")[0]
        finally:
            pool1.close()
    finally:
        tmp.cleanup()
    for world, errs, be, st in ((1, errs1, be1, 0), (DP_WORLD, errs2, be2,
                                                    staged)):
        phase("collectives", world=world, backend=be, ops=len(errs),
              max_abs_err=f"{max(errs.values()):.3e}",
              worst=max(errs, key=errs.get), tol=COLLECTIVE_TOL,
              gloo_host_staged_bytes=st, card=f"'{card}'")
        check(max(errs.values()) <= COLLECTIVE_TOL,
              f"[collectives] world {world} over {be}: {errs}")
    for res in dgdp:
        gaps = dict(zip(("loss", "update", "grad"),
                        _dygraph_gaps(res, dg_one)))
        phase("dygraph_dp", world=DP_WORLD, backend=backend,
              layers=DYGRAPH_DP_LAYERS, rows=res["rows"],
              batch=DYGRAPH_DP_BATCH, steps=DYGRAPH_DP_STEPS,
              **{f"{k}_gap": f"{v:.3e}" for k, v in gaps.items()},
              **{f"{k}_bar": f"{v:g}" for k, v in DYGRAPH_DP_BARS.items()},
              **{f"{k}_launches": v for k, v in res["launches"].items()},
              losses=",".join(f"{x:.6f}" for x in res["losses"]),
              card=f"'{card}'")
        for k, v in gaps.items():
            check(v <= DYGRAPH_DP_BARS[k],
                  f"[dygraph_dp] {k} gap {v} > {DYGRAPH_DP_BARS[k]}")
        for k, n in res["launches"].items():
            f32[k] += n
            check(n == DYGRAPH_DP_LAYERS * DYGRAPH_DP_STEPS,
                  f"[dygraph_dp] {k} launched {n} times")
    return bf16, f32


# --- model parallelism: tensor, sequence and expert sharding, recompute ---

# [tp_train] / [fsdp_train]: bench.py's BERT-base step
# (transformer.build_train: the LM loss at every position), b16 T512 bf16
# AMP, AdamW, dropout 0, with the tp/sp hints (sp over the tp axis), over
# two rank processes on a mesh dp1 x tp2 (the model-parallel rewrite's
# Megatron layout with sequence parallelism) or a mesh fsdp2 (the batch
# split over fsdp, every dim-0-divisible weight held as half its rows),
# MP_STEPS steps from one startup state, each held to the one-rank run of
# the same program by the loss, update and gradient gaps of DP_BARS'
# definitions (_dp_gaps), against MP_BARS. Each bar lies between the
# two-rank run's reading and the controls (MP_CONTROLS, run every time,
# which must fail a bar): g's backward all-reduced (every gradient
# upstream of a partial sum n times too large: the grad bar), and g's
# forward all-reduce skipped (each rank's partial sum taken as the whole:
# the loss bar). tools/torch_rounding_sensitivity.py tp reads the same
# gaps on the CPU at a small size (d 128, 2 layers, T 128: tp2 3.147e-05
# / 2.619e-03 / 2.940e-03, fsdp2 1.621e-05 / 1.457e-03 / 2.327e-03, the
# controls 1.411e-04 / 2.216e-02 / 1.000 and 5.167 / 3.122e-01 /
# 7.264e-01). On an H100 80GB HBM3 at 700 W, loss / update / grad: tp2
# 2.136e-04 / 3.198e-02 / 1.070e-02, fsdp2 2.861e-04 / 2.740e-02 /
# 9.622e-03; g_bwd_allreduce 7.906e-04 / 5.120e-02 / 1.001, g_fwd_skipped
# 5.240 / 1.199 / 9.618e-01. The fsdp control leaves out the 1/n of the
# fsdp gradient's reduce-scatter (every fsdp weight's gradient twice too
# large, which Adam's updates hide) and must fail the grad bar: CPU
# 1.000, the H100 1.001.
MP_WORLD = 2
MP_STEPS = 3
MP_BATCH = 16
MP_BARS = {"loss": 1e-3, "update": 0.1, "grad": 0.05}
MP_CONTROLS = {"g_bwd_allreduce": "grad", "g_fwd_skipped": "loss"}
# [ring_train] / [ulysses_train]: examples/long_context.py's program at
# GPT-small widths (d 768, 12 heads, vocab 32000), causal, b1, T 8192 over
# sp2 (4096 rows a rank), q/k/v cast to bf16 around the attention op, Adam,
# SEQ_STEPS steps, held to the one-rank run (flash attention over the
# whole T) by the loss gap and the first step's gradient gap of the qkv
# weight, against SEQ_BARS; the control drops the ring's off-diagonal
# blocks and must fail the grad bar (the loss at random init reads
# ln(vocab) whatever the attention computes). The op-level check holds the ring's
# and Ulysses' output and dQ/dK/dV on bf16 [1, 12, 8192, 64] inputs to the
# plain attention in float32 on the card within SEQ_OP_TOL (bf16
# rounding of the output and of the blocks' outputs before the merge).
# H100 readings, loss / grad: ring 1.907e-06 / 1.147e-02, Ulysses 0 / 0,
# the control 0 / 9.581e-01; op errors 6.8e-03-2.3e-02 (bf16). CPU
# (tools/torch_rounding_sensitivity.py ring: T 512, d 128): ring
# 4.292e-06 / 1.593e-02, the control 4.048e-04 / 9.735e-01.
SEQ_T, SEQ_D, SEQ_HEADS, SEQ_VOCAB, SEQ_STEPS = 8192, 768, 12, 32000, 3
SEQ_BARS = {"loss": 2e-3, "grad": 0.05}
SEQ_OP_TOL = 3e-2
# [moe_train]: Switch-Base-8's FFN widths (d_model 768, d_ff 3072, 8
# experts, top-1; arxiv 2101.03961) in tests/test_parallel.py:474's
# static program, b8 T512, float32, over ep2, dense and sparse at
# capacity factor 1.25 (capacity 1.25 x 4096 / 8 = 640), held to one
# rank's dense run: the dense run's losses within MOE_TOL relative, the
# sparse run's first-step output: dropped rows exactly 0, kept rows
# within MOE_TOL of the dense output's largest entry
MOE_D, MOE_FF, MOE_E, MOE_B, MOE_T = 768, 3072, 8, 8, 512
MOE_CAPACITY = int(1.25 * MOE_B * MOE_T / MOE_E)
# and at a tenth of that, where tokens drop: their rows exactly 0
MOE_TIGHT = MOE_CAPACITY // 10
MOE_STEPS = 3
MOE_TOL = 1e-4
# and the gate weight's first-step gradient, dense and at capacity 1.25,
# within MOE_GRAD_BAR (relative L2) of one rank's; the control
# all-reduces the ep sum's backward (g as c_allreduce_sum) and must fail
# it. tools/torch_rounding_sensitivity.py moe reads both on the CPU (d
# 64: dense 2.610e-07, the control 1.000; 1e-3 of seeded noise on the
# startup state 4.708e-04); an H100 80GB HBM3: dense 1.965e-07, sparse
# 1.371e-07, the control 1.000.
MOE_GRAD_BAR = 1e-3
# [tp_train], [fsdp_train], [ring_train], [ulysses_train], [moe_train]:
# the bytes a rank's collectives moved a step against the sharding
# gate's price of its rank program, relative
BYTES_TOL = 0.05
# [recompute_train]: [train]'s step (b32, dropout 0.1, bf16 AMP) with
# RecomputeOptimizer(AdamW) checkpointed at each layer's output, against
# the same program without recompute from the same seed, both under
# torch's deterministic algorithms: the losses equal to RECOMPUTE_TOL
RECOMPUTE_STEPS = (2, 3)
RECOMPUTE_TOL = 1e-6


def _mp_build(ptt, spec):
    """BERT-base build_train with the tp/sp hints (sp over tp), dropout
    0, b MP_BATCH, T512, bf16 AMP, AdamW lr 1e-4."""
    from paddle_tpu_torch.models import transformer
    cfg = transformer.bert_base(dropout=0.0, attn_dropout=0.0,
                                use_flash=spec.get("flash", True), tp=True,
                                sp=True, sp_axis="tp",
                                **spec.get("cfg", {}))
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss, _ = transformer.build_train(cfg, spec["batch"],
                                          spec.get("T", T), lr=1e-4,
                                          amp=True)
    return cfg, main, startup, loss


def _mp_control(kind):
    """Break g on purpose, as a control for MP_BARS: 'g_bwd_allreduce'
    all-reduces its backward (Megatron's g differentiated like
    c_allreduce_sum; the MoE FFN's sum over ep is this g too),
    'g_fwd_skipped' skips its forward all-reduce. The reduce-scatter of
    sequence parallelism is broken alike. 'fsdp_rs_unscaled' leaves out
    the 1/n of an fsdp weight's gradient reduce-scatter. Returns the
    function that repairs it."""
    import torch
    from paddle_tpu_torch.ops import collective as coll
    saved = (coll.reduce_from, coll.reduce_scatter_to, coll.fsdp_gather)
    if kind == "fsdp_rs_unscaled":
        coll.fsdp_gather = (lambda x, g, reduce, scale=1.0:
                            saved[2](x, g, reduce, 1.0))

        def repair_fsdp():
            coll.fsdp_gather = saved[2]
        return repair_fsdp

    class _Bwd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group, scale):
            ctx.group, ctx.scale = group, scale
            return coll.all_reduce(x, group) * scale

        @staticmethod
        def backward(ctx, g):
            return coll.all_reduce(g, ctx.group) * ctx.scale, None, None

    class _Fwd(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group, scale):
            ctx.scale = scale
            return x.detach() * scale

        @staticmethod
        def backward(ctx, g):
            return g * ctx.scale, None, None

    def rs(x, group, sp):
        import torch.distributed as dist
        n, r = dist.get_world_size(group), dist.get_rank(group)
        full = _Bwd.apply(x, group, 1.0) if kind == "g_bwd_allreduce" \
            else _Fwd.apply(x, group, 1.0)
        return coll.take_block(full, sp, n, r)

    coll.reduce_from = (lambda x, g, scale=1.0: (
        _Bwd if kind == "g_bwd_allreduce" else _Fwd).apply(x, g, scale))
    coll.reduce_scatter_to = rs

    def repair():
        coll.reduce_from, coll.reduce_scatter_to, coll.fsdp_gather = saved
    return repair


def mp_train_run(spec):
    """The BERT step of `spec` (batch, steps, init: an npz of the startup
    state, mesh: "dp,tp,fsdp" sizes or None for one rank, batch_axes,
    ref: an npz of the one-rank run's parameters, out: where the one-rank
    run writes its final parameters, control: an _mp_control kind, save:
    a directory to write a sharded checkpoint of the final state to) in
    this process. The first step also fetches the gradient of layer 0's
    FFN-in weight (gathered whole). Returns the losses, that gradient,
    per step host and device ms, the flash launches of the steps after
    the first (and the shape of each flash call), the payload and staged
    bytes of the collectives a step, the analyzer's collective bytes a
    step, the rank's parameter bytes, the peak beside the planner's, the
    update gap to `ref`, and with `save` each parameter's sha256 and the
    loss of one more step."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.ops import collective as coll
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.parallel.layout import SpecLayout, mesh_from_spec
    from paddle_tpu_torch.parallel.mesh import world
    from paddle_tpu_torch.parallel.model_parallel import gather_param

    repair = _mp_control(spec["control"]) if spec.get("control") \
        else None
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg, main, startup, loss = _mp_build(ptt, spec)
        cuda = spec.get("place", "cuda") != "cpu"
        place = _place(ptt, {"place": spec.get("place", "cuda")})
        scope = ptt.Scope()
        exe = ptt.Executor(place)
        exe.run(startup, scope=scope)
        init = dict(np.load(spec["init"]))
        # copies: on the CPU the scope would share the arrays
        scope_from_numpy({k: v.copy() for k, v in init.items()}, scope,
                         place, program=main)
        layout = None
        prog = main
        if spec["mesh"]:
            mesh = mesh_from_spec(spec["mesh"])
            layout = SpecLayout(mesh).add_program(main)
            prog = ptt.CompiledProgram(main).with_distributed(
                mesh, state_spec_fn=layout,
                batch_axes=tuple(spec["batch_axes"]))
            prog._loss_name = loss.name
        feed = _dp_feed(cfg.vocab_size, spec["batch"], spec.get("T", T))
        gname = "layer_0.ffn.fc1.w@GRAD"
        first = exe.run(prog, feed=feed, fetch_list=[loss, gname],
                        scope=scope)
        losses = [float(first[0])]
        coll.reset_counts()
        _zero_launch_counts()
        shapes = set()
        real_fwd = fa.flash_attention_fwd

        def spy(q, *a, **k):
            shapes.add(tuple(q.shape))
            return real_fwd(q, *a, **k)
        fa.flash_attention_fwd = spy
        host, device, peaks = [], [], []
        try:
            for _ in range(spec["steps"] - 1):
                if cuda:
                    torch.cuda.synchronize()
                    foreign = torch.cuda.memory_allocated() - \
                        scope_device_bytes(torch, scope)
                    torch.cuda.reset_peak_memory_stats()
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                t0 = time.perf_counter()
                out = exe.run(prog, feed=feed, fetch_list=[loss],
                              scope=scope, return_numpy=False)
                host.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(out[0]))
                if cuda:
                    ev[1].record()
                    torch.cuda.synchronize()
                    device.append(ev[0].elapsed_time(ev[1]))
                    peaks.append((torch.cuda.max_memory_allocated()
                                  - foreign) / 1e9)
        finally:
            fa.flash_attention_fwd = real_fwd
        launches = _launch_counts()
        n = max(spec["steps"] - 1, 1)
        moved = sum(coll.COLLECTIVE_BYTES.values()) // n
        staged = coll.STAGED_BYTES["bytes"] // n
        names = [v.name for v in main.list_vars()
                 if getattr(v, "is_parameter", False)]
        own = sum(scope.find_var(k).numel() * scope.find_var(k).element_size()
                  for k in names)
        params = {k: gather_param(scope, k).cpu().numpy() for k in names}
        size, rank = world()
        update_gap = None
        if spec.get("ref"):
            update_gap = _rel_gap(params, dict(np.load(spec["ref"])), init)
        if spec.get("out") and rank == 0:
            np.savez(spec["out"], **params)
        res = {"rank": rank, "world": size, "losses": losses,
               "grad": np.asarray(first[1], np.float32),
               "update_gap": update_gap, "host_ms": host,
               "device_ms": device, "launches": launches,
               "flash_shapes": sorted(shapes), "moved_step": moved,
               "staged_step": staged, "param_bytes": own,
               "full_param_bytes": sum(v.nbytes for v in params.values()),
               "peak_gb": max(peaks) if peaks else None}
        if layout is not None and cuda:
            # the sharding gate's price of the rank program (the
            # analyzer's rank walk the rewrite was built from)
            res["collective_bytes_estimate"] = \
                exe.last_sharding_report.collective_bytes_per_step
            res["plan"] = _rank_plan(exe, prog, main, feed, loss)
        if spec.get("save"):
            ptt.save_sharded_persistables(exe, spec["save"], main,
                                          scope=scope)
            res["sha256"] = {k: _sha(v) for k, v in params.items()}
            res["next_loss"] = float(exe.run(prog, feed=feed,
                                             fetch_list=[loss],
                                             scope=scope)[0])
        return res
    finally:
        if repair is not None:
            repair()
        torch.use_deterministic_algorithms(was)


def _sha(a):
    import hashlib
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _rank_plan(exe, prog, main, feed, loss):
    """The planner's plan of this rank's program (the model-parallel
    rewrite's, local shapes) at this rank's feed, as the executor's
    memory gate priced it."""
    from paddle_tpu_torch.parallel.mesh import mesh_context
    from paddle_tpu_torch.parallel.model_parallel import (RankLayout,
                                                          plan_for)
    mesh = prog.mesh()
    mp = plan_for(main, mesh, prog.spec_layout(), prog._batch_axes)
    n, idx = prog.batch_split()
    local = {}
    for k, v in feed.items():
        span = prog.feed_rows(v.shape)
        local[k] = v if span is None else v[span[0]:span[1]]
    with mesh_context(mesh):
        plan = planned_plan(mp.program, local, [loss],
                            layout=RankLayout(prog.layout(), mp))
    return {"device_peak_bytes": plan.device_peak_bytes,
            "peak_bytes": plan.peak_bytes,
            "device_charges": plan.device_charges}


def mp_load_run(spec):
    """Load `spec`'s sharded checkpoint (save) at this rank's mesh, each
    parameter's sha256 reassembled (gathered), and one more step's loss
    from the loaded state."""
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.parallel.layout import SpecLayout, mesh_from_spec
    from paddle_tpu_torch.parallel.model_parallel import gather_param
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg, main, startup, loss = _mp_build(ptt, spec)
        exe = ptt.Executor(ptt.CUDAPlace(0))
        scope = ptt.Scope()
        mesh = mesh_from_spec(spec["mesh"])
        layout = SpecLayout(mesh).add_program(main)
        prog = ptt.CompiledProgram(main).with_distributed(
            mesh, state_spec_fn=layout, batch_axes=("dp",))
        prog._loss_name = loss.name
        ptt.load_sharded_persistables(exe, spec["save"], main, mesh=mesh,
                                      scope=scope, layout=layout)
        names = [v.name for v in main.list_vars()
                 if getattr(v, "is_parameter", False)]
        own = sum(scope.find_var(k).numel() * 4 for k in names)
        sha = {k: _sha(gather_param(scope, k).cpu().numpy())
               for k in names}
        feed = _dp_feed(cfg.vocab_size, spec["batch"], T)
        lv = float(exe.run(prog, feed=feed, fetch_list=[loss],
                           scope=scope)[0])
        return {"sha256": sha, "next_loss": lv, "own_bytes": own}
    finally:
        torch.use_deterministic_algorithms(was)


def _long_context(ptt, scheme, batch=1, dims=None):
    """examples/long_context.py's program at GPT-small widths (or
    `dims`: T, d, heads, vocab) with `scheme` attention ("ring" or
    "ulysses") on q/k/v cast to bf16."""
    t, d, heads, vocab = dims or (SEQ_T, SEQ_D, SEQ_HEADS, SEQ_VOCAB)
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    L = ptt.layers
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        tokens = L.data("tokens", shape=[batch, t], dtype="int64",
                        append_batch_size=False)
        targets = L.data("targets", shape=[batch, t], dtype="int64",
                         append_batch_size=False)
        emb = L.embedding(tokens, size=[vocab, d])
        qkv = L.fc(emb, size=3 * d, num_flatten_dims=2,
                   param_attr=ptt.ParamAttr(name="qkv.w"))
        parts = [L.slice(qkv, axes=[2], starts=[i * d], ends=[(i + 1) * d])
                 for i in range(3)]

        def heads_first(x):
            x = L.reshape(x, shape=[batch, t, heads, d // heads])
            return L.cast(L.transpose(x, perm=[0, 2, 1, 3]), "bfloat16")

        attn = L.ring_attention if scheme == "ring" else \
            L.ulysses_attention
        ctxv = attn(*[heads_first(x) for x in parts], causal=True)
        ctxv = L.transpose(L.cast(ctxv, "float32"), perm=[0, 2, 1, 3])
        ctxv = L.reshape(ctxv, shape=[batch, t, d])
        h = L.fc(ctxv, size=d, num_flatten_dims=2, act="relu")
        logits = L.fc(h, size=vocab, num_flatten_dims=2)
        loss = L.mean(L.softmax_with_cross_entropy(
            logits, L.reshape(targets, shape=[batch, t, 1])))
        ptt.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, loss


def seq_train_run(spec):
    """`spec`'s long-context program (scheme, init, steps, sp: two ranks
    over a mesh sp2 or one rank, control) in this process: the losses,
    the first step's qkv weight gradient, per step device ms, the flash
    launches of the steps after the first and their shapes, and the
    bytes the ring moved a step; with `op_check`, the op-level check's
    errors (output, dQ, dK, dV against the plain attention in float32)
    and the op's output."""
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.ops import collective as coll
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.parallel import ring_attention as ra
    from paddle_tpu_torch.parallel.mesh import make_mesh, world
    real_blocks = ra._blocks
    if spec.get("control") == "no_offdiag":
        ra._blocks = lambda n, r, causal: [
            b for b in real_blocks(n, r, causal) if b[1] == r]
    try:
        dims = spec.get("dims") or (SEQ_T, SEQ_D, SEQ_HEADS, SEQ_VOCAB)
        main, startup, loss = _long_context(ptt, spec["scheme"], dims=dims)
        cuda = spec.get("place", "cuda") != "cpu"
        place = _place(ptt, {"place": spec.get("place", "cuda")})
        scope = ptt.Scope()
        exe = ptt.Executor(place)
        exe.run(startup, scope=scope)
        init = dict(np.load(spec["init"]))
        scope_from_numpy(init, scope, place, program=main)
        prog = main
        if spec["sp"]:
            mesh = make_mesh((2,), ("sp",))
            prog = ptt.CompiledProgram(main).with_distributed(
                mesh, batch_axes=())
        toks = np.random.RandomState(0).randint(0, dims[3], (1, dims[0]))
        feed = {"tokens": toks.astype(np.int64),
                "targets": np.roll(toks, 1, axis=1).astype(np.int64)}
        first = exe.run(prog, feed=feed, fetch_list=[loss, "qkv.w@GRAD"],
                        scope=scope)
        losses = [float(first[0])]
        _zero_launch_counts()
        coll.reset_counts()
        shapes = set()
        real_fwd = fa.flash_attention_fwd

        def spy(q, *a, **k):
            shapes.add(tuple(q.shape))
            return real_fwd(q, *a, **k)
        fa.flash_attention_fwd = spy
        device = []
        try:
            for _ in range(spec["steps"] - 1):
                t0 = time.perf_counter()
                if cuda:
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    torch.cuda.synchronize()
                    ev[0].record()
                losses.append(float(exe.run(prog, feed=feed,
                                            fetch_list=[loss],
                                            scope=scope)[0]))
                if cuda:
                    ev[1].record()
                    torch.cuda.synchronize()
                    device.append(ev[0].elapsed_time(ev[1]))
                else:
                    device.append((time.perf_counter() - t0) * 1e3)
        finally:
            fa.flash_attention_fwd = real_fwd
        launches = _launch_counts()
        res = {"rank": world()[1], "losses": losses,
               "grad": np.asarray(first[1], np.float32),
               "device_ms": device, "launches": launches,
               "flash_shapes": sorted(shapes),
               "moved_step": sum(coll.COLLECTIVE_BYTES.values())
               // max(spec["steps"] - 1, 1),
               "staged_step": coll.STAGED_BYTES["bytes"]
               // max(spec["steps"] - 1, 1),
               "collective_bytes_estimate":
               exe.last_sharding_report.collective_bytes_per_step
               if spec["sp"] else None}
        if spec.get("op_check"):
            res.update(_seq_op_check(torch, spec["scheme"]))
        return res
    finally:
        ra._blocks = real_blocks


def _seq_op_check(torch, scheme):
    """The scheme's op over sp2 on bf16 [1, 12, 8192, 64] q, k, v (seeded
    alike on both ranks), causal: its output and dQ/dK/dV against the
    plain attention in float32 on the same inputs. Launches made here
    are not the main path's (the caller reads the counts first)."""
    from paddle_tpu_torch.ops.cuda.flash_attention import \
        reference_attention
    from paddle_tpu_torch.parallel.mesh import make_mesh
    from paddle_tpu_torch.parallel import ring_attention as ra
    from paddle_tpu_torch.parallel import ulysses as ul
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    shape = (1, SEQ_HEADS, SEQ_T, SEQ_D // SEQ_HEADS)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    fn = ra.ring_attention_sharded if scheme == "ring" else \
        ul.ulysses_attention_sharded
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, make_mesh((2,), ("sp",)), "sp", causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    ref_leaves = [x.float().requires_grad_() for x in (q, k, v)]
    ref = reference_attention(*[x.reshape(-1, SEQ_T, shape[-1])
                                for x in ref_leaves], causal=True) \
        .reshape(shape)
    ref_grads = torch.autograd.grad(ref, ref_leaves, do.float())
    errs = [float((a.detach().float() - b.detach()).abs().max())
            for a, b in zip([out, *grads], [ref, *ref_grads])]
    return {"op_errs": errs, "op_out": out.detach().float().cpu().numpy()}


def _moe_dims(spec):
    """(d_model, d_ff, experts, batch, T) of a MoE run's spec."""
    return tuple(spec.get("dims") or (MOE_D, MOE_FF, MOE_E, MOE_B, MOE_T))


def _moe_build(ptt, capacity, dims=None):
    """tests/test_parallel.py:474's static program at Switch-Base-8's FFN
    widths (or `dims`): layers.moe_ffn, the loss mean((y - tanh x)^2),
    Adam."""
    d, ff, e, _, t = dims or _moe_dims({})
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data("moe_x", shape=[t, d], dtype="float32")
        y, load = ptt.layers.moe_ffn(x, num_experts=e, d_ff=ff,
                                     capacity=capacity)
        tgt = ptt.layers.data("moe_t", shape=[t, d], dtype="float32")
        loss = ptt.layers.mean(ptt.layers.square(
            ptt.layers.elementwise_sub(y, tgt)))
        ptt.optimizer.Adam(learning_rate=5e-3).minimize(loss)
    return main, startup, loss, load, y


def moe_train_run(spec):
    """The MoE program (capacity, init, steps, ep: two ranks over a mesh
    ep2 or one rank): the losses, the loads, the first step's output, the
    rank's expert-weight bytes, per step device ms, the gate weight's
    first-step gradient (control: an _mp_control kind), and the bytes
    the collectives moved a step after the first beside the sharding
    gate's price of the rank program."""
    import paddle_tpu_torch as ptt
    dims = _moe_dims(spec)
    main, startup, loss, load, y = _moe_build(ptt, spec["capacity"], dims)
    gname = [v.name for v in main.list_vars()
             if v.name.endswith(".gate_w")][0] + "@GRAD"
    repair = _mp_control(spec["control"]) if spec.get("control") \
        else None
    try:
        return _moe_steps(spec, dims, main, startup, loss, load, y, gname)
    finally:
        if repair is not None:
            repair()


def _moe_steps(spec, dims, main, startup, loss, load, y, gname):
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.ops import collective as coll
    from paddle_tpu_torch.parallel.mesh import make_mesh, world
    cuda = spec.get("place", "cuda") != "cpu"
    place = _place(ptt, {"place": spec.get("place", "cuda")})
    scope = ptt.Scope()
    exe = ptt.Executor(place)
    exe.run(startup, scope=scope)
    scope_from_numpy(dict(np.load(spec["init"])), scope, place,
                     program=main)
    prog = main
    if spec["ep"]:
        mesh = make_mesh((2,), ("ep",))
        prog = ptt.CompiledProgram(main).with_distributed(
            mesh, batch_axes=())
    xv = np.random.RandomState(0).randn(dims[3], dims[4], dims[0]) \
        .astype(np.float32)
    feed = {"moe_x": xv, "moe_t": np.tanh(xv)}
    losses, loads, first, grad, device = [], [], None, None, []
    for i in range(spec["steps"]):
        if i == 1:
            # the first run broadcast and cut the state: steps after it
            coll.reset_counts()
        t0 = time.perf_counter()
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
        out = exe.run(prog, feed=feed,
                      fetch_list=[loss, load] + ([y, gname] if i == 0
                                                 else []),
                      scope=scope)
        if cuda:
            ev[1].record()
            torch.cuda.synchronize()
            device.append(ev[0].elapsed_time(ev[1]))
        else:
            device.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[0]))
        loads.append(float(out[1]))
        if i == 0:
            first = np.asarray(out[2], np.float32)
            grad = np.asarray(out[3], np.float32)
    experts = sum(scope.find_var(n).numel() * 4 for n in scope.names()
                  if n.endswith((".w1", ".w2")))
    report = exe.last_sharding_report if spec["ep"] else None
    return {"rank": world()[1], "losses": losses, "loads": loads,
            "y": first, "grad": grad, "expert_bytes": experts,
            "device_ms": device,
            "moved_step": sum(coll.COLLECTIVE_BYTES.values())
            // max(spec["steps"] - 1, 1),
            "staged_step": coll.STAGED_BYTES["bytes"]
            // max(spec["steps"] - 1, 1), "collective_bytes_estimate":
            None if report is None else report.collective_bytes_per_step}


def mp_phases(torch, card):
    """[tp_train], [tp_control], [tp_train_plan], [fsdp_train],
    [sharded_ckpt], [ring_train], [ring_control], [ulysses_train] and
    [moe_train] over MP_WORLD rank processes (gloo on cuda:0 where the
    machine has one card, as dp_phases), each held to the same work in
    one process. Returns {kernel: bf16 launches} of the main-path runs."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.distributed.spawn import RankPool

    backend, device = dp_backend(torch)
    tmp = tempfile.TemporaryDirectory(prefix="mp_")
    path = lambda name: os.path.join(tmp.name, name)  # noqa: E731
    bf16 = dict.fromkeys(KERNEL_SOURCES, 0)
    spec = {"batch": MP_BATCH, "steps": MP_STEPS, "init": path("init.npz"),
            "mesh": None, "batch_axes": ["dp"], "ref": None, "out": None,
            "control": None, "save": None}
    try:
        # one-rank references, from the same startup states
        _, main, startup, _ = _mp_build(ptt, spec)
        sc = ptt.Scope()
        ptt.Executor(ptt.CUDAPlace(0)).run(startup, scope=sc)
        np.savez(spec["init"], **{n: sc.get_numpy(n) for n in sc.names()})
        del sc, main, startup
        one = mp_train_run({**spec, "out": path("one.npz")})
        for k in bf16:
            bf16[k] += one["launches"][k]
        seq_init = path("seq_init.npz")
        sm, ss, _ = _long_context(ptt, "ring")
        sc = ptt.Scope()
        ptt.Executor(ptt.CUDAPlace(0)).run(ss, scope=sc)
        np.savez(seq_init, **{n: sc.get_numpy(n) for n in sc.names()})
        del sc, sm, ss
        seq_spec = {"scheme": "ring", "init": seq_init, "steps": SEQ_STEPS,
                    "sp": False}
        seq_one = seq_train_run(seq_spec)
        for k in bf16:
            bf16[k] += seq_one["launches"][k]
        moe_init = path("moe_init.npz")
        mm, ms, *_ = _moe_build(ptt, None)
        sc = ptt.Scope()
        ptt.Executor(ptt.CUDAPlace(0)).run(ms, scope=sc)
        np.savez(moe_init, **{n: sc.get_numpy(n) for n in sc.names()})
        del sc, mm, ms
        moe_spec = {"capacity": None, "init": moe_init,
                    "steps": MOE_STEPS, "ep": False}
        moe_one = moe_train_run(moe_spec)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pool = RankPool(MP_WORLD, path("store"), backend=backend,
                        timeout_s=DP_TIMEOUT_S, device=device)
        try:
            start_s = time.perf_counter() - t0
            tp = pool.run(mp_train_run, {
                **spec, "mesh": "1,2", "ref": path("one.npz"),
                "save": path("ckpt")})
            for res in tp:
                _mp_line("tp_train", res, one, backend, card,
                         start_s=f"{start_s:.1f}")
                _plan_gate_of("tp_train_plan", res, card)
                for k in bf16:
                    bf16[k] += res["launches"][k]
            for kind in MP_CONTROLS:
                # one step: the first loss and gradient show each fault
                res = pool.run(mp_train_run, {
                    **spec, "mesh": "1,2", "control": kind,
                    "steps": 1})[0]
                gaps = _dp_gaps(res, one["losses"][:1], one["grad"])
                gaps = (gaps[0], gaps[2])
                names = ("loss_gap", "grad_gap")
                phase("tp_control", control=kind, steps=1,
                      **{n: f"{v:.3e}" for n, v in zip(names, gaps)},
                      must_be_rejected_by=MP_CONTROLS[kind],
                      card=f"'{card}'")
                v = dict(zip(names, gaps))[MP_CONTROLS[kind] + "_gap"]
                check(v > MP_BARS[MP_CONTROLS[kind]],
                      f"[tp_control] the {kind} control passes the "
                      f"{MP_CONTROLS[kind]} bar ({v})")
            _sharded_ckpt(pool, spec, tp, path, card)
            fsdp = pool.run(mp_train_run, {
                **spec, "mesh": "1,1,2", "batch_axes": ["fsdp"],
                "ref": path("one.npz")})
            for res in fsdp:
                _mp_line("fsdp_train", res, one, backend, card,
                         param_share=f"{res['param_bytes'] / res['full_param_bytes']:.4f}")
                for k in bf16:
                    bf16[k] += res["launches"][k]
            # the fsdp gradient's reduce-scatter without its 1/n: every
            # fsdp weight's gradient twice too large (Adam's updates
            # hide it; the first step's gradient shows it)
            res = pool.run(mp_train_run, {
                **spec, "mesh": "1,1,2", "batch_axes": ["fsdp"],
                "control": "fsdp_rs_unscaled", "steps": 1})[0]
            ggap = _dp_gaps(res, one["losses"][:1], one["grad"])[2]
            phase("fsdp_control", control="fsdp_rs_unscaled", steps=1,
                  grad_gap=f"{ggap:.3e}", grad_bar=MP_BARS["grad"],
                  must_be_rejected_by="grad", card=f"'{card}'")
            check(ggap > MP_BARS["grad"], f"[fsdp_control] the unscaled "
                  f"reduce-scatter passes the grad bar ({ggap})")
            ring = pool.run(seq_train_run, {**seq_spec, "sp": True,
                                            "op_check": True})
            _seq_line("ring_train", ring, seq_one, card)
            for k in bf16:
                bf16[k] += sum(r["launches"][k] for r in ring)
            ctl = pool.run(seq_train_run, {**seq_spec, "sp": True,
                                           "steps": 1,
                                           "control": "no_offdiag"})[1]
            gap = max(abs(a - b) for a, b in zip(ctl["losses"],
                                                 seq_one["losses"]))
            ggap = float(np.linalg.norm(ctl["grad"] - seq_one["grad"])
                         / np.linalg.norm(seq_one["grad"]))
            phase("ring_control", control="no_offdiag",
                  loss_gap=f"{gap:.3e}", grad_gap=f"{ggap:.3e}",
                  grad_bar=SEQ_BARS["grad"], must_be_rejected_by="grad",
                  card=f"'{card}'")
            # at random init the loss reads ln(vocab) whatever the
            # attention computes: the first step's gradient tells
            check(ggap > SEQ_BARS["grad"],
                  f"[ring_control] dropping the off-diagonal blocks passes "
                  f"the grad bar ({ggap})")
            uly = pool.run(seq_train_run, {**seq_spec, "scheme": "ulysses",
                                           "sp": True, "op_check": True})
            _seq_line("ulysses_train", uly, seq_one, card, ring=ring)
            for k in bf16:
                bf16[k] += sum(r["launches"][k] for r in uly)
            moe_dense = pool.run(moe_train_run, {**moe_spec, "ep": True})
            moe_sparse = pool.run(moe_train_run, {
                **moe_spec, "ep": True, "capacity": MOE_CAPACITY})
            # a capacity that drops tokens: the first step's output only
            moe_tight = pool.run(moe_train_run, {
                **moe_spec, "ep": True, "capacity": MOE_TIGHT, "steps": 1})
            _moe_lines(moe_one, moe_dense, moe_sparse, moe_tight, card)
            # the ep sum's backward all-reduced (g differentiated like
            # c_allreduce_sum): every gradient upstream of it n times too
            # large, which Adam's updates and the loss hide
            ctl = pool.run(moe_train_run, {
                **moe_spec, "ep": True, "steps": 1,
                "control": "g_bwd_allreduce"})[0]
            ggap = _grad_gap(ctl["grad"], moe_one["grad"], 0)
            phase("moe_control", control="g_bwd_allreduce", steps=1,
                  grad_gap=f"{ggap:.3e}", grad_bar=MOE_GRAD_BAR,
                  must_be_rejected_by="grad", card=f"'{card}'")
            check(ggap > MOE_GRAD_BAR, f"[moe_control] the all-reduced "
                  f"backward of the ep sum passes the grad bar ({ggap})")
        finally:
            pool.close()
        one_rank_ckpt(spec, tp, path, card)
        bf16_rc = recompute_phase(torch, card)
        for k in bf16:
            bf16[k] += bf16_rc[k]
    finally:
        tmp.cleanup()
    return bf16


def _priced_check(tag, res):
    """The bytes a rank's collectives moved a step against the sharding
    gate's price of its rank program (the analyzer's rank walk, which
    the rewrite was built from): equal within BYTES_TOL."""
    moved, priced = res["moved_step"], res["collective_bytes_estimate"]
    check(priced is not None and priced > 0 and
          abs(moved - priced) <= BYTES_TOL * priced,
          f"[{tag}] rank {res['rank']}: moved {moved} B a step, the "
          f"analyzer priced {priced}")


def _mp_line(tag, res, one, backend, card, **extra):
    """A tp/fsdp rank's line: the gaps to the one-rank run within
    MP_BARS, the flash launches (12 a kernel a step, at the local heads'
    shape under tp), the collectives' bytes a step beside the analyzer's
    estimate."""
    import statistics
    gaps = dict(zip(("loss", "update", "grad"),
                    _dp_gaps(res, one["losses"], one["grad"])))
    steps = MP_STEPS - 1
    phase(tag, rank=res["rank"], world=res["world"], backend=backend,
          steps=MP_STEPS, batch=MP_BATCH, T=T,
          host_ms_median=f"{statistics.median(res['host_ms']):.3f}",
          device_ms_median=f"{statistics.median(res['device_ms']):.3f}",
          one_rank_device_ms=f"{statistics.median(one['device_ms']):.3f}",
          **{f"{k}_launches_per_step": v // steps
             for k, v in res["launches"].items()},
          flash_shapes=";".join("x".join(map(str, s))
                                for s in res["flash_shapes"]),
          collective_bytes_step=res["moved_step"],
          collective_bytes_per_step_estimate=res.get(
              "collective_bytes_estimate"),
          gloo_host_staged_bytes_step=res["staged_step"],
          param_bytes=res["param_bytes"],
          **{f"{k}_gap": f"{v:.3e}" for k, v in gaps.items()},
          **{f"{k}_bar": f"{v:g}" for k, v in MP_BARS.items()},
          peak_gb=f"{res['peak_gb']:.3f}",
          losses=",".join(f"{x:.6f}" for x in res["losses"]),
          **extra, card=f"'{card}'")
    for k, v in gaps.items():
        check(v <= MP_BARS[k], f"[{tag}] rank {res['rank']}: {k} gap {v} > "
              f"{MP_BARS[k]}")
    _priced_check(tag, res)
    for name, n in res["launches"].items():
        check(n == 12 * steps, f"[{tag}] rank {res['rank']}: {name} "
              f"launched {n} times, not 12 x {steps}")
    if tag == "tp_train":
        check(res["flash_shapes"] == [(MP_BATCH * 6, T, 64)],
              f"[tp_train] flash shapes {res['flash_shapes']}, not the "
              f"local heads' [{MP_BATCH * 6}, {T}, 64]")
    check(all(math.isfinite(x) for x in res["losses"]),
          f"[{tag}] non-finite loss")


def _sharded_ckpt(pool, spec, tp, path, card):
    """[sharded_ckpt] at two ranks: the checkpoint [tp_train]'s ranks
    wrote, loaded at two ranks: each parameter's sha256 reassembled
    equals the one gathered before the save, and the next loss equals
    [tp_train]'s next loss within its bar."""
    loaded = pool.run(mp_load_run, {**spec, "mesh": "1,2",
                                    "save": path("ckpt")})
    for res, ref in zip(loaded, tp):
        bad = [k for k, h in ref["sha256"].items()
               if res["sha256"][k] != h]
        gap = abs(res["next_loss"] - ref["next_loss"])
        phase("sharded_ckpt", ranks=MP_WORLD, params=len(ref["sha256"]),
              sha256_mismatches=len(bad), next_loss=f"{res['next_loss']:.6f}",
              tp_next_loss=f"{ref['next_loss']:.6f}",
              loss_gap=f"{gap:.3e}", loss_bar=MP_BARS["loss"],
              files=len(os.listdir(path("ckpt"))), card=f"'{card}'")
        check(not bad, f"[sharded_ckpt] sha256 differs for {bad[:3]}")
        check(gap <= MP_BARS["loss"], f"[sharded_ckpt] next loss gap {gap}")


def one_rank_ckpt(spec, tp, path, card):
    """[sharded_ckpt] at one rank: the two ranks' checkpoint loaded whole
    in this process, sha256 of each parameter against the gathered one,
    and one step of the one-rank program from it against [tp_train]'s
    next loss."""
    import torch
    import paddle_tpu_torch as ptt
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg, main, _, loss = _mp_build(ptt, spec)
        exe = ptt.Executor(ptt.CUDAPlace(0))
        scope = ptt.Scope()
        ptt.load_sharded_persistables(exe, path("ckpt"), main, scope=scope)
        ref = tp[0]
        bad = [k for k, h in ref["sha256"].items()
               if _sha(scope.get_numpy(k)) != h]
        lv = float(exe.run(main, feed=_dp_feed(cfg.vocab_size,
                                               spec["batch"], T),
                           fetch_list=[loss], scope=scope)[0])
    finally:
        torch.use_deterministic_algorithms(was)
    gap = abs(lv - ref["next_loss"])
    phase("sharded_ckpt", ranks=1, params=len(ref["sha256"]),
          sha256_mismatches=len(bad), next_loss=f"{lv:.6f}",
          tp_next_loss=f"{ref['next_loss']:.6f}", loss_gap=f"{gap:.3e}",
          loss_bar=MP_BARS["loss"], card=f"'{card}'")
    check(not bad, f"[sharded_ckpt] one rank: sha256 differs for {bad[:3]}")
    check(gap <= MP_BARS["loss"], f"[sharded_ckpt] one rank: next loss "
          f"gap {gap}")


def _seq_line(tag, ranks, one, card, ring=None):
    """A sequence-parallel cell's lines: each rank's loss and gradient
    gaps to the one-rank run within SEQ_BARS, its launches a step (ring:
    rank r runs r + 1 blocks of each kernel at sp2; Ulysses one launch a
    kernel at [6, 8192, 64]), the op-level errors within SEQ_OP_TOL, and
    for Ulysses its output against the ring's within that bar too."""
    import numpy as np
    steps = SEQ_STEPS - 1
    for res in ranks:
        loss_gap = max(abs(a - b) for a, b in zip(res["losses"],
                                                  one["losses"]))
        grad_gap = float(np.linalg.norm(res["grad"] - one["grad"])
                         / np.linalg.norm(one["grad"]))
        extra = {}
        if ring is not None:
            other = ring[res["rank"]]
            extra["vs_ring_out_max_abs"] = \
                f"{float(np.abs(res['op_out'] - other['op_out']).max()):.3e}"
            check(float(extra["vs_ring_out_max_abs"]) <= SEQ_OP_TOL,
                  f"[{tag}] output vs the ring's {extra}")
        phase(tag, rank=res["rank"], sp=MP_WORLD, T=SEQ_T,
              rows_per_rank=SEQ_T // MP_WORLD, d=SEQ_D, heads=SEQ_HEADS,
              steps=SEQ_STEPS,
              device_ms_median=f"{sorted(res['device_ms'])[len(res['device_ms']) // 2]:.3f}",
              one_rank_device_ms=f"{sorted(one['device_ms'])[len(one['device_ms']) // 2]:.3f}",
              **{f"{k}_launches_per_step": v // steps
                 for k, v in res["launches"].items()},
              flash_shapes=";".join("x".join(map(str, s))
                                    for s in res["flash_shapes"]),
              collective_bytes_step=res["moved_step"],
              collective_bytes_per_step_estimate=res[
                  "collective_bytes_estimate"],
              gloo_host_staged_bytes_step=res["staged_step"],
              loss_gap=f"{loss_gap:.3e}", grad_gap=f"{grad_gap:.3e}",
              **{f"{k}_bar": v for k, v in SEQ_BARS.items()},
              op_max_abs_err=",".join(f"{e:.3e}" for e in res["op_errs"]),
              op_tol=SEQ_OP_TOL, **extra,
              losses=",".join(f"{x:.6f}" for x in res["losses"]),
              card=f"'{card}'")
        _priced_check(tag, res)
        check(loss_gap <= SEQ_BARS["loss"], f"[{tag}] loss gap {loss_gap}")
        check(grad_gap <= SEQ_BARS["grad"], f"[{tag}] grad gap {grad_gap}")
        check(max(res["op_errs"]) <= SEQ_OP_TOL,
              f"[{tag}] op errors {res['op_errs']}")
        want = res["rank"] + 1 if tag == "ring_train" else 1
        for name, n in res["launches"].items():
            check(n == want * steps, f"[{tag}] rank {res['rank']}: {name} "
                  f"launched {n} times, not {want} x {steps}")
        if tag == "ulysses_train":
            check(res["flash_shapes"] == [(SEQ_HEADS // MP_WORLD, SEQ_T,
                                           SEQ_D // SEQ_HEADS)],
                  f"[{tag}] flash shapes {res['flash_shapes']}")


def _moe_lines(one, dense, sparse, tight, card):
    """[moe_train]: the dense run's losses against one rank's within
    MOE_TOL relative; the sparse runs' first-step output (capacity
    factor 1.25, and a tenth of it, which drops tokens): dropped rows
    exactly 0, kept rows within MOE_TOL of the dense output's largest
    entry; the gate weight's first-step gradient within MOE_GRAD_BAR
    (dense, and capacity 1.25 where no row drops); every load in (0, 1]; each rank holds
    half the experts; the bytes moved as the analyzer priced them."""
    import numpy as np
    ref = one["y"].reshape(-1, MOE_D)
    scale = float(np.abs(ref).max())
    for kind, ranks in (("dense", dense), ("sparse", sparse),
                        ("sparse_tight", tight)):
        for res in ranks:
            rows = res["y"].reshape(-1, MOE_D)
            zero = np.all(rows == 0.0, axis=-1)
            kept = ~zero if kind != "dense" else np.ones_like(zero)
            err = float(np.abs(rows[kept] - ref[kept]).max()) / scale
            loss_rel = max(abs(a - b) / abs(b) for a, b in
                           zip(res["losses"], one["losses"]))
            grad_gap = _grad_gap(res["grad"], one["grad"], 0)
            phase("moe_train", kind=kind, rank=res["rank"], ep=MP_WORLD,
                  experts=MOE_E, d_model=MOE_D, d_ff=MOE_FF,
                  tokens=MOE_B * MOE_T,
                  capacity={"dense": "none", "sparse": MOE_CAPACITY,
                            "sparse_tight": MOE_TIGHT}[kind],
                  dropped_rows=int(zero.sum()), kept_rel_err=f"{err:.3e}",
                  loss_rel_gap=f"{loss_rel:.3e}", tol=MOE_TOL,
                  grad_gap=f"{grad_gap:.3e}", grad_bar=MOE_GRAD_BAR,
                  loads=",".join(f"{x:.4f}" for x in res["loads"]),
                  expert_bytes=res["expert_bytes"],
                  one_rank_expert_bytes=one["expert_bytes"],
                  collective_bytes_step=res["moved_step"],
                  collective_bytes_per_step_estimate=res[
                      "collective_bytes_estimate"],
                  gloo_host_staged_bytes_step=res["staged_step"],
                  device_ms=",".join(f"{x:.3f}" for x in res["device_ms"]),
                  losses=",".join(f"{x:.6f}" for x in res["losses"]),
                  card=f"'{card}'")
            check(err <= MOE_TOL, f"[moe_train] {kind}: kept rows {err}")
            check(all(0.0 < x <= 1.0 for x in res["loads"]),
                  f"[moe_train] {kind}: loads {res['loads']}")
            check(res["expert_bytes"] * MP_WORLD == one["expert_bytes"],
                  f"[moe_train] {kind}: a rank holds {res['expert_bytes']} B "
                  f"of experts, not half of {one['expert_bytes']}")
            if kind != "sparse_tight":
                # a dropped row changes the function: the gradient is
                # held where none drops (capacity 1.25 on this data)
                check(grad_gap <= MOE_GRAD_BAR or
                      (kind == "sparse" and zero.any()),
                      f"[moe_train] {kind}: gradient gap {grad_gap}")
                _priced_check("moe_train", res)
            if kind == "dense":
                check(not zero.any() and loss_rel <= MOE_TOL,
                      f"[moe_train] dense: loss gap {loss_rel}")
            if kind == "sparse_tight":
                check(zero.any(), "[moe_train] sparse_tight: no token "
                      "dropped at a tenth of the capacity")


def _recompute_build(ptt, recompute):
    """[train]'s program built by hand as build_train(amp=True) builds
    it: the encoder and the LM loss, the AMP casts
    (mixed_precision.rewrite_program, as decorate's backward inserts
    them), then AdamW through the decorator; with `recompute`,
    RecomputeOptimizer around it, checkpointed at each layer's output,
    so the segments hold the casts."""
    from paddle_tpu_torch.contrib import mixed_precision as mp
    from paddle_tpu_torch.contrib.mixed_precision.decorator import \
        rewrite_program
    from paddle_tpu_torch.models import transformer
    cfg = transformer.bert_base(dropout=0.1, attn_dropout=0.0,
                                use_flash=True)
    batch = TRAIN_RUNS[True][0]
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    L = ptt.layers
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        tokens = L.data("tokens", shape=[batch, T], dtype="int64",
                        append_batch_size=False)
        labels = L.data("labels", shape=[batch, T], dtype="int64",
                        append_batch_size=False)
        hidden = transformer.encoder(tokens, cfg)
        loss = transformer.lm_loss(hidden, labels, cfg)
        rewrite_program(main)
        opt = mp.decorate(ptt.optimizer.AdamW(learning_rate=1e-4))
        if recompute:
            opt = ptt.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints([
                op.outputs["Y"][0] for op in main.global_block().ops
                if op.type == "layer_norm"
                and op.inputs["Scale"][0].endswith(".ln2.w")])
        opt.minimize(loss)
    return cfg, main, startup, loss


def recompute_phase(torch, card):
    """[recompute_train]: the plain and the recompute program from one
    startup state, RECOMPUTE_STEPS (warm-up, timed) steps each under
    deterministic algorithms; losses equal within RECOMPUTE_TOL, the
    recompute run's peak below the plain one's, 24 forward / 12 dq / 12
    dK/dV launches a timed step; [recompute_plan] holds the planner's
    peak of the recompute program to the measured one. Returns the
    recompute run's bf16 launches."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    warm, timed = RECOMPUTE_STEPS
    out = {}
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    init = None
    try:
        for rec in (False, True):
            cfg, main, startup, loss = _recompute_build(ptt, rec)
            scope = ptt.Scope()
            exe = ptt.Executor(ptt.CUDAPlace(0))
            exe.run(startup, scope=scope)
            if init is None:
                init = {n: scope.get_numpy(n) for n in scope.names()}
            else:
                scope_from_numpy(init, scope, ptt.CUDAPlace(0),
                                 program=main)
            toks = np.random.RandomState(0).randint(
                0, cfg.vocab_size, (TRAIN_RUNS[True][0], T)).astype("int64")
            feed = {"tokens": toks, "labels": toks}
            losses, peaks, device = [], [], []
            for i in range(warm + timed):
                if i == warm:
                    _zero_launch_counts()
                torch.cuda.synchronize()
                foreign = torch.cuda.memory_allocated() - \
                    scope_device_bytes(torch, scope)
                torch.cuda.reset_peak_memory_stats()
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(2)]
                ev[0].record()
                losses.append(float(exe.run(main, feed=feed,
                                            fetch_list=[loss],
                                            scope=scope)[0]))
                ev[1].record()
                torch.cuda.synchronize()
                device.append(ev[0].elapsed_time(ev[1]))
                peaks.append(((torch.cuda.max_memory_allocated() - foreign)
                              / 1e9, foreign / 1e9))
            out[rec] = {"losses": losses, "launches": _launch_counts(),
                        "peak": max(peaks[warm:]), "device_ms": device,
                        "plan": planned_plan(main, feed, [loss])
                        if rec else None,
                        "segments": sum(op.type == "recompute_segment"
                                        for op in main.global_block().ops)}
            del scope, exe
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(was)
    plain, rec = out[False], out[True]
    gap = max(abs(a - b) / abs(b) for a, b in zip(rec["losses"],
                                                  plain["losses"]))
    phase("recompute_train", batch=TRAIN_RUNS[True][0], T=T, amp=True,
          dropout=0.1, segments=rec["segments"], steps=warm + timed,
          **{f"{k}_launches_per_step": v // timed
             for k, v in rec["launches"].items()},
          peak_gb=f"{rec['peak'][0]:.3f}",
          plain_peak_gb=f"{plain['peak'][0]:.3f}",
          device_ms_median=f"{sorted(rec['device_ms'][warm:])[timed // 2]:.3f}",
          plain_device_ms_median=f"{sorted(plain['device_ms'][warm:])[timed // 2]:.3f}",
          loss_rel_gap=f"{gap:.3e}", tol=RECOMPUTE_TOL,
          losses=",".join(f"{x:.6f}" for x in rec["losses"]),
          plain_losses=",".join(f"{x:.6f}" for x in plain["losses"]),
          card=f"'{card}'")
    check(gap <= RECOMPUTE_TOL, f"[recompute_train] loss gap {gap}")
    check(rec["peak"][0] < plain["peak"][0],
          f"[recompute_train] peak {rec['peak'][0]} not below the plain "
          f"run's {plain['peak'][0]}")
    want = {"flash_attention_fwd": 24, "flash_attention_bwd_dq": 12,
            "flash_attention_bwd_dkv": 12}
    for k, n in rec["launches"].items():
        check(n == want[k] * timed, f"[recompute_train] {k} launched {n} "
              f"times, not {want[k]} x {timed}")
    plan_gate("recompute_plan", rec["plan"], rec["peak"][0], rec["peak"][1],
              card)
    return rec["launches"]


# -- slice 23: the pipeline and the CRF/CTC book model --------------------

PP_WORLD = 2
PP_BATCH = 32            # 4 microbatches of 8
PP_MICRO = 4
PP_STEPS = 3             # a warm-up step, then the timed ones
PP_LR = 1e-3             # SGD on the float32 master weights
# [pp_train] bars on the pipeline's loss gap (relative, every step) and
# its first-step gradient gap (relative Frobenius over a rank's stage)
# against the same 12 layers in one process. The controls must fail
# them: the replication's backward summed over pp doubles every
# gradient (gap 1.0); stage 0 fed microbatch t-1 moves the loss.
# tools/torch_rounding_sensitivity.py pp on the CPU (d 128, 4 layers,
# T 128, batch 8, 4 microbatches), loss / grad: bf16 autocast, two
# ranks 0 / 1.292e-03, the input moved by 1e-3 8.486e-05 / 8.182e-03,
# replica_bwd_summed 4.235e-05 / 1.000, stage0_lagged 67.33 / 9.743;
# float32, two ranks 0 / 6.853e-08, moved 7.274e-05 / 2.787e-03.
PP_BARS = {"loss": 1e-3, "grad": 0.05}
PP_CONTROLS = {"replica_bwd_summed": "grad", "stage0_lagged": "loss"}
SECTION_SPLIT = (4, 4, 4)  # [section_pipeline]: layers a section
SECTION_BATCH = 16         # 4 microbatches of 4, float32
# the same tool's section reading (float32, 2+1+1 layers): loss gap 0,
# gradient gap 9.461e-08
SECTION_BARS = {"loss": 1e-5, "grad": 1e-4}
PP_REPLICA_STEPS = 2
# the book's label_semantic_roles (test_label_semantic_roles.py): CoNLL-05
# dictionary sizes (stand-ins: the dictionaries are not in the repo)
SRL_WORDS, SRL_PREDS, SRL_LABELS, SRL_MARKS = 44068, 3162, 59, 2
SRL_WORD_DIM, SRL_MARK_DIM, SRL_HIDDEN, SRL_DEPTH = 32, 5, 512, 8
SRL_BATCH, SRL_MAX_T = 10, 64
SRL_STEPS = 20           # two batches, ten passes
SRL_CHECK_STEPS = 3
# ten times tools/torch_rounding_sensitivity.py srl's reading: the word
# and predicate embeddings moved by 1e-6 move the float32 losses by
# 9.515e-08 (relative) on the CPU
SRL_LOSS_RTOL = 1e-6


def pp_dims(spec):
    """(d, heads, d_ff, layers, batch, T) of a [pp_train] spec."""
    return tuple(spec.get(k, v) for k, v in (
        ("d", 768), ("heads", 12), ("ff", 3072), ("layers", 12),
        ("batch", PP_BATCH), ("T", T)))


def pp_encoder_params(torch, d, ff, layers, seed=SEED):
    """BERT encoder layers' weights from a seed, float32 on the host:
    {name: [layers, ...]} (normal 0.02, zero biases, unit LN scales)."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"wq": (d, d), "wk": (d, d), "wv": (d, d), "wo": (d, d),
              "w1": (d, ff), "w2": (ff, d)}
    out = {k: torch.randn((layers, *s), generator=g) * 0.02
           for k, s in shapes.items()}
    for k, n in (("bq", d), ("bk", d), ("bv", d), ("bo", d), ("b1", ff),
                 ("b2", d), ("ln1_b", d), ("ln2_b", d)):
        out[k] = torch.zeros(layers, n)
    out["ln1_g"] = torch.ones(layers, d)
    out["ln2_g"] = torch.ones(layers, d)
    return out


def pp_layer(torch, p, h, heads):
    """One post-LN BERT encoder layer on the port's flash entry point
    (ops/cuda/flash_attention.flash_attention: the forward kernel, and
    the dQ and dK/dV kernels in its backward)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention
    b, t, d = h.shape

    def heads_of(w, bias):
        return (h @ w + bias).reshape(b, t, heads, d // heads) \
            .transpose(1, 2)
    a = flash_attention(heads_of(p["wq"], p["bq"]),
                        heads_of(p["wk"], p["bk"]),
                        heads_of(p["wv"], p["bv"]))
    a = a.transpose(1, 2).reshape(b, t, d)
    h = F.layer_norm(h + a @ p["wo"] + p["bo"], (d,), p["ln1_g"],
                     p["ln1_b"])
    f = F.gelu(h @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]
    return F.layer_norm(h + f, (d,), p["ln2_g"], p["ln2_b"])


def pp_stage_fn(torch, heads):
    """stage_fn over a stage's layers ({name: [layers, ...]})."""
    def stage(p, h):
        for i in range(next(iter(p.values())).shape[0]):
            h = pp_layer(torch, {k: v[i] for k, v in p.items()}, h, heads)
        return h
    return stage


def _pp_control(kind):
    """Break the pipeline on purpose, as a control for PP_BARS:
    'replica_bwd_summed' sums dL/dout over pp in the replication's
    backward (the transpose of psum(outputs * mask) taken literally:
    the last stage gets it n_stages times); 'stage0_lagged' makes stage 0
    inject microbatch t-1 at tick t. Returns the function that repairs
    it."""
    import torch
    from paddle_tpu_torch.ops import collective as coll
    from paddle_tpu_torch.parallel import pipeline as pl
    fwd, bwd = pl._GPipe.forward, pl._GPipe.backward
    if kind == "replica_bwd_summed":
        def backward(ctx, dout):
            return bwd(ctx, coll.all_reduce(dout, ctx.group))
        pl._GPipe.backward = staticmethod(backward)
    else:
        def forward(ctx, stage_fn, tree, group, n, idx, x_mb, *params):
            if idx == 0:
                x_mb = torch.cat([x_mb[:1], x_mb[:-1]])
            return fwd(ctx, stage_fn, tree, group, n, idx, x_mb, *params)
        pl._GPipe.forward = staticmethod(forward)

    def repair():
        pl._GPipe.forward = staticmethod(fwd)
        pl._GPipe.backward = staticmethod(bwd)
    return repair


def pp_train_run(spec):
    """[pp_train]'s step, SGD on float32 master weights under bf16
    autocast (spec["amp"]): the encoder of pp_dims(spec) through gpipe
    over a ("pp",) mesh of the process group's ranks (spec["pipe"]), or
    the same layers in sequence over the whole batch in this process,
    the activation cast to the input's dtype between the two halves as
    gpipe casts it. Loss: mean((out - x)^2) on the replicated output.
    spec: place, steps, control (a PP_CONTROLS kind), pert (the input
    moved by that much seeded noise, the target kept), out (an npz for the
    first step's gradients, one process), ref (that npz: a rank's
    first-step gradient gap over its stage). Returns the losses, per
    step ms, the flash launches and stage_fn calls a step after the
    first, the p2p, broadcast and host-staged bytes a step, the peak
    memory and the gradient gap."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import collective as coll
    from paddle_tpu_torch.parallel import gpipe, pipeline
    from paddle_tpu_torch.parallel.mesh import make_mesh, world

    d, heads, ff, layers, batch, t = pp_dims(spec)
    cuda = spec["place"] != "cpu"
    dev = torch.device("cuda" if cuda else "cpu")
    repair = _pp_control(spec["control"]) if spec.get("control") else None
    try:
        params = {k: v.to(dev).requires_grad_() for k, v in
                  pp_encoder_params(torch, d, ff, layers).items()}
        g = torch.Generator().manual_seed(SEED + 1)
        dtype = torch.bfloat16 if spec["amp"] else torch.float32
        x = torch.randn((batch, t, d), generator=g)
        # the target is the input itself: a microbatch out of place
        # moves the loss far more than rounding does
        y = x.to(dev)
        if spec.get("pert"):
            x = x * (1 + spec["pert"] * torch.randn(x.shape, generator=g))
        x = x.to(dev, dtype)
        size, rank = world()
        n_st = size if spec["pipe"] else 2
        stacked = {k: v.reshape(n_st, layers // n_st, *v.shape[1:])
                   for k, v in params.items()}
        stage = pp_stage_fn(torch, heads)
        mesh = make_mesh((size,), ("pp",)) if spec["pipe"] else None

        def forward():
            with torch.autocast(dev.type, dtype=torch.bfloat16,
                                enabled=spec["amp"]):
                if spec["pipe"]:
                    out = gpipe(stage, stacked, x, n_microbatches=spec.get(
                        "micro", PP_MICRO), mesh=mesh, axis="pp")
                else:
                    out = x
                    for s in range(n_st):
                        out = stage({k: v[s] for k, v in stacked.items()},
                                    out).to(dtype)
            return ((out.float() - y) ** 2).mean()

        losses, ms, grad_gap = [], [], None
        for step in range(spec["steps"]):
            if step == 1:
                if cuda:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                coll.reset_counts()
                _zero_launch_counts()
                pipeline.STAGE_CALLS["calls"] = 0
            t0 = time.perf_counter()
            loss = forward()
            loss.backward()
            with torch.no_grad():
                if step == 0:
                    grads = {k: v.grad.float().cpu().numpy()
                             for k, v in params.items()}
                for v in params.values():
                    v -= PP_LR * v.grad
                    v.grad = None
            losses.append(float(loss.detach()))
            if cuda:
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        if spec.get("out"):
            np.savez(spec["out"], **grads)
        if spec.get("ref"):
            ref = np.load(spec["ref"])
            per = layers // n_st
            mine = slice(rank * per, (rank + 1) * per) if spec["pipe"] \
                else slice(None)
            num = sum(float(np.sum((grads[k][mine].astype(np.float64)
                                    - ref[k][mine]) ** 2)) for k in grads)
            den = sum(float(np.sum(ref[k][mine].astype(np.float64) ** 2))
                      for k in grads)
            grad_gap = math.sqrt(num / den)
        n = max(spec["steps"] - 1, 1)
        return {"rank": rank, "losses": losses, "ms": ms[1:],
                "launches": {k: v // n for k, v in
                             _launch_counts().items()},
                "stage_calls_step": pipeline.STAGE_CALLS["calls"] // n,
                "p2p_bytes_step": coll.COLLECTIVE_BYTES["p2p"] // n,
                "bcast_bytes_step": coll.COLLECTIVE_BYTES["broadcast"] // n,
                "staged_bytes_step": coll.STAGED_BYTES["bytes"] // n,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9
                if cuda else None, "grad_gap": grad_gap}
    finally:
        if repair is not None:
            repair()


def pp_gaps(res, one):
    """(largest relative loss gap over the steps, first-step gradient
    gap) of a pipeline result against the one-process run."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                   one["losses"]))
    return loss, res["grad_gap"]


def section_pipeline_run(spec):
    """[section_pipeline]: SectionPipeline.grad over the encoder of
    pp_dims(spec) cut into SECTION_SPLIT sections, spec["micro"]
    microbatches, float32, against one torch.autograd.grad of the same
    loss over the whole batch, each timed on its second call. Returns
    (loss gap, gradient gap (relative Frobenius over every weight),
    pipeline ms, whole-batch ms, the timed pipeline call's flash
    launches)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.parallel import SectionPipeline

    d, heads, ff, layers, batch, t = pp_dims(spec)
    cuda = spec["place"] != "cpu"
    dev = torch.device("cuda" if cuda else "cpu")
    params = {k: v.to(dev) for k, v in
              pp_encoder_params(torch, d, ff, layers).items()}
    g = torch.Generator().manual_seed(SEED + 2)
    x = torch.randn((batch, t, d), generator=g).to(dev)
    y = torch.randn((batch, t, d), generator=g).to(dev)
    cuts = np.cumsum((0,) + tuple(spec.get("split", SECTION_SPLIT)))
    sections = [{k: v[a:b] for k, v in params.items()}
                for a, b in zip(cuts[:-1], cuts[1:])]
    stage = pp_stage_fn(torch, heads)

    def loss_fn(out, yb):
        return ((out - yb) ** 2).mean()

    def timed(fn):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    pipe = SectionPipeline([stage] * len(sections), spec.get("micro",
                                                             PP_MICRO))
    pipe.grad(loss_fn, sections, x, y)  # first calls plan new shapes
    _zero_launch_counts()
    (loss, grads), ms = timed(lambda: pipe.grad(loss_fn, sections, x, y))
    launches = _launch_counts()
    leaves = [v.clone().requires_grad_() for s in sections
              for v in s.values()]

    def whole():
        it = iter(leaves)
        h = x
        for s in sections:
            h = stage({k: next(it) for k in s}, h)
        ll = loss_fn(h, y)
        return ll, torch.autograd.grad(ll, leaves)
    whole()
    (ref_loss, ref_grads), ref_ms = timed(whole)
    got = [g_ for s in grads for g_ in s.values()]
    num = sum(float(((a.double() - b.double()) ** 2).sum())
              for a, b in zip(got, ref_grads))
    den = sum(float((b.double() ** 2).sum()) for b in ref_grads)
    ref_loss = float(ref_loss.detach())
    return (abs(float(loss) - ref_loss) / abs(ref_loss),
            math.sqrt(num / den), ms, ref_ms, launches)


def pp_replicas_run(spec):
    """[pp_replicas]: [dp_train]'s BERT program (dp_train_run's spec)
    through the executor on a dp1 x pp2 mesh (its SpecLayout the state
    specs) for spec["steps"] steps from spec["init"], under torch's
    deterministic algorithms; in one process without a process group.
    Returns the losses, the sha256 of every parameter, the largest
    parameter gap to spec["ref"] (an npz spec["out"] wrote), the flash
    launches of the steps, the sharding gate's priced bytes a step and
    the rank."""
    import hashlib
    import numpy as np
    import torch
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.parallel.layout import SpecLayout
    from paddle_tpu_torch.parallel.mesh import make_mesh, world

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg, main, startup, loss = _dp_build(ptt, spec)
        place = _place(ptt, spec)
        scope = ptt.Scope()
        exe = ptt.Executor(place)
        exe.run(startup, scope=scope)
        scope_from_numpy(dict(np.load(spec["init"])), scope, place,
                         program=main)
        prog = ptt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        if world()[0] > 1:
            mesh = make_mesh((1, world()[0]), ("dp", "pp"))
            prog = prog.with_distributed(
                mesh, state_spec_fn=SpecLayout(mesh).add_program(main),
                batch_axes=("dp",))
        feed = _dp_feed(cfg.vocab_size, spec["batch"], spec["T"])
        _zero_launch_counts()
        losses = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                                scope=scope)[0])
                  for _ in range(spec["steps"])]
        digest = hashlib.sha256()
        names = sorted(v.name for v in main.list_vars()
                       if getattr(v, "is_parameter", False))
        params = {p: scope.get_numpy(p) for p in names}
        for p in names:
            digest.update(np.ascontiguousarray(params[p]).tobytes())
        if spec.get("out"):
            np.savez(spec["out"], **params)
        gap = None
        if spec.get("ref"):
            ref = np.load(spec["ref"])
            gap = max(float(np.abs(params[p].astype(np.float64)
                                   - ref[p]).max()) for p in names)
        report = exe.last_sharding_report
        return {"rank": world()[1], "losses": losses, "param_gap": gap,
                "params_sha": digest.hexdigest(),
                "launches": _launch_counts(),
                "priced_bytes": report.collective_bytes_per_step
                if report is not None else 0}
    finally:
        torch.use_deterministic_algorithms(was)


def pp_phases(torch, card):
    """[pp_train], [pp_control], [pp_replicas] over PP_WORLD rank
    processes (gloo on cuda:0 where the machine has one card, as
    mp_phases), then [section_pipeline] in this process. Returns
    ({kernel: bf16 launches}, {kernel: float32 launches}) of the main
    path runs."""
    import numpy as np
    from paddle_tpu_torch.distributed.spawn import RankPool

    backend, device = dp_backend(torch)
    tmp = tempfile.TemporaryDirectory(prefix="pp_")
    path = lambda name: os.path.join(tmp.name, name)  # noqa: E731
    bf16 = dict.fromkeys(KERNEL_SOURCES, 0)
    f32 = dict.fromkeys(KERNEL_SOURCES, 0)
    spec = {"place": "cuda", "amp": True, "steps": PP_STEPS,
            "pipe": False, "control": None}
    rspec = {"cfg": {}, "batch": TRAIN_RUNS[True][0], "T": T, "amp": True,
             "flash": True, "place": "cuda", "steps": PP_REPLICA_STEPS,
             "init": path("bert.npz")}
    try:
        one = pp_train_run({**spec, "out": path("one.npz")})
        dp_startup_state({**rspec, "mesh": None}, rspec["init"])
        rep_one = pp_replicas_run({**rspec, "out": path("bert_one.npz")})
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pool = RankPool(PP_WORLD, path("store"), backend=backend,
                        timeout_s=DP_TIMEOUT_S, device=device)
        try:
            start_s = time.perf_counter() - t0
            ranks = pool.run(pp_train_run, {**spec, "pipe": True,
                                             "ref": path("one.npz")})
            for res in ranks:
                loss_gap, grad_gap = pp_gaps(res, one)
                act = PP_BATCH // PP_MICRO * T * 768 * 2  # bf16
                phase("pp_train", rank=res["rank"], backend=backend,
                      stages=PP_WORLD, layers_a_stage=12 // PP_WORLD,
                      microbatches=PP_MICRO, batch=PP_BATCH, T=T,
                      loss=f"{res['losses'][-1]:.6f}",
                      loss_gap=f"{loss_gap:.3e}", grad_gap=f"{grad_gap:.3e}",
                      bars=f"{PP_BARS['loss']}/{PP_BARS['grad']}",
                      ms_step=f"{np.median(res['ms']):.1f}",
                      one_process_ms_step=f"{np.median(one['ms']):.1f}",
                      stage_calls_step=res["stage_calls_step"],
                      launches_step=",".join(str(v) for v in
                                             res["launches"].values()),
                      p2p_bytes_step=res["p2p_bytes_step"],
                      transfer_bytes=act,
                      bcast_bytes_step=res["bcast_bytes_step"],
                      staged_bytes_step=res["staged_bytes_step"],
                      peak_gb=f"{res['peak_gb']:.2f}",
                      one_process_peak_gb=f"{one['peak_gb']:.2f}",
                      start_s=f"{start_s:.1f}", card=f"'{card}'")
                check(loss_gap <= PP_BARS["loss"] and
                      grad_gap <= PP_BARS["grad"],
                      f"[pp_train] rank {res['rank']}: gaps {loss_gap}, "
                      f"{grad_gap} past {PP_BARS}")
                want = 12 // PP_WORLD * PP_MICRO
                check(all(v == want for v in res["launches"].values()) and
                      res["stage_calls_step"] == PP_MICRO,
                      f"[pp_train] rank {res['rank']}: launches a step "
                      f"{res['launches']}, stage calls "
                      f"{res['stage_calls_step']}; {want} and {PP_MICRO} "
                      f"wanted (bubbles skipped)")
                # stage 0 sends its activations, stage 1 their gradients
                check(res["p2p_bytes_step"] == PP_MICRO * act,
                      f"[pp_train] rank {res['rank']}: "
                      f"{res['p2p_bytes_step']} p2p bytes a step, not "
                      f"{PP_MICRO * act}")
                for k in bf16:
                    bf16[k] += res["launches"][k] * (PP_STEPS - 1)
            for kind, bar in PP_CONTROLS.items():
                res = pool.run(pp_train_run, {
                    **spec, "pipe": True, "control": kind, "steps": 1,
                    "ref": path("one.npz")})
                gaps = dict(zip(("loss", "grad"), pp_gaps(
                    {**res[0], "grad_gap": max(r["grad_gap"] for r in res)},
                    one)))
                phase("pp_control", control=kind, steps=1,
                      loss_gap=f"{gaps['loss']:.3e}",
                      grad_gap=f"{gaps['grad']:.3e}",
                      must_be_rejected_by=bar, card=f"'{card}'")
                check(gaps[bar] > PP_BARS[bar], f"[pp_control] {kind} "
                      f"passes the {bar} bar ({gaps[bar]})")
            reps = pool.run(pp_replicas_run, {**rspec,
                                              "ref": path("bert_one.npz")})
            for res in reps:
                lgap = max(abs(a - b) / abs(b) for a, b in
                           zip(res["losses"], rep_one["losses"]))
                phase("pp_replicas", rank=res["rank"], mesh="dp1xpp2",
                      steps=PP_REPLICA_STEPS,
                      loss=f"{res['losses'][-1]:.6f}",
                      loss_gap_vs_one_rank=f"{lgap:.3e}",
                      param_gap_vs_one_rank=f"{res['param_gap']:.3e}",
                      bars=f"{ZERO_BARS['loss']}/{ZERO_BARS['param']}",
                      params_bitwise_equal_across_ranks=res["params_sha"]
                      == reps[0]["params_sha"],
                      params_bitwise_equal_to_one_rank=res["params_sha"]
                      == rep_one["params_sha"],
                      priced_bytes=res["priced_bytes"],
                      launches=",".join(str(v) for v in
                                        res["launches"].values()),
                      card=f"'{card}'")
                check(lgap <= ZERO_BARS["loss"] and
                      res["param_gap"] <= ZERO_BARS["param"],
                      f"[pp_replicas] rank {res['rank']} against one "
                      f"rank: loss gap {lgap}, parameter gap "
                      f"{res['param_gap']} past {ZERO_BARS}")
                check(res["priced_bytes"] == 0, f"[pp_replicas] the gate "
                      f"priced {res['priced_bytes']} B for pp")
                for k in bf16:
                    bf16[k] += res["launches"][k]
        finally:
            pool.close()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        loss_gap, grad_gap, ms, ref_ms, launches = section_pipeline_run(
            {"place": "cuda", "batch": SECTION_BATCH})
        phase("section_pipeline", sections="+".join(map(str,
                                                        SECTION_SPLIT)),
              microbatches=PP_MICRO, batch=SECTION_BATCH, T=T,
              dtype="float32", loss_gap=f"{loss_gap:.3e}",
              grad_gap=f"{grad_gap:.3e}",
              bars=f"{SECTION_BARS['loss']}/{SECTION_BARS['grad']}",
              ms=f"{ms:.1f}", whole_batch_ms=f"{ref_ms:.1f}",
              launches=",".join(str(v) for v in launches.values()),
              card=f"'{card}'")
        check(loss_gap <= SECTION_BARS["loss"] and
              grad_gap <= SECTION_BARS["grad"],
              f"[section_pipeline] gaps {loss_gap}, {grad_gap} past "
              f"{SECTION_BARS}")
        check(all(v == 12 * PP_MICRO for v in launches.values()),
              f"[section_pipeline] launches {launches}")
        for k in f32:
            f32[k] += launches[k]
    finally:
        tmp.cleanup()
    return bf16, f32


def srl_feeds(n_batches, batch=SRL_BATCH, max_t=SRL_MAX_T, seed=0):
    """Padded [batch, T <= max_t] feeds of the book's eight inputs and
    the target, per-row lengths from RandomState(seed)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_batches):
        lengths = rng.randint(max_t // 4, max_t + 1, batch)
        t = int(lengths.max())
        feed = {n: rng.randint(0, v, (batch, t)).astype(np.int64)
                for n, v in (("word", SRL_WORDS), ("ctx_n2", SRL_WORDS),
                             ("ctx_n1", SRL_WORDS), ("ctx_0", SRL_WORDS),
                             ("ctx_p1", SRL_WORDS), ("ctx_p2", SRL_WORDS),
                             ("predicate", SRL_PREDS),
                             ("mark", SRL_MARKS), ("target", SRL_LABELS))}
        feed["length"] = lengths.astype(np.int64)
        out.append(feed)
    return out


def build_srl(f, word_dim=SRL_WORD_DIM, mark_dim=SRL_MARK_DIM,
              hidden=SRL_HIDDEN, depth=SRL_DEPTH):
    """The book's db_lstm (chapter 07): the word and five context words
    through one frozen embedding 'emb', the predicate ('vemb') and mark
    embeddings, an fc (tanh) each summed, then `depth` dynamic_lstm
    (candidate relu, gate and cell sigmoid) alternating direction, each
    fed the sum of two fcs of the previous mix and LSTM; the CRF loss
    ('crfw' at learning rate 1e-3), SGD at exponential_decay(0.01, 1e5,
    0.5, staircase), crf_decoding and chunk_eval (IOB, 29 chunk types).
    Padded [B, T] inputs with a `length` var. Returns (loss, decoded,
    chunk_eval's outputs)."""
    L = f.layers
    names = ("word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2",
             "predicate", "mark", "target")
    v = {n: L.data(n, shape=[-1, -1], dtype="int64",
                   append_batch_size=False) for n in names}
    length = L.data("length", shape=[-1], dtype="int64",
                    append_batch_size=False)
    embs = [L.embedding(v[n], size=[SRL_WORDS, word_dim],
                        param_attr=f.ParamAttr(name="emb", trainable=False))
            for n in names[:6]]
    embs.append(L.embedding(v["predicate"], size=[SRL_PREDS, word_dim],
                            param_attr="vemb"))
    embs.append(L.embedding(v["mark"], size=[SRL_MARKS, mark_dim]))
    hidden_0 = L.sums([L.fc(e, size=hidden, act="tanh", num_flatten_dims=2)
                       for e in embs])
    lstm_kw = dict(candidate_activation="relu", gate_activation="sigmoid",
                   cell_activation="sigmoid", sequence_length=length)
    lstm_0, _ = L.dynamic_lstm(hidden_0, size=hidden, **lstm_kw)
    mix, lstm = hidden_0, lstm_0
    for i in range(1, depth):
        mix = L.sums([L.fc(mix, size=hidden, act="tanh",
                           num_flatten_dims=2),
                      L.fc(lstm, size=hidden, act="tanh",
                           num_flatten_dims=2)])
        lstm, _ = L.dynamic_lstm(mix, size=hidden, is_reverse=i % 2 == 1,
                                 **lstm_kw)
    feature = L.sums([L.fc(mix, size=SRL_LABELS, act="tanh",
                           num_flatten_dims=2),
                      L.fc(lstm, size=SRL_LABELS, act="tanh",
                           num_flatten_dims=2)])
    crf = L.linear_chain_crf(feature, v["target"], length=length,
                             param_attr=f.ParamAttr(name="crfw",
                                                    learning_rate=1e-3))
    loss = L.mean(crf)
    f.optimizer.SGD(learning_rate=L.exponential_decay(
        learning_rate=0.01, decay_steps=100000, decay_rate=0.5,
        staircase=True)).minimize(loss)
    decoded = L.crf_decoding(feature, param_attr=f.ParamAttr(name="crfw"),
                             length=length)
    chunks = L.chunk_eval(decoded, v["target"], chunk_scheme="IOB",
                          num_chunk_types=int(math.ceil(
                              (SRL_LABELS - 1) / 2.0)), seq_length=length)
    return loss, decoded, chunks


def _srl_program(ptt):
    main, startup = ptt.Program(), ptt.Program()
    startup.random_seed = SEED
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss, decoded, chunks = build_srl(ptt)
    return main, startup, loss, decoded, chunks


def srl_train_phase(torch, card):
    """[srl_train]: the book's label_semantic_roles (build_srl) at its
    widths, float32, batch 10, T <= 64, SRL_STEPS SGD steps over two
    padded batches on the card, chunk_eval's counts read by
    metrics.ChunkEvaluator; its first SRL_CHECK_STEPS losses against the
    port's CPU run of the same program from the same startup state
    within SRL_LOSS_RTOL; losses finite and falling; host and device ms
    a step, tokens/s."""
    import numpy as np
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.metrics import ChunkEvaluator

    main, startup, loss, decoded, chunks = _srl_program(ptt)
    feeds = srl_feeds(2)
    cpu_scope = ptt.Scope()
    cpu = ptt.Executor(ptt.CPUPlace())
    cpu.run(startup, scope=cpu_scope)
    init = {n: cpu_scope.get_numpy(n) for n in cpu_scope.names()}
    cpu_losses = [float(cpu.run(main, feed=feeds[i % 2], fetch_list=[loss],
                                scope=cpu_scope)[0])
                  for i in range(SRL_CHECK_STEPS)]
    exe = ptt.Executor(ptt.CUDAPlace(0))
    scope = scope_from_numpy(init, ptt.Scope(), ptt.CUDAPlace(0),
                             program=main)
    metric = ChunkEvaluator()
    losses, host, device = [], [], []
    for i in range(SRL_STEPS):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        t0 = time.perf_counter()
        out = exe.run(main, feed=feeds[i % 2],
                      fetch_list=[loss, *chunks[3:]], scope=scope,
                      return_numpy=False)
        host.append((time.perf_counter() - t0) * 1e3)
        ev[1].record()
        torch.cuda.synchronize()
        device.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(out[0]))
        metric.update(*(int(o) for o in out[1:]))
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    tokens = np.mean([int(f["length"].sum()) for f in feeds])
    first, last = np.mean(losses[:2]), np.mean(losses[-2:])
    p, r, f1 = metric.eval()
    phase("srl_train", words=SRL_WORDS, predicates=SRL_PREDS,
          labels=SRL_LABELS, hidden=SRL_HIDDEN, depth=SRL_DEPTH,
          batch=SRL_BATCH, max_T=SRL_MAX_T, steps=SRL_STEPS,
          loss_first=f"{first:.4f}", loss_last=f"{last:.4f}",
          cpu_check_steps=SRL_CHECK_STEPS, cpu_loss_gap=f"{gap:.3e}",
          tol=SRL_LOSS_RTOL, host_ms=f"{np.median(host[1:]):.2f}",
          device_ms=f"{np.median(device[1:]):.2f}",
          tokens_per_s=f"{tokens / (np.median(host[1:]) / 1e3):.1f}",
          chunk_precision=f"{p:.4f}", chunk_recall=f"{r:.4f}",
          chunk_f1=f"{f1:.4f}", card=f"'{card}'")
    check(all(math.isfinite(x) for x in losses),
          f"[srl_train] non-finite losses {losses}")
    check(last < first, f"[srl_train] the loss did not fall ({first} -> "
          f"{last})")
    check(gap <= SRL_LOSS_RTOL, f"[srl_train] card vs CPU losses "
          f"{losses[:SRL_CHECK_STEPS]} / {cpu_losses} differ by {gap}")
    check(metric.num_label_chunks > 0, "[srl_train] chunk_eval counted "
          "no chunk")


def main():
    args = sys.argv[1:]
    if args not in ([], ["--mutants"], ["--ablations"]) and not (
            len(args) == 2 and args[0] == "--compare"):
        print("usage: python3 chip_smoke.py [--mutants | --ablations | "
              "--compare DIR]", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    if args[:1] == ["--compare"]:
        compare_phase(args[1])
        return 0
    if args == ["--ablations"]:
        ablation_phase()
        return 0
    gate_time = time_executor_gates()
    build_phase()
    smem_phase()
    if args == ["--mutants"]:
        missed = mutant_phase()
        check(not missed, f"mutants no check caught: {missed}")
        return 0

    fwd_errs = kernel_phase(torch)
    records = bwd_kernel_phase(torch)
    for key, err in fwd_errs.items():
        records[key]["flash_attention_fwd"]["max_abs_err"] = err
    bert_dir = tempfile.TemporaryDirectory(prefix="ptt_bert_")
    served = serve_phase(torch, card, bert_dir.name)
    gated = serve_gates_phase(torch, card, bert_dir.name, *served[1:3])
    trained, train_info = train_phase(torch, card)
    trained_f32, f32_info = train_phase(torch, card, amp=False)
    compiled_trained = compiled_train_phase(torch, card)
    checked_f32 = train_cpu_check(torch)
    recipe_bert = bert_recipe_phase(torch, card, train_info)
    recipe_lamb = bert_recipe_phase(torch, card, train_info, "lamb")
    checked_recipe = recipe_cpu_check(torch)
    gpt_trained, gpt_scope, gpt_cfg = gpt_train_phase(torch, card)
    gpt_cpu_check(torch)
    prompts, serial = gpt_generate_phase(torch, card, gpt_scope, gpt_cfg)
    gen_served = gen_serve_phase(torch, card, gpt_scope, gpt_cfg, prompts,
                                 serial)
    http_served, http_numbers = http_serve_phase(
        torch, card, bert_dir.name, served, gpt_scope, gpt_cfg, prompts,
        serial)
    fleet_dir = tempfile.TemporaryDirectory(prefix="ptt_fleet_")
    weights = write_gpt_weights(fleet_dir.name, gpt_scope, gpt_cfg)
    del gpt_scope
    _, resnet_info = resnet_train_phase(torch, card)
    resnet_cpu_check(torch)
    resnet_recipe_phase(torch, card, resnet_info)
    lenet_train_phase(torch, card)
    nmt_trained = nmt_train_phase(torch, card)
    deeplab = deeplab_train_phase(torch, card)
    profiler_phase(torch, card, *deeplab)
    del deeplab
    deeplab_cpu_check(torch)
    guard_train_phase(torch, card)
    dygraph_model, dygraph_trained = dygraph_bert_phase(
        torch, card, f32_info["peak_gb"])
    dygraph_traced = dygraph_trace_phase(torch, card, dygraph_model)
    del dygraph_model
    dygraph_checked = dygraph_cpu_check(torch)
    dygraph_resnet_phase(torch, card)
    dygraph_layers_phase(torch, card)
    loader_trained, loader = loader_bert_phase(torch, card, train_info)
    loader_starved_phase(torch, card, loader)
    del loader
    reader_resnet_phase(torch, card, resnet_info)
    mnist_book_phase(torch, card)
    data_layers_phase(torch, card)
    se_resnext_train_phase(torch, card)
    se_resnext_cpu_check(torch)
    large_trained, _ = bert_large_train_phase(torch, card,
                                              records["bert_large"])
    book_models_phase(torch, card)
    dense_layers_phase(torch, card)
    s2s_scope = seq2seq_train_phase(torch, card)
    seq2seq_cpu_check(torch)
    seq2seq_beam_phase(torch, card, s2s_scope)
    del s2s_scope
    sentiment_lod_phase(torch, card)
    control_flow_phase(torch, card)
    merged = grad_merge_phase(torch, card)
    pp_bf16, pp_f32 = pp_phases(torch, card)
    srl_train_phase(torch, card)
    crf_ctc_ops_phase(torch, card)
    dp_bf16, dp_f32 = dp_phases(torch, card)
    mp_bf16 = mp_phases(torch, card)
    # the fleet last: run right after [http_serve], it left the later
    # phases' torch.profiler traces of a flash step one flash forward
    # record short (the launch counters still read every launch), which
    # fails their profile gates (PERF.md, open questions)
    routed = router_serve_phase(torch, card, bert_dir.name, served,
                                http_numbers)
    kv_wire_phase(torch, card)
    fleet = start_fleet(fleet_dir.name, bert_dir.name, weights, gpt_cfg)
    try:
        router_hop_phase(torch, card, served, fleet)
        disagg_gen_phase(torch, card, prompts, serial, fleet, gen_served)
    finally:
        for rep in fleet.values():
            rep.kill()
        fleet_dir.cleanup()
        bert_dir.cleanup()

    # launches on the main paths, per dtype: the bf16 kernels' over the
    # BERT (build_train, both recipes and the DataLoader-fed run), GPT,
    # NMT and BERT-large bf16 training runs, the data-, model- and
    # pipeline-parallel ranks' steps and [pp_replicas]; the float32
    # kernels' over the float32 training run, the
    # float32 check step, the recipe check's card steps, the dygraph
    # BERT's timed steps and its check's card steps, the gradient-merge
    # micro-steps, [section_pipeline]'s microbatches, and the float32
    # forward's over the serving runs (direct, [serve_gates], over HTTP
    # and through [router_serve]'s router) and the traced dygraph
    # encoder's call too
    def entry(name, rec, launches, dtype=None, **shapes):
        """One kernel's record; a dtype instance of its own is named
        <name>_<dtype> and carries its dtype; each of `shapes` (the GPT
        path's record as causal, NMT's as nmt and nmt_causal,
        BERT-large's as bert_large) adds its shape's numbers under
        <key>_* keys."""
        source, line = KERNEL_SOURCES[name]
        own = {"dtype": dtype} if dtype else {}
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "shape")
        return {
            "name": f"{name}_{dtype}" if dtype else name, "route": "cuda",
            "source": f"paddle_tpu_torch/csrc/{source}",
            "replaces": f"paddle_tpu/ops/pallas/flash_attention.py:{line}",
            "launches": launches, **own, **{k: rec[k] for k in keys},
            **{f"{tag}_{k}": other[k] for tag, other in shapes.items()
               for k in keys}}

    out = [entry(name, records["bfloat16"][name],
                 trained[name] + gpt_trained[name] + nmt_trained[name] +
                 recipe_bert[name] + recipe_lamb[name] +
                 loader_trained[name] + large_trained[name] +
                 compiled_trained[name] + dp_bf16[name] +
                 mp_bf16[name] + pp_bf16[name],
                 causal=records["bfloat16_causal"][name],
                 nmt=records["nmt"][name],
                 nmt_causal=records["nmt_causal"][name],
                 bert_large=records["bert_large"][name])
           for name in KERNEL_SOURCES]
    out += [entry(name, records["float32"][name],
                  served[0].get(name, 0) + trained_f32[name] +
                  checked_f32[name] + checked_recipe[name] +
                  dygraph_trained[name] + dygraph_checked[name] +
                  dygraph_traced[name] + merged[name] + dp_f32[name] +
                  pp_f32[name] + (http_served + gated + routed
                   if name == "flash_attention_fwd" else 0),
                  "float32")
            for name in KERNEL_SOURCES]
    phase("done", seconds=f"{time.perf_counter() - t_start:.1f}",
          executor_gate_s=f"{gate_time[0]:.1f}",
          executor_gate_calls=gate_time[1])
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
