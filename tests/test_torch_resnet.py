"""ResNet-50 training on the CPU against the JAX package.

- The port's ResNet-50 training programs at bench.py's 3x224x224 (class
  dim 1000, Momentum, float32 and bf16 AMP) and their startups serialize
  byte-identically to the JAX package's.
- Then at depth 50, 3x64x64, batch 4, class dim 10, bench.py's Momentum
  (lr 0.1, momentum 0.9), from the JAX package's startup scope carried
  by convert.scope_from_numpy (under AMP with the residual branches'
  last batch_norm scales cut, below): 3 steps, each started in both
  packages from the JAX package's state after the step before
  (parameters, velocities, running statistics). The losses, the step-1
  gradients of every parameter, every parameter's update, and the
  running mean and variance of every batch_norm after each step must
  match; then a clone(for_test=True) forward, which reads the running
  statistics, must give the JAX package's logits.

Why each step starts from the JAX package's state, at bench.py's lr:
the network at this size amplifies rounding. Measured on the JAX package
alone, a change of 1e-6 in the image moves its own float32 step-1
gradients by 0.9-3.2% (Frobenius, per parameter): a batch_norm output
near 0 changes sign, and relu passes or stops its gradient. So two
packages that sum in other orders part after one step, whatever the lr
(run freely, the float32 losses at lr 1e-5 part by 4% at step 3; at lr
0.1 both rise, 3.39 -> 13.3 -> 35.4, as the reference's recipe does).
Starting each step from one state compares each step's work, and keeps
bench.py's lr, whose large updates show a wrong update rule at once.

Bars (measured on the CPU; each a few times the measured gap):
- float32: loss rtol 1e-4 (measured <= 1.7e-5); step-1 gradients: each
  parameter's Frobenius gap within 0.1 of its norm (measured <= 0.064,
  for the reason above; a wrong gradient rule reads O(1)); each
  parameter's update within 0.1 of the update (<= 0.064); running
  statistics within 3e-4 of max|stat| (measured <= 5.7e-5, median
  4.1e-7); test-mode logits within 1e-4 of max|logit| (measured
  4.2e-7).
- bf16 AMP (readings from tools/torch_rounding_sensitivity.py resnet):
  at the startup state the reference's own bf16 step is chaotic. A
  change of 1e-3 in the image (it flips a quarter of the
  image's bf16 roundings) moves the JAX package's step-1 gradients by
  0.05-1.69 of their norm (Frobenius, per parameter; median 1.28, the
  head fc's weight 0.24), above the 1.0 that an all-zero gradient reads,
  so no bar could tell a gradient from noise there. The AMP case
  therefore starts from the startup state with the scale of every
  batch_norm that ends a residual branch multiplied by 0.1
  (AMP_BRANCH_SCALE; a small or zero init of these scales is a common
  ResNet recipe), so each block starts near the identity. There the same
  change moves the JAX package's gradients by at most 0.30 (median
  0.20), and its AMP gradients part from its float32 ones by at most
  0.29. Bars: loss within 0.1 (measured <= 0.065), step-1 gradients
  each within 0.5 of its norm (measured <= 0.35, median 0.22; a zeroed
  gradient reads 1.0, a negated one 2.0), updates within 0.5 of the
  update (<= 0.35), running statistics within 0.03 of max|stat|
  (<= 0.011); and what bf16 cannot blur: the programs are identical,
  the convolutions run in bfloat16 and batch norm in float32
  (test_amp_runs_convolutions_in_bf16), every value is finite, and the
  accuracies are equal. tests/test_torch_vision_ops.py holds the bf16
  convolution's data and filter gradients against the JAX package's
  on their own.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.models import resnet as rj
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.models import resnet as rt

B, HW, CLASSES, STEPS, LR = 4, 64, 10, 3, 0.1
AMP_BRANCH_SCALE = 0.1  # see the docstring
BARS = {False: {"loss": 1e-4, "grad": 0.1, "update": 0.1, "stat": 3e-4,
                "logits": 1e-4},
        True: {"loss": 0.1, "grad": 0.5, "update": 0.5, "stat": 0.03}}


def _build(f, mod, amp, img_shape=(3, HW, HW), class_dim=CLASSES):
    main, startup = f.Program(), f.Program()
    startup.random_seed = 11
    with f.program_guard(main, startup), f.unique_name.guard():
        loss, acc, _ = mod.build_train(img_shape=img_shape,
                                       class_dim=class_dim, lr=LR, amp=amp)
    return main, startup, loss, acc


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_training_programs_identical(amp):
    """bench.py's ResNet-50 step: 53 conv2d and batch_norm ops, 161
    momentum updates; under AMP every conv output is cast back to
    float32 before its batch norm (157 casts)."""
    mj, sj, _, _ = _build(fj, rj, amp, (3, 224, 224), 1000)
    mt, st, _, _ = _build(ft, rt, amp, (3, 224, 224), 1000)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    assert mt.fingerprint() == mj.fingerprint()
    types = [op.type for op in mt.global_block().ops]
    counts = {t: types.count(t) for t in ("conv2d", "batch_norm", "relu",
                                          "pool2d", "momentum", "cast",
                                          "top_k", "accuracy")}
    assert counts == {"conv2d": 53, "batch_norm": 53, "relu": 49,
                      "pool2d": 2, "momentum": 161,
                      "cast": 157 if amp else 0, "top_k": 1,
                      "accuracy": 1}
    assert len(types) == (848 if amp else 535)


def _branch_end_scales(main):
    """The scale of each batch_norm that ends a residual branch (its
    output is the Y of the block's elementwise_add)."""
    ops = main.global_block().ops
    add_y = {op.input("Y")[0] for op in ops if op.type == "elementwise_add"}
    return [op.input("Scale")[0] for op in ops if op.type == "batch_norm"
            and op.output("Y")[0] in add_y]


def _rel(a, b):
    """max|a - b| / max|b|."""
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _fro(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_training_matches_jax(amp):
    bars = BARS[amp]
    mj, sj, loss_j, acc_j = _build(fj, rj, amp)
    mt, _, loss_t, acc_t = _build(ft, rt, amp)
    scope_j = fj.Scope()
    with fj.scope_guard(scope_j):
        exe_j = fj.Executor(fj.CPUPlace())
        exe_j.run(sj)
    if amp:
        scales = _branch_end_scales(mt)
        assert len(scales) == 16
        for n in scales:
            scope_j.set(n, np.asarray(scope_j.get(n)) * AMP_BRANCH_SCALE)
    exe_t = ft.Executor(ft.CPUPlace())
    pnames = sorted(p.name for p in mt.all_parameters())
    stats = [op.input(s)[0] for op in mt.global_block().ops
             if op.type == "batch_norm" for s in ("Mean", "Variance")]
    assert len(stats) == 106
    fetch = [loss_t.name, acc_t.name] + [f"{p}@GRAD" for p in pnames]
    rng = np.random.RandomState(0)
    feed = {"image": rng.randn(B, 3, HW, HW).astype(np.float32),
            "label": rng.randint(0, CLASSES, (B, 1)).astype(np.int64)}

    def jax_state():
        return {n: np.asarray(scope_j.get(n)) for n in scope_j.names()
                if scope_j.find_var(n) is not None}

    for step in range(STEPS):
        before = jax_state()
        scope_t = scope_from_numpy(before, ft.Scope(), ft.CPUPlace())
        with fj.scope_guard(scope_j):
            out_j = exe_j.run(mj, feed=feed, fetch_list=fetch)
        out_t = exe_t.run(mt, feed=feed, fetch_list=fetch, scope=scope_t)
        after = jax_state()
        lj, lt = float(np.asarray(out_j[0])), float(out_t[0])
        assert np.isfinite(lt) and abs(lt - lj) <= bars["loss"] * abs(lj), \
            (step, lt, lj)
        assert float(out_t[1][0]) == float(np.asarray(out_j[1])[0])
        if step == 0:
            for name, a, b in zip(fetch[2:], out_j[2:], out_t[2:]):
                a = np.asarray(a, np.float32)
                assert np.isfinite(b).all() and \
                    _fro(b, a) <= bars["grad"], (name, _fro(b, a))
        for n in pnames:
            got = scope_t.get_numpy(n)
            assert np.isfinite(got).all()
            # the port's update against the JAX package's, over its size
            gap = float(np.linalg.norm(got - after[n]) /
                        np.linalg.norm(after[n] - before[n]))
            assert gap <= bars["update"], (step, n, gap)
        for n in stats:
            assert not np.array_equal(after[n], before[n]), n
            assert _rel(scope_t.get_numpy(n), after[n]) <= bars["stat"], \
                (step, n, _rel(scope_t.get_numpy(n), after[n]))
    if amp:
        return
    # the test-mode forward reads the running statistics: from the JAX
    # package's state after the 3 steps, the logits of both packages
    head = [op.output("Out")[0] for op in mt.global_block().ops
            if op.type == "mul"]
    test_j, test_t = mj.clone(for_test=True), mt.clone(for_test=True)
    assert test_t.to_json() == test_j.to_json()
    scope_t = scope_from_numpy(jax_state(), ft.Scope(), ft.CPUPlace())
    with fj.scope_guard(scope_j):
        logits_j = np.asarray(exe_j.run(test_j, feed=feed,
                                        fetch_list=head)[0])
    logits_t = exe_t.run(test_t, feed=feed, fetch_list=head,
                         scope=scope_t)[0]
    assert np.isfinite(logits_t).all()
    assert _rel(logits_t, logits_j) <= bars["logits"], \
        _rel(logits_t, logits_j)
    # a test run leaves the running statistics as they were
    for n in stats:
        np.testing.assert_array_equal(scope_t.get_numpy(n),
                                      scope_j.get(n).__array__())


def test_amp_runs_convolutions_in_bf16():
    """Under AMP the convolutions and the head take and return bfloat16,
    and batch norm reads float32: a cast that did nothing would leave
    the loss within the AMP bars above."""
    main, startup, loss, _ = _build(ft, rt, True)
    ops = main.global_block().ops
    conv_out = [op.output("Output")[0] for op in ops if op.type == "conv2d"]
    bn_in = [op.input("X")[0] for op in ops if op.type == "batch_norm"]
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"image": rng.randn(2, 3, HW, HW).astype(np.float32),
            "label": rng.randint(0, CLASSES, (2, 1)).astype(np.int64)}
    out = exe.run(main, feed=feed, fetch_list=[loss] + conv_out + bn_in,
                  scope=scope, return_numpy=False)
    n = len(conv_out)
    assert out[0].dtype == torch.float32 and torch.isfinite(out[0])
    assert {t.dtype for t in out[1:1 + n]} == {torch.bfloat16}
    assert {t.dtype for t in out[1 + n:]} == {torch.float32}


def test_flops_per_image_matches_jax():
    """bench.py's count: 8.178 GFLOP a forward image at 224."""
    assert rt.flops_per_image() == rj.flops_per_image() == 8178368512
    for depth in (18, 101):
        assert rt.flops_per_image(depth, 64, 10) == \
            rj.flops_per_image(depth, 64, 10)
