"""DeepLabv3+ training on the CPU against the JAX package.

- The port's DeepLabv3+ training programs at bench.py's step (513x513,
  batch 8, 19 classes, Momentum 1e-3 / 0.9) with and without AMP, and at
  33x33 batch 2, serialize byte-identically to the JAX package's, with
  their startups: 989 ops under AMP, 629 in float32, 188 parameters of
  40,351,667 values.
- One Momentum step in both packages from the same state, the JAX
  package's startup values carried by convert.scope_from_numpy, with
  the scale of each of the 16 batch_norms that end a residual branch
  multiplied by 0.1 (BRANCH_SCALE, as tests/test_torch_resnet.py's AMP
  case): float32 at 33x33 batch 2 and at bench.py's CPU-validate size,
  65x65 batch 1 (where the image-pooling branch's batch_norm sees one
  value a channel); AMP at 33x33 batch 4 and at 65x65 batch 1. The loss,
  every parameter's step-1 gradient, and every batch_norm's running mean
  and variance after the step must match.

Why AMP at batch 4 and not 2 at 33x33: the image-pooling branch's
batch_norm normalises [b, 256, 1, 1] over b values a channel. With two,
its output is +-1 wherever the two pooled values differ by much more
than sqrt(eps), and its gradient is large only where they nearly tie,
so bf16 rounding of the pooled values moves the whole network's
gradients. Measured with tools/torch_rounding_sensitivity.py deeplab
(--branch-scale 0.1): a 1e-3 change of the image moves the JAX
package's own AMP step-1 gradients by up to 1.27 of their norm at 33x33
batch 2 (median 1.0, above the 1.0 an all-zero gradient reads: no bar
could tell a gradient from noise), but by at most 0.37 at batch 4 and
0.39 at 65x65 batch 1. Float32 is not chaotic at batch 2.

Bars (each above the measured gap, below what a wrong rule reads):
- float32: loss rtol 1e-4 (measured 1.5e-7 or less); gradients each
  within 0.05 of the norm (Frobenius; measured at most 1.3e-2 at 33x33
  batch 2, median 9.3e-3, and 6.7e-6 at 65x65 batch 1: float32 sums in
  other orders, as ResNet's); running statistics within 3e-4 of
  max|stat|, ResNet's bar.
- AMP: loss rtol 2e-3 (measured 5.2e-4 at 33x33 batch 4, 5.8e-5 at
  65x65 batch 1; the JAX package's own loss moves by 3.8e-4 and 2.8e-5
  under the 1e-3 change, and its AMP loss sits 5.2e-4 from its float32
  one); gradients each within 0.6 (measured up to 0.36 and 0.46, median
  0.28 at 33x33; the JAX package's own readings up to 0.37 and 0.39; a
  zeroed gradient reads 1.0, a negated one 2.0); running statistics
  within 0.03 of max|stat|, ResNet's AMP bar.

The JAX programs cost 15-20 s each to compile on this CPU, so the JAX
startup runs once per module, and the JAX package's static verifier,
memory gate and program-IR passes (analysis, and rewrites that keep
what the program computes) are off for the module.
"""
import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.models import deeplab as dj
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.models import deeplab as dt

BRANCH_SCALE = 0.1
BARS = {False: {"loss": 1e-4, "grad": 0.05, "stat": 3e-4},
        True: {"loss": 2e-3, "grad": 0.6, "stat": 0.03}}
JAX_ANALYSIS_OFF = {"FLAGS_program_verify": "off", "FLAGS_memory_gate": "off",
                    "FLAGS_graph_opt_level": 0}
# (image side, batch, amp)
STEPS = [(33, 2, False), (65, 1, False), (33, 4, True), (65, 1, True)]


def _build(f, mod, hw, batch, amp):
    main, startup = f.Program(), f.Program()
    startup.random_seed = 11
    with f.program_guard(main, startup), f.unique_name.guard():
        loss, _ = mod.build_train(hw, batch, amp=amp)
    return main, startup, loss


@pytest.mark.parametrize("hw,batch,amp", [(513, 8, True), (513, 8, False),
                                          (33, 2, True)])
def test_training_programs_identical(hw, batch, amp):
    mj, sj, _ = _build(fj, dj, hw, batch, amp)
    mt, st, _ = _build(ft, dt, hw, batch, amp)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    assert mt.fingerprint() == mj.fingerprint()
    types = [op.type for op in mt.global_block().ops]
    counts = {t: types.count(t) for t in ("conv2d", "batch_norm",
                                          "bilinear_interp", "concat",
                                          "momentum", "cast")}
    assert counts == {"conv2d": 63, "batch_norm": 62, "bilinear_interp": 3,
                      "concat": 2, "momentum": 188,
                      "cast": 180 if amp else 0}
    assert len(types) == (989 if amp else 629)
    params = mt.all_parameters()
    assert len(params) == 188
    assert sum(int(np.prod(p.shape)) for p in params) == 40351667


def test_flops_per_image_matches_jax():
    """bench.py's count: 136.8 GFLOP a forward image at 513."""
    assert dt.flops_per_image() == dj.flops_per_image() == 136819245056.0
    assert dt.flops_per_image(65) == dj.flops_per_image(65)


@pytest.fixture(scope="module", autouse=True)
def _no_jax_analysis():
    """The JAX package's static verifier and memory gate off, and its
    program-IR passes at level 0, for this module: they analyse the
    program or rewrite it without changing what it computes (so the JAX
    side runs each op's lowering as built), and take about half of each
    DeepLab compile here."""
    keep = fj.get_flags(list(JAX_ANALYSIS_OFF))
    fj.set_flags(JAX_ANALYSIS_OFF)
    yield
    fj.set_flags(keep)


@pytest.fixture(scope="module")
def init_state():
    """The JAX package's startup values (one startup serves every size:
    the programs share it), with the residual branches' last batch_norm
    scales cut."""
    mj, sj, _ = _build(fj, dj, 33, 2, False)
    scope = fj.Scope()
    with fj.scope_guard(scope):
        fj.Executor(fj.CPUPlace()).run(sj)
    init = {n: np.asarray(scope.get(n)) for n in scope.names()
            if scope.find_var(n) is not None}
    ops = mj.global_block().ops
    add_y = {op.input("Y")[0] for op in ops if op.type == "elementwise_add"}
    scales = [op.input("Scale")[0] for op in ops if op.type == "batch_norm"
              and op.output("Y")[0] in add_y]
    assert len(scales) == 16
    for n in scales:
        init[n] = (init[n] * BRANCH_SCALE).astype(np.float32)
    return init


def _fro(a, b):
    """||a - b|| / ||b||; a gradient the JAX package gives as exactly 0
    (at batch 1 the image-pooling branch's batch_norm outputs its Bias,
    so nothing before it gets a gradient) must be 0 in the port too."""
    nb = np.linalg.norm(b)
    if nb == 0:
        return 0.0 if not np.any(a) else float("inf")
    return float(np.linalg.norm(a - b) / nb)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.mark.parametrize("hw,batch,amp", STEPS,
                         ids=[f"{hw}x{hw}_b{b}_{'amp' if a else 'fp32'}"
                              for hw, b, a in STEPS])
def test_step_matches_jax(init_state, hw, batch, amp):
    bars = BARS[amp]
    mj, _, loss_j = _build(fj, dj, hw, batch, amp)
    mt, _, loss_t = _build(ft, dt, hw, batch, amp)
    pnames = sorted(p.name for p in mt.all_parameters())
    stats = [op.input(s)[0] for op in mt.global_block().ops
             if op.type == "batch_norm" for s in ("Mean", "Variance")]
    assert len(stats) == 124
    fetch = [loss_t.name] + [f"{p}@GRAD" for p in pnames]
    rng = np.random.RandomState(0)
    feed = {"image": rng.randn(batch, 3, hw, hw).astype(np.float32),
            "label": rng.randint(0, dj.N_CLASSES, (batch, hw, hw))
            .astype(np.int64)}

    scope_j = fj.Scope()
    for n, v in init_state.items():
        scope_j.set(n, v)
    with fj.scope_guard(scope_j):
        out_j = fj.Executor(fj.CPUPlace()).run(mj, feed=feed,
                                                fetch_list=fetch)
    scope_t = scope_from_numpy(init_state, ft.Scope(), ft.CPUPlace())
    out_t = ft.Executor(ft.CPUPlace()).run(mt, feed=feed, fetch_list=fetch,
                                           scope=scope_t)

    lj, lt = float(np.asarray(out_j[0])), float(out_t[0])
    assert np.isfinite(lt) and abs(lt - lj) <= bars["loss"] * abs(lj), \
        (lt, lj)
    gaps = {}
    for name, a, b in zip(fetch[1:], out_j[1:], out_t[1:]):
        a = np.asarray(a, np.float32)
        assert np.isfinite(b).all(), name
        gaps[name] = _fro(b, a)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= bars["grad"], (worst, gaps[worst])
    for n in stats:
        got, want = scope_t.get_numpy(n), np.asarray(scope_j.get(n))
        assert np.isfinite(got).all() and \
            not np.array_equal(got, init_state[n]), n
        assert _rel(got, want) <= bars["stat"], (n, _rel(got, want))
