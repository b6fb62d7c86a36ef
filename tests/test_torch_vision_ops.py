"""The ops the vision and NMT training slice adds, each against the JAX
package's lowering on the same seeded numpy inputs: relu, tanh, conv2d,
pool2d, batch_norm, top_k, accuracy, cross_entropy, label_smooth, and one
update each of sgd, momentum (with and without Nesterov) and adam; and
the ops DeepLabv3+ adds: bilinear_interp and nearest_interp (every
source-coordinate convention, `scale`, bfloat16), concat (mixed input
dtypes), and batch_norm over one value a channel (torch's own batch norm
raises there).

Where an op is differentiated in training, the gradients of its
differentiable inputs are compared too: jax.vjp of the JAX lowering
against torch.autograd through the port's, for the same seeded
cotangents.

Tolerances, per case: float32 outputs and gradients within atol 1e-5
relative to max(1, max|reference|) (the frameworks sum in other orders;
measured at most 3.9e-7); batch_norm's statistics within rtol 1e-5
(measured at most 8.8e-7); integer and index outputs exactly; bfloat16
conv2d's output and its input and filter gradients within 2e-2 of
max(1, max|reference|) (each side rounds its float32 sums to bfloat16
once; measured equal here); bfloat16 resizes and one-value batch_norm
within the same 2e-2 (bfloat16 products rounded at other points: the
resizes' backward adds up to five contributions a source pixel an
axis).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  — registers the JAX lowerings
import paddle_tpu_torch  # noqa: F401  — registers the port's lowerings
from paddle_tpu.core import lowering as jlow
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu_torch.core import lowering as tlow
from paddle_tpu_torch.core.registry import REGISTRY as TREG

F32_TOL = 1e-5
STAT_RTOL = 1e-5
BF16_TOL = 2e-2


def _op(attrs):
    return types.SimpleNamespace(attrs=dict(attrs), id=7, block=None,
                                 type="op", outputs={})


def _jax_outs(op_type, ins, attrs, is_test):
    ctx = jlow._OpCtx(jlow.LowerCtx(jax.random.PRNGKey(0), is_test=is_test),
                      _op(attrs))
    return JREG.get(op_type).lower(ctx, ins, attrs)


def _as_np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def compare(op_type, ins, attrs, slots, grad_slots=(), diff_out="",
            is_test=False, tol=F32_TOL, bf16=()):
    """Run both lowerings on `ins` (numpy, per slot; the slots in `bf16`
    handed over as bfloat16); compare the output `slots` within `tol` of
    max(1, max|JAX|), with equal shapes and dtype kinds. With
    `grad_slots`, also compare the gradients of those inputs for a seeded
    cotangent of output slot `diff_out`. Returns the port's outputs."""
    def jin(s, a):
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16) if s in bf16 else a

    def tin(s, a):
        t = torch.from_numpy(np.array(a))
        return t.to(torch.bfloat16) if s in bf16 else t

    jins = {s: [jin(s, a) for a in vs] for s, vs in ins.items()}
    tins = {s: [tin(s, a) for a in vs] for s, vs in ins.items()}
    for s in grad_slots:
        tins[s] = [t.requires_grad_() for t in tins[s]]
    oj = _jax_outs(op_type, jins, attrs, is_test)
    ctx = tlow._OpCtx(tlow.LowerCtx("cpu", is_test=is_test), _op(attrs))
    with torch.enable_grad():
        ot = TREG.get(op_type).lower(ctx, tins, attrs)
    for s in slots:
        for a, b in zip(oj[s], ot[s]):
            a, b = _as_np(a), _as_np(b.detach().float()
                                     if b.dtype == torch.bfloat16
                                     else b.detach())
            assert a.shape == b.shape, (s, a.shape, b.shape)
            assert a.dtype.kind == b.dtype.kind, (s, a.dtype, b.dtype)
            scale = max(1.0, float(np.abs(a).max())) if a.size else 1.0
            np.testing.assert_allclose(b.astype(np.float64),
                                       a.astype(np.float64),
                                       atol=tol * scale, rtol=0, err_msg=s)
    if grad_slots:
        cot = np.random.RandomState(9).randn(
            *np.shape(oj[diff_out][0])).astype(np.float32)

        def f(*xs):
            j = dict(jins)
            it = iter(xs)
            for s in grad_slots:
                j[s] = [next(it) for _ in ins[s]]
            return _jax_outs(op_type, j, attrs, is_test)[diff_out][0]

        leaves = [a for s in grad_slots for a in jins[s]]
        y, vjp = jax.vjp(f, *leaves)
        gj = vjp(jnp.asarray(cot).astype(y.dtype))
        tleaves = [t for s in grad_slots for t in tins[s]]
        gt = torch.autograd.grad(ot[diff_out][0], tleaves,
                                 torch.from_numpy(cot).to(
                                     ot[diff_out][0].dtype))
        for i, (a, b) in enumerate(zip(gj, gt)):
            a, b = _as_np(a), b.float().numpy()
            scale = max(1.0, float(np.abs(a).max()))
            np.testing.assert_allclose(b, a, atol=tol * scale, rtol=0,
                                       err_msg=f"grad {i}")
    return ot


def _randn(rng, *shape, scale=1.0, shift=0.0):
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


@pytest.mark.parametrize("op_type", ["relu", "tanh"])
def test_activation(op_type):
    x = _randn(np.random.RandomState(1), 4, 6, 5)
    x[0, 0, :2] = 0.0  # relu's gradient at 0 is 0 in both
    compare(op_type, {"X": [x]}, {}, ["Out"], ["X"], "Out")


# (input shape, filter shape, attrs): 2- and 4-entry paddings (uneven
# pads go through F.pad), stride, dilation, groups, AnyLayout
CONV_CASES = {
    "pad2": ((2, 3, 9, 9), (4, 3, 3, 3), {"paddings": [1, 1]}),
    "pad4_even": ((2, 3, 9, 9), (4, 3, 3, 3),
                  {"paddings": [1, 1, 2, 2], "strides": [2, 2]}),
    "pad4_uneven": ((2, 3, 9, 8), (4, 3, 3, 2),
                    {"paddings": [0, 2, 1, 3], "strides": [2, 1]}),
    "stride7x7": ((2, 3, 16, 16), (8, 3, 7, 7),
                  {"paddings": [3, 3], "strides": [2, 2]}),
    "dilation": ((2, 3, 11, 11), (4, 3, 3, 3),
                 {"paddings": [2, 2], "dilations": [2, 2]}),
    "groups": ((2, 4, 8, 8), (6, 2, 3, 3),
               {"paddings": [1, 1], "groups": 2}),
    "anylayout": ((2, 3, 6, 6), (4, 3, 1, 1),
                  {"data_format": "AnyLayout"}),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d(case):
    xs, ws, attrs = CONV_CASES[case]
    rng = np.random.RandomState(2)
    ins = {"Input": [_randn(rng, *xs)], "Filter": [_randn(rng, *ws)]}
    compare("conv2d", ins, attrs, ["Output"], ["Input", "Filter"], "Output")


def test_conv2d_nhwc_is_not_ported():
    """The layers write no data_format; an NHWC conv2d raises instead of
    reading the tensors in the wrong layout."""
    ctx = tlow._OpCtx(tlow.LowerCtx("cpu"), _op({}))
    ins = {"Input": [torch.zeros(1, 4, 4, 3)],
           "Filter": [torch.zeros(3, 3, 3, 2)]}
    with pytest.raises(NotImplementedError, match="NHWC"):
        TREG.get("conv2d").lower(ctx, ins, {"data_format": "NHWC"})


def test_conv2d_bfloat16():
    """Under AMP the conv takes bfloat16 operands and returns bfloat16,
    and its backward (the data and filter gradients) runs in bfloat16
    too: both against jax.vjp of the JAX lowering."""
    rng = np.random.RandomState(3)
    ins = {"Input": [_randn(rng, 2, 8, 10, 10)],
           "Filter": [_randn(rng, 16, 8, 3, 3, scale=0.2)]}
    ot = compare("conv2d", ins, {"paddings": [1, 1], "strides": [2, 2]},
                 ["Output"], grad_slots=("Input", "Filter"),
                 diff_out="Output", tol=BF16_TOL, bf16=("Input", "Filter"))
    assert ot["Output"][0].dtype == torch.bfloat16


POOL_CASES = {
    "max_k3s2p1": {"pooling_type": "max", "ksize": [3, 3],
                   "strides": [2, 2], "paddings": [1, 1]},
    "avg_exclusive_p1": {"pooling_type": "avg", "ksize": [3, 3],
                         "strides": [2, 2], "paddings": [1, 1],
                         "exclusive": True},
    "avg_inclusive_p1": {"pooling_type": "avg", "ksize": [3, 3],
                         "strides": [2, 2], "paddings": [1, 1],
                         "exclusive": False},
    "avg_k2_nopad": {"pooling_type": "avg", "ksize": [2, 2],
                     "strides": [2, 2], "paddings": [0, 0]},
    # strides absent: they default to the window
    "max_default_strides": {"pooling_type": "max", "ksize": [2, 3]},
    # ceil_mode is not read: a 7x7 map under a 2x2 window with stride 2
    # gives 3x3 (floored), not 4x4
    "max_ceil_mode_ignored": {"pooling_type": "max", "ksize": [2, 2],
                              "strides": [2, 2], "ceil_mode": True},
    "avg_ceil_mode_ignored": {"pooling_type": "avg", "ksize": [2, 2],
                              "strides": [2, 2], "ceil_mode": True},
    "global_avg": {"pooling_type": "avg", "ksize": [1, 1],
                   "global_pooling": True},
    "global_max": {"pooling_type": "max", "ksize": [3, 3],
                   "global_pooling": True},
    # the reference's `global or adaptive and ksize == [1, 1]`
    "adaptive_1x1": {"pooling_type": "avg", "ksize": [1, 1],
                     "adaptive": True},
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d(case):
    x = _randn(np.random.RandomState(4), 2, 3, 7, 7)
    ot = compare("pool2d", {"X": [x]}, POOL_CASES[case], ["Out"], ["X"],
                 "Out")
    if "ceil_mode" in case:
        assert ot["Out"][0].shape == (2, 3, 3, 3)


BN_ATTRS = {"momentum": 0.9, "epsilon": 1e-5, "is_test": False,
            "data_layout": "NCHW", "use_global_stats": False}
BN_STATS = ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance")
# (X shape, attrs, test run): training over NCHW and a [N, C] input, a
# momentum other than 0.9, NHWC; is_test, use_global_stats and a test
# run (clone(for_test=True)) take the running statistics
BN_CASES = {
    "train_nchw": ((4, 5, 3, 3), {}, False),
    "train_2d": ((6, 5), {}, False),
    "train_momentum_0.5": ((4, 5, 2, 2), {"momentum": 0.5,
                                          "epsilon": 1e-3}, False),
    "train_nhwc": ((4, 3, 3, 5), {"data_layout": "NHWC"}, False),
    "is_test": ((4, 5, 3, 3), {"is_test": True}, False),
    "use_global_stats": ((4, 5, 3, 3), {"use_global_stats": True}, False),
    "test_run": ((4, 5, 3, 3), {}, True),
    # one value a channel: DeepLab's image-pooling branch at batch 1
    "train_one_value": ((1, 5, 1, 1), {}, False),
    "train_one_value_2d": ((1, 5), {}, False),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm(case):
    """Y and its gradients (X, Scale, Bias) within F32_TOL; MeanOut,
    VarianceOut (the biased batch variance into running * momentum +
    batch * (1 - momentum)), SavedMean and SavedVariance (rsqrt(var +
    eps)) within STAT_RTOL."""
    shape, extra, is_test = BN_CASES[case]
    attrs = {**BN_ATTRS, **extra}
    rng = np.random.RandomState(5)
    c = shape[-1] if attrs["data_layout"] == "NHWC" else shape[1]
    ins = {"X": [_randn(rng, *shape, scale=2.0, shift=0.7)],
           "Scale": [_randn(rng, c, scale=0.3, shift=1.0)],
           "Bias": [_randn(rng, c)],
           "Mean": [_randn(rng, c, scale=0.1)],
           "Variance": [np.abs(_randn(rng, c)) + 0.5]}
    ot = compare("batch_norm", ins, attrs, ["Y"], ["X", "Scale", "Bias"],
                 "Y", is_test=is_test)
    oj = _jax_outs("batch_norm", {s: [jnp.asarray(a) for a in vs]
                                  for s, vs in ins.items()}, attrs, is_test)
    for s in BN_STATS:
        np.testing.assert_allclose(ot[s][0].detach().numpy(),
                                   np.asarray(oj[s][0]), rtol=STAT_RTOL,
                                   err_msg=s)
    if extra.get("is_test") or extra.get("use_global_stats") or is_test:
        np.testing.assert_array_equal(ot["MeanOut"][0].numpy(),
                                      ins["Mean"][0])
    else:
        # the running statistics moved, with the biased variance
        x = ins["X"][0] if attrs["data_layout"] == "NCHW" else \
            np.moveaxis(ins["X"][0], -1, 1)
        red = (0,) + tuple(range(2, x.ndim))
        m = attrs["momentum"]
        want = ins["Variance"][0] * m + x.var(axis=red) * (1 - m)
        np.testing.assert_allclose(ot["VarianceOut"][0].detach().numpy(),
                                   want, rtol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
def test_top_k_keeps_the_lower_index_first_on_ties(k):
    x = np.array([[0.5, 2.0, 2.0, -1.0, 2.0, 0.5],
                  [1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                  [3.0, -2.0, 0.0, 3.0, 7.0, 0.0]], np.float32)
    ot = compare("top_k", {"X": [x]}, {"k": k}, ["Out", "Indices"],
                 ["X"], "Out")
    assert ot["Indices"][0].dtype == torch.int64
    if k == 3:
        assert ot["Indices"][0][:2].tolist() == [[1, 2, 4], [0, 1, 2]]


def test_top_k_random_rows():
    x = _randn(np.random.RandomState(6), 8, 1000)
    compare("top_k", {"X": [x]}, {"k": 5}, ["Out", "Indices"], ["X"], "Out")


@pytest.mark.parametrize("k", [1, 2])
def test_accuracy(k):
    rng = np.random.RandomState(7)
    idx = np.stack([rng.choice(10, k, replace=False) for _ in range(16)])
    label = rng.randint(0, 10, (16, 1)).astype(np.int64)
    label[:5, 0] = idx[:5, 0]  # some rows hit
    ins = {"Out": [_randn(rng, 16, k)], "Indices": [idx.astype(np.int64)],
           "Label": [label]}
    ot = compare("accuracy", ins, {}, ["Accuracy", "Correct", "Total"])
    assert [ot[s][0].dtype for s in ("Accuracy", "Correct", "Total")] == \
        [torch.float32, torch.int32, torch.int32]
    assert ot["Total"][0].tolist() == [16] and ot["Correct"][0][0] >= 5


@pytest.mark.parametrize("soft,ignore", [(False, -100), (False, 3),
                                         (True, -100)])
def test_cross_entropy(soft, ignore):
    """-log(p + 1e-8) of softmax probabilities; a label equal to
    ignore_index gives 0 (here a class id, so both sides read in range)."""
    rng = np.random.RandomState(8)
    p = torch.softmax(torch.from_numpy(_randn(rng, 12, 10)), -1).numpy()
    if soft:
        label = torch.softmax(torch.from_numpy(_randn(rng, 12, 10)),
                              -1).numpy()
    else:
        label = rng.randint(0, 10, (12, 1)).astype(np.int64)
        label[:4, 0] = 3
    ot = compare("cross_entropy", {"X": [p], "Label": [label]},
                 {"soft_label": soft, "ignore_index": ignore}, ["Y"], ["X"],
                 "Y")
    if ignore == 3:
        assert (ot["Y"][0][:4] == 0).all()


@pytest.mark.parametrize("prior", [False, True])
def test_label_smooth(prior):
    rng = np.random.RandomState(10)
    x = np.eye(7, dtype=np.float32)[rng.randint(0, 7, 9)]
    ins = {"X": [x]}
    if prior:
        ins["PriorDist"] = [np.full((1, 7), 1 / 7, np.float32)]
    compare("label_smooth", ins, {"epsilon": 0.1}, ["Out"], ["X"], "Out")


def _state(rng, shape):
    return {"Param": [_randn(rng, *shape)], "Grad": [_randn(rng, *shape)],
            "LearningRate": [np.array([0.05], np.float32)]}


OPTIMIZER_CASES = {
    "sgd": ({}, {}, ["ParamOut"]),
    "momentum": ({"Velocity": 1}, {"mu": 0.9, "use_nesterov": False},
                 ["ParamOut", "VelocityOut"]),
    "momentum_nesterov": ({"Velocity": 1}, {"mu": 0.8,
                                            "use_nesterov": True},
                          ["ParamOut", "VelocityOut"]),
    "adam": ({"Moment1": 1, "Moment2": 2, "Beta1Pow": 0, "Beta2Pow": 0},
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
             ["ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
              "Beta2PowOut"]),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_update(case):
    """One update within F32_TOL; the port writes it into the input
    tensors (ParamOut is Param)."""
    extra, attrs, slots = OPTIMIZER_CASES[case]
    rng = np.random.RandomState(11)
    ins = _state(rng, (5, 4))
    for s, kind in extra.items():
        ins[s] = [np.array([0.9 ** 3 if s == "Beta1Pow" else 0.999 ** 3],
                           np.float32) if kind == 0 else
                  np.abs(_randn(rng, 5, 4)) * kind]
    op_type = case.split("_")[0]
    tins = {s: [torch.from_numpy(np.array(a)) for a in vs]
            for s, vs in ins.items()}
    ctx = tlow._OpCtx(tlow.LowerCtx("cpu"), _op(attrs))
    ot = TREG.get(op_type).lower(ctx, tins, attrs)
    oj = _jax_outs(op_type, {s: [jnp.asarray(a) for a in vs]
                             for s, vs in ins.items()}, attrs, False)
    for s in slots:
        np.testing.assert_allclose(ot[s][0].numpy(), np.asarray(oj[s][0]),
                                   atol=F32_TOL, rtol=0, err_msg=s)
    assert ot["ParamOut"][0] is tins["Param"][0]
    assert not np.allclose(tins["Param"][0].numpy(), ins["Param"][0])


def test_every_new_op_is_registered_in_both():
    new = {"relu", "tanh", "conv2d", "pool2d", "batch_norm", "top_k",
           "accuracy", "cross_entropy", "label_smooth", "sgd", "momentum",
           "adam"}
    for t in new:
        assert TREG.has(t) and JREG.get(t) is not None, t
        jdef, tdef = JREG.get(t), TREG.get(t)
        assert set(tdef.nondiff_inputs) == set(jdef.nondiff_inputs), t
        assert set(tdef.nondiff_outputs) == set(jdef.nondiff_outputs), t
        assert tdef.inplace == jdef.inplace, t


def test_batch_norm_one_value_bfloat16():
    """[1, C, 1, 1] in bfloat16 (X, Scale and Bias), training: Y equals
    Bias, SavedVariance rsqrt(eps), and the gradients follow jax.vjp of
    the JAX lowering; the running statistics stay float32 and move
    toward the batch's own values."""
    rng = np.random.RandomState(6)
    ins = {"X": [_randn(rng, 1, 4, 1, 1, scale=2.0)],
           "Scale": [_randn(rng, 4, scale=0.3, shift=1.0)],
           "Bias": [_randn(rng, 4)],
           "Mean": [_randn(rng, 4, scale=0.1)],
           "Variance": [np.abs(_randn(rng, 4)) + 0.5]}
    ot = compare("batch_norm", ins, BN_ATTRS, ["Y"], ["X", "Scale", "Bias"],
                 "Y", tol=BF16_TOL, bf16=("X", "Scale", "Bias"))
    y = ot["Y"][0].detach()
    assert y.dtype == torch.bfloat16
    bias = torch.from_numpy(ins["Bias"][0]).to(torch.bfloat16)
    assert torch.equal(y.reshape(-1), bias)
    oj = _jax_outs("batch_norm", {
        s: [jnp.asarray(a).astype(jnp.bfloat16) if s in ("X", "Scale",
                                                         "Bias")
            else jnp.asarray(a) for a in vs] for s, vs in ins.items()},
        BN_ATTRS, False)
    for s in BN_STATS:
        # the running statistics mix float32 state with bfloat16 batch
        # values: BF16_TOL of max(1, max|JAX|), as the outputs
        a, b = _as_np(oj[s][0]), ot[s][0].detach().float().numpy()
        assert str(oj[s][0].dtype) == str(ot[s][0].dtype).split(".")[-1], s
        np.testing.assert_allclose(b, a, rtol=0, err_msg=s,
                                   atol=BF16_TOL * max(1.0, np.abs(a).max()))
    saved_v = ot["SavedVariance"][0].detach().float().numpy()
    np.testing.assert_allclose(saved_v, np.float32(1e-5) ** -0.5, rtol=1e-2)


# (X shape, attrs): every source-coordinate convention, DeepLab's odd
# sizes (9 -> 33 as 33 -> 129 and 129 -> 513, 3 -> 1 as a pooled map
# going the other way), shrinking, `scale` with no out_h, and the attrs'
# defaults (align_corners true, align_mode 1)
INTERP_CASES = {
    "align_corners": ((2, 3, 5, 7), {"out_h": 9, "out_w": 12,
                                     "align_corners": True}),
    "half_pixel": ((2, 3, 9, 9), {"out_h": 33, "out_w": 33,
                                  "align_corners": False, "align_mode": 0}),
    "half_pixel_from_1x1": ((2, 3, 1, 1), {"out_h": 5, "out_w": 5,
                                           "align_corners": False,
                                           "align_mode": 0}),
    "half_pixel_shrink": ((1, 2, 9, 7), {"out_h": 4, "out_w": 3,
                                         "align_corners": False,
                                         "align_mode": 0}),
    "mode_1": ((2, 3, 6, 5), {"out_h": 13, "out_w": 11,
                              "align_corners": False, "align_mode": 1}),
    "defaults": ((1, 2, 4, 4), {"out_h": 7, "out_w": 5}),
    "scale": ((1, 2, 5, 6), {"scale": 2.5, "align_corners": False,
                             "align_mode": 0}),
    "scale_ignored_with_out_h": ((1, 2, 5, 6), {"out_h": 3, "out_w": 4,
                                                "scale": 2.0}),
}


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("case", sorted(INTERP_CASES))
def test_interp(method, case):
    """The output and its X gradient (the gathers' scatter-add) against
    the JAX lowering."""
    shape, attrs = INTERP_CASES[case]
    x = _randn(np.random.RandomState(8), *shape)
    ot = compare(f"{method}_interp", {"X": [x]}, attrs, ["Out"], ["X"],
                 "Out")
    oh = attrs.get("out_h") or int(shape[2] * attrs["scale"])
    ow = attrs.get("out_w") or int(shape[3] * attrs["scale"])
    assert ot["Out"][0].shape == (*shape[:2], oh, ow)


@pytest.mark.parametrize("align,mode", [(True, 1), (False, 0), (False, 1)],
                         ids=["align_corners", "half_pixel", "mode_1"])
def test_interp_source_coordinates_equal_jax(align, mode):
    """The float32 source coordinates of every convention, bit for bit,
    for every input side up to 40 and output side up to 40, and
    DeepLab's 129 and 513."""
    from paddle_tpu.ops import nn_ops as jnn
    from paddle_tpu_torch.ops import nn_ops as tnn
    for d in range(1, 41):
        for od in list(range(1, 41)) + [129, 513]:
            want = np.asarray(jnn._interp_src(od, d, align, mode))
            got = tnn._interp_src(od, d, align, mode, "cpu").numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{d}->{od}")


@pytest.mark.parametrize("case", ["half_pixel", "mode_1", "align_corners"])
def test_bilinear_interp_bfloat16(case):
    """DeepLab's last resize takes the bf16 logits under AMP: the output
    stays bfloat16 and the weights are rounded to it, as the reference
    rounds them; output and X gradient against jax.vjp."""
    shape, attrs = INTERP_CASES[case]
    x = _randn(np.random.RandomState(10), *shape)
    ot = compare("bilinear_interp", {"X": [x]}, attrs, ["Out"], ["X"],
                 "Out", tol=BF16_TOL, bf16=("X",))
    assert ot["Out"][0].dtype == torch.bfloat16


@pytest.mark.parametrize("dtypes,axis", [
    (("float32", "float32", "float32"), 1),
    (("bfloat16", "bfloat16"), 1),
    (("float32", "bfloat16"), 1),
    (("bfloat16", "float32", "bfloat16"), -1),
    (("float32", "float16"), 0),
    (("int32", "float32"), 1),
])
def test_concat_promotes_as_jax(dtypes, axis):
    """Mixed input dtypes give jnp.concatenate's result dtype; values
    exact, and the float inputs' gradients are the cotangent's slices
    in each input's own dtype, as jax.vjp gives them."""
    rng = np.random.RandomState(12)
    shapes = [[2, 3, 4] for _ in dtypes]
    for i, sh in enumerate(shapes):
        sh[axis] = i + 1
    arrays = [(rng.randn(*sh) * 4).astype(np.float32) for sh in shapes]
    jins = [jnp.asarray(a).astype(d) for a, d in zip(arrays, dtypes)]
    tins = [torch.from_numpy(a).to(getattr(torch, d))
            for a, d in zip(arrays, dtypes)]
    attrs = {"axis": axis}
    oj = _jax_outs("concat", {"X": jins}, attrs, False)["Out"][0]
    ctx = tlow._OpCtx(tlow.LowerCtx("cpu"), _op(attrs))
    floats = [t.is_floating_point() for t in tins]
    for t, fl in zip(tins, floats):
        t.requires_grad_(fl)
    with torch.enable_grad():
        ot = TREG.get("concat").lower(ctx, {"X": tins}, attrs)["Out"][0]
    assert str(ot.dtype).split(".")[-1] == str(oj.dtype)
    np.testing.assert_array_equal(ot.detach().float().numpy(),
                                  _as_np(oj).astype(np.float32))
    cot = rng.randn(*oj.shape).astype(np.float32)
    diff = [i for i, fl in enumerate(floats) if fl]

    def f(*xs):
        ins = list(jins)
        for i, x in zip(diff, xs):
            ins[i] = x
        return _jax_outs("concat", {"X": ins}, attrs, False)["Out"][0]

    _, vjp = jax.vjp(f, *[jins[i] for i in diff])
    gj = vjp(jnp.asarray(cot).astype(oj.dtype))
    gt = torch.autograd.grad(ot, [tins[i] for i in diff],
                             torch.from_numpy(cot).to(ot.dtype))
    for a, b in zip(gj, gt):
        assert str(b.dtype).split(".")[-1] == str(a.dtype)
        np.testing.assert_array_equal(b.float().numpy(),
                                      _as_np(a).astype(np.float32))


def test_deeplab_ops_registered_in_both():
    for t in ("bilinear_interp", "nearest_interp", "concat"):
        assert TREG.has(t) and JREG.get(t) is not None, t
        jdef, tdef = JREG.get(t), TREG.get(t)
        assert set(tdef.nondiff_inputs) == set(jdef.nondiff_inputs), t
        assert set(tdef.nondiff_outputs) == set(jdef.nondiff_outputs), t
