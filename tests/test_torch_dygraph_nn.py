"""The dygraph layers and the op types they run, port against the JAX
package on the CPU.

- The 18 dygraph.nn layers of chip_smoke.dygraph_layer_cases (the cases
  [dygraph_layers] runs on the card): each built in the JAX package,
  its state dict carried into the port's layer by
  convert.layer_from_numpy, then one forward and backward in each
  (chip_smoke.dygraph_layer_run): outputs, parameter and input
  gradients and the state after the step (BatchNorm's running
  statistics) within 1e-5 of max(1, max|JAX|). NCE draws its negatives
  from each package's own generator, so each package's cost and
  gradients are held to chip_smoke.nce_formula on the negatives it
  drew; Dropout by chip_smoke.check_dropout in each.
- Conv2DTranspose's output_size window, as the JAX package's test of it
  (tests/test_layer_wrappers.py).
- The 14 op types the layers and VarBase run that the port had not
  registered, each against the JAX lowering with its gradients
  (test_torch_vision_ops.compare: within 1e-5 of max(1, max|JAX|)):
  conv3d, conv2d_transpose, conv3d_transpose, group_norm, prelu,
  gru_unit, bilinear_tensor_product, spectral_norm, tree_conv,
  reduce_sum, reduce_max, reduce_min (ties split their gradient evenly,
  as jax's do), sigmoid; and nce on the negatives it drew.
"""
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu.dygraph as jdg
import paddle_tpu_torch as ptt
import paddle_tpu_torch.dygraph as tdg
from paddle_tpu_torch.convert import layer_from_numpy
from paddle_tpu_torch.core.lowering import LowerCtx, _OpCtx
from paddle_tpu_torch.core.registry import REGISTRY as TREG
from test_torch_vision_ops import _op, compare

TOL = 1e-5


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
CASES = {name: (make, arrays) for name, make, arrays in
         SMOKE.dygraph_layer_cases(np.random.RandomState(7))}
KEYS = ("out", "grad", "in_grad", "after")


def test_the_cases_are_the_18_layers():
    assert sorted(CASES) == sorted(jdg.nn.__all__)
    assert sorted(tdg.nn.__all__) == sorted(jdg.nn.__all__)


@pytest.mark.parametrize("name", sorted(set(CASES) - {"NCE", "Dropout"}))
def test_layer_matches_jax(name):
    make, arrays = CASES[name]
    want = SMOKE.dygraph_layer_run(jdg, make, arrays, None)
    got = SMOKE.dygraph_layer_run(tdg, make, arrays, ptt.CPUPlace(),
                                  want["state"], layer_from_numpy)
    gap = SMOKE.max_gap({k: got[k] for k in KEYS},
                        {k: want[k] for k in KEYS})
    assert gap <= TOL, (name, gap)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_nce_matches_the_formula_on_its_negatives(pkg):
    make, arrays = CASES["NCE"]
    dg, place = (jdg, None) if pkg == "jax" else (tdg, ptt.CPUPlace())
    run = SMOKE.dygraph_nce_run(dg, make, arrays, place)
    ids = np.asarray(run["ids"])
    assert ids.shape == (4, 6) and np.array_equal(
        ids[:, 0], arrays[1][0].reshape(-1))
    assert ids.min() >= 0 and ids.max() < 20
    cost, grads = SMOKE.nce_formula(arrays[0][0], run["state"]["weight"],
                                    run["state"]["bias"], ids)
    assert SMOKE.max_gap(run["cost"], cost) <= TOL
    assert SMOKE.max_gap(run["grad"], grads) <= TOL


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_dropout_keeps_or_zeroes(pkg):
    make, arrays = CASES["Dropout"]
    dg, place = (jdg, None) if pkg == "jax" else (tdg, ptt.CPUPlace())
    run = SMOKE.dygraph_layer_run(dg, make, arrays, place)
    SMOKE.check_dropout(run, arrays[0][0], 0.3)


@pytest.mark.parametrize("osz,ok", [(11, True), (12, True), (13, False),
                                    (10, False)])
def test_conv2d_transpose_output_size_window(osz, ok):
    x = np.random.RandomState(0).randn(1, 2, 5, 5).astype(np.float32)
    for dg, place in ((jdg, None), (tdg, ptt.CPUPlace())):
        with dg.guard(place):
            ct = dg.Conv2DTranspose(num_channels=2, num_filters=3,
                                    filter_size=3, stride=2,
                                    output_size=[osz, osz])
            if ok:
                assert ct(dg.to_variable(x)).numpy().shape == \
                    (1, 3, osz, osz)
            else:
                with pytest.raises(ValueError, match="unreachable"):
                    ct(dg.to_variable(x))


# -- the op types ----------------------------------------------------------

def _r(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _cases():
    rng = np.random.RandomState(3)
    edges = np.array([[[1, 2], [1, 3], [3, 4], [0, 0], [2, 5]],
                      [[1, 2], [2, 3], [0, 0], [0, 0], [0, 0]]], np.int64)
    return {
        "conv3d": ("conv3d", {"Input": [_r(rng, 2, 4, 5, 6, 5)],
                              "Filter": [_r(rng, 6, 2, 3, 2, 3)]},
                   {"strides": [1, 2, 1], "paddings": [1, 0, 1],
                    "dilations": [1, 1, 2], "groups": 2},
                   ["Output"], ["Input", "Filter"], "Output"),
        "conv2d_transpose": (
            "conv2d_transpose", {"Input": [_r(rng, 2, 4, 5, 6)],
                                 "Filter": [_r(rng, 4, 3, 3, 3)]},
            {"strides": [2, 3], "paddings": [1, 0], "dilations": [1, 1],
             "groups": 2, "output_padding": [1, 2]},
            ["Output"], ["Input", "Filter"], "Output"),
        "conv2d_transpose_dilated": (
            "conv2d_transpose", {"Input": [_r(rng, 1, 3, 4, 4)],
                                 "Filter": [_r(rng, 3, 2, 3, 2)]},
            {"strides": [1, 2], "paddings": [2, 1], "dilations": [2, 1]},
            ["Output"], ["Input", "Filter"], "Output"),
        "conv3d_transpose": (
            "conv3d_transpose", {"Input": [_r(rng, 1, 2, 3, 4, 3)],
                                 "Filter": [_r(rng, 2, 3, 2, 3, 2)]},
            {"strides": [2, 1, 2], "paddings": [0, 1, 0],
             "output_padding": [1, 0, 0]},
            ["Output"], ["Input", "Filter"], "Output"),
        "group_norm": ("group_norm", {"X": [_r(rng, 3, 6, 4, 5)],
                                      "Scale": [_r(rng, 6)],
                                      "Bias": [_r(rng, 6)]},
                       {"groups": 3, "epsilon": 1e-5},
                       ["Y", "Mean", "Variance"], ["X", "Scale", "Bias"],
                       "Y"),
        "prelu_all": ("prelu", {"X": [_r(rng, 2, 3, 4)],
                                "Alpha": [_r(rng, 1)]}, {"mode": "all"},
                      ["Out"], ["X", "Alpha"], "Out"),
        "prelu_channel": ("prelu", {"X": [_r(rng, 2, 3, 4, 4)],
                                    "Alpha": [_r(rng, 3)]},
                          {"mode": "channel"}, ["Out"], ["X", "Alpha"],
                          "Out"),
        "prelu_element": ("prelu", {"X": [_r(rng, 2, 3, 4)],
                                    "Alpha": [_r(rng, 3, 4)]},
                          {"mode": "element"}, ["Out"], ["X", "Alpha"],
                          "Out"),
        "gru_unit": ("gru_unit", {"Input": [_r(rng, 3, 12)],
                                  "HiddenPrev": [_r(rng, 3, 4)],
                                  "Weight": [_r(rng, 4, 12)],
                                  "Bias": [_r(rng, 1, 12)]},
                     {"activation": "tanh", "gate_activation": "sigmoid",
                      "origin_mode": False},
                     ["Gate", "ResetHiddenPrev", "Hidden"],
                     ["Input", "HiddenPrev", "Weight", "Bias"], "Hidden"),
        "gru_unit_origin": ("gru_unit", {"Input": [_r(rng, 3, 12)],
                                         "HiddenPrev": [_r(rng, 3, 4)],
                                         "Weight": [_r(rng, 4, 12)]},
                            {"activation": "relu",
                             "gate_activation": "sigmoid",
                             "origin_mode": True},
                            ["Gate", "ResetHiddenPrev", "Hidden"],
                            ["Input", "HiddenPrev", "Weight"], "Hidden"),
        "bilinear_tensor_product": (
            "bilinear_tensor_product", {"X": [_r(rng, 3, 4)],
                                        "Y": [_r(rng, 3, 5)],
                                        "Weight": [_r(rng, 2, 4, 5)],
                                        "Bias": [_r(rng, 1, 2)]},
            {}, ["Out"], ["X", "Y", "Weight", "Bias"], "Out"),
        "spectral_norm": ("spectral_norm", {"Weight": [_r(rng, 4, 3, 5)],
                                            "U": [_r(rng, 3)],
                                            "V": [_r(rng, 20)]},
                          {"dim": 1, "power_iters": 2, "eps": 1e-12},
                          ["Out"], ["Weight", "U", "V"], "Out"),
        "tree_conv": ("tree_conv", {"NodesVector": [_r(rng, 2, 6, 5)],
                                    "EdgeSet": [edges],
                                    "Filter": [_r(rng, 5, 3, 4, 2)]},
                      {"max_depth": 3}, ["Out"], ["NodesVector", "Filter"],
                      "Out"),
        "sigmoid": ("sigmoid", {"X": [_r(rng, 3, 7)]}, {}, ["Out"], ["X"],
                    "Out"),
    }


CASE_SPECS = _cases()


@pytest.mark.parametrize("case", sorted(CASE_SPECS))
def test_op_matches_jax(case):
    op_type, ins, attrs, slots, grad_slots, diff_out = CASE_SPECS[case]
    compare(op_type, ins, attrs, slots, grad_slots, diff_out)


# reduce_all keeps its dims here: compare() reads a 0-d output as a
# Python float (a 0-d reduction is VarBase.mean() in
# tests/test_torch_dygraph.py)
REDUCE_ATTRS = {
    "all": {"dim": None, "keep_dim": True, "reduce_all": True},
    "dim1": {"dim": [1], "keep_dim": False, "reduce_all": False},
    "neg_dims_keep": {"dim": [-1, 0], "keep_dim": True,
                      "reduce_all": False},
}


@pytest.mark.parametrize("attrs", sorted(REDUCE_ATTRS))
@pytest.mark.parametrize("op_type", ["reduce_sum", "reduce_max",
                                     "reduce_min", "reduce_mean"])
def test_reduce_matches_jax(op_type, attrs):
    x = np.random.RandomState(4).randn(3, 4, 5).astype(np.float32)
    compare(op_type, {"X": [x]}, REDUCE_ATTRS[attrs], ["Out"], ["X"],
            "Out")


@pytest.mark.parametrize("op_type", ["reduce_max", "reduce_min"])
def test_reduce_ties_split_the_gradient(op_type):
    """Tied extremes share the gradient evenly in both packages."""
    x = np.array([[1.0, 3.0, 3.0, -2.0], [-2.0, 0.5, -2.0, -2.0]],
                 np.float32)
    compare(op_type, {"X": [x]}, REDUCE_ATTRS["dim1"], ["Out"], ["X"],
            "Out")
    compare(op_type, {"X": [x]}, REDUCE_ATTRS["all"], ["Out"], ["X"],
            "Out")


def test_nce_op_cost_on_its_negatives():
    """The port's nce op on the CPU: ids are the labels then negatives in
    [0, total), the cost and gradients those of nce_formula on them."""
    import torch
    rng = np.random.RandomState(5)
    x, w, b = _r(rng, 5, 4), _r(rng, 30, 4), _r(rng, 30)
    label = rng.randint(0, 30, (5, 1))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, w, b)]
    attrs = {"num_total_classes": 30, "num_neg_samples": 7}
    ctx = _OpCtx(LowerCtx("cpu"), _op(attrs))
    outs = TREG.get("nce").lower(ctx, {"Input": [ts[0]], "Weight": [ts[1]],
                                       "Bias": [ts[2]],
                                       "Label": [torch.tensor(label)]},
                                 attrs)
    ids = outs["SampleLabels"][0].numpy()
    assert ids.shape == (5, 8) and np.array_equal(ids[:, 0],
                                                  label.reshape(-1))
    assert ids.min() >= 0 and ids.max() < 30
    outs["Cost"][0].sum().backward()
    cost, grads = SMOKE.nce_formula(x, w, b, ids)
    assert SMOKE.max_gap(outs["Cost"][0].detach().numpy(), cost) <= TOL
    assert SMOKE.max_gap([t.grad.numpy() for t in ts],
                         [grads["Input"], grads["weight"],
                          grads["bias"]]) <= TOL


def test_the_14_op_types_are_registered_in_both():
    from paddle_tpu.core.registry import REGISTRY as JREG
    for op in ("conv3d", "conv2d_transpose", "conv3d_transpose",
               "group_norm", "prelu", "gru_unit", "nce",
               "bilinear_tensor_product", "spectral_norm", "tree_conv",
               "reduce_sum", "reduce_max", "reduce_min", "sigmoid"):
        assert TREG.has(op) and JREG.has(op), op
