"""The op types of the dense-layer slice's first groups (math.py,
loss_ops.py, activations.py, elementwise.py and reduce.py of the JAX
package; 79 types), each against its JAX lowering on
chip_smoke.dense_op_cases' seeded inputs.

Every output is compared (floats within 1e-6 of max(1, max|JAX|),
integers, indices and bools exactly, with equal shapes and dtype
kinds), and the gradients of the case's differentiated inputs for seeded
cotangents of every differentiable float output, within the same 1e-6:
torch.autograd through the port's lowering against jax.grad through the
JAX one. Largest gap measured on the CPU: 2.9e-7 (tanh_shrink's
gradient). A second variant of each op with options the first does not
take (scatter's add, cumsum's forward and flattened forms, argsort
ascending, pad2d's edge and NHWC forms, the other kldiv reductions and
more) runs through the same comparison.
"""
import numpy as np
import pytest

from torch_dense_helpers import chip_smoke, compare_op

FIRST_OPS = chip_smoke.DENSE_OP_TYPES[
    :chip_smoke.DENSE_OP_TYPES.index("log_softmax")]


def test_the_first_groups_hold_79_types():
    assert len(FIRST_OPS) == 79


@pytest.mark.parametrize("op_type", FIRST_OPS)
def test_op_matches_jax(op_type):
    ins, attrs, outs, grads = chip_smoke.dense_op_cases()[op_type]
    compare_op(op_type, ins, attrs, outs, grads)


def _f(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


VARIANTS = {
    "scatter_add": ("scatter", {"X": [_f(1, 5, 4)],
                                "Ids": [np.array([3, 0, 3], np.int64)],
                                "Updates": [_f(2, 3, 4)]},
                    {"overwrite": False}, {"Out": 1}, ("X", "Updates")),
    "cumsum_flat": ("cumsum", {"X": [_f(3, 3, 4)]}, {"flatten": True},
                    {"Out": 1}, ("X",)),
    "cumsum_axis0": ("cumsum", {"X": [_f(4, 3, 4)]}, {"axis": 0},
                     {"Out": 1}, ("X",)),
    "argsort_asc": ("argsort", {"X": [np.round(_f(5, 4, 6))]}, {"axis": 0},
                    {"Out": 1, "Indices": 1}, ("X",)),
    "pad2d_edge_nhwc": ("pad2d", {"X": [_f(6, 1, 4, 5, 2)]},
                        {"paddings": [2, 0, 1, 3], "mode": "edge",
                         "data_format": "NHWC"}, {"Out": 1}, ("X",)),
    "pad2d_constant": ("pad2d", {"X": [_f(7, 2, 1, 3, 3)]},
                       {"paddings": [0, 1, 1, 0], "pad_value": -2.0},
                       {"Out": 1}, ("X",)),
    "split_num": ("split", {"X": [_f(8, 4, 6)]}, {"num": 3, "axis": 1},
                  {"Out": 3}, ("X",)),
    "squeeze2_all": ("squeeze2", {"X": [_f(9, 1, 3, 1)]}, {},
                     {"Out": 1, "XShape": 1}, ("X",)),
    "strided_forward": ("strided_slice", {"Input": [_f(10, 7, 9)]},
                        {"axes": [0, 1], "starts": [1, -7],
                         "ends": [6, -1], "strides": [2, 1]},
                        {"Out": 1}, ("Input",)),
    "expand_rank_up": ("expand", {"X": [_f(11, 3)]},
                       {"expand_times": [2, 2]}, {"Out": 1}, ("X",)),
    "kldiv_mean": ("kldiv_loss", {"X": [_f(12, 3, 4)],
                                  "Target": [np.abs(_f(13, 3, 4))]},
                   {"reduction": "mean"}, {"Loss": 1}, ("X",)),
    "kldiv_none": ("kldiv_loss", {"X": [_f(14, 3, 4)],
                                  "Target": [np.abs(_f(15, 3, 4))]},
                   {"reduction": "none"}, {"Loss": 1}, ("X",)),
    "smooth_l1_plain": ("smooth_l1_loss", {"X": [_f(16, 4, 2, 3)],
                                           "Y": [_f(17, 4, 2, 3)]}, {},
                        {"Out": 1, "Diff": 1}, ("X", "Y")),
    "sigmoid_ce_plain": ("sigmoid_cross_entropy_with_logits",
                         {"X": [_f(18, 3, 4)],
                          "Label": [np.abs(_f(19, 3, 4)) % 1]}, {},
                         {"Out": 1}, ("X",)),
    "center_loss_frozen": ("center_loss",
                           {"X": [_f(20, 4, 3)],
                            "Label": [np.array([[1], [1], [0], [3]],
                                               np.int64)],
                            "Centers": [_f(21, 4, 3)],
                            "CenterUpdateRate": [np.array([0.5],
                                                          np.float32)]},
                           {"need_update": False},
                           {"Loss": 1, "SampleCenterDiff": 1}, ("X",)),
    "reduce_prod_all": ("reduce_prod", {"X": [_f(22, 2, 3) * 0.5 + 1]},
                        {"reduce_all": True}, {"Out": 1}, ("X",)),
    "l2_normalize_axis0": ("l2_normalize", {"X": [_f(23, 3, 5)]},
                           {"axis": 0}, {"Out": 1, "Norm": 1}, ("X",)),
    "matmul_v2_trans_x": ("matmul_v2", {"X": [_f(24, 4, 3)],
                                        "Y": [_f(25, 4, 5)]},
                          {"trans_x": True}, {"Out": 1}, ("X", "Y")),
    "maxout_last": ("maxout", {"X": [_f(26, 2, 3, 6)]},
                    {"groups": 2, "axis": 2}, {"Out": 1}, ("X",)),
    "compare_axis": ("less_than", {"X": [_f(27, 2, 3, 4)],
                                   "Y": [_f(28, 3)]}, {"axis": 1},
                     {"Out": 1}, ()),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_op_variant_matches_jax(variant):
    op_type, ins, attrs, outs, grads = VARIANTS[variant]
    compare_op(op_type, ins, attrs, outs, grads)
