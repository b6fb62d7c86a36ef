"""Each op of the serving slice: paddle_tpu_torch's lowering against
paddle_tpu's registered lowering on the same numpy inputs.

Tolerances: float32 atol 1e-5 (the two frameworks sum in different
orders). bfloat16 inputs are rounded identically on both sides; outputs
are compared in float32 with atol/rtol 2e-2, since the frameworks round
intermediates to bfloat16 at different places. Random ops cannot share
bits across frameworks (different generators), so they are compared by
their distributions; their deterministic modes are compared exactly.
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

F32_ATOL = 1e-5
BF16_TOL = 2e-2


def _op(attrs, op_id=7):
    return types.SimpleNamespace(attrs=dict(attrs), id=op_id, block=None,
                                 type="op")


def run_jax(op_type, ins, attrs, is_test=False, bf16=False):
    """bf16=True hands every float32 input over as bfloat16."""
    ctx = jlow._OpCtx(jlow.LowerCtx(jax.random.PRNGKey(0), is_test=is_test),
                      _op(attrs))
    jins = {s: [jnp.asarray(a).astype(jnp.bfloat16)
                if bf16 and a.dtype == np.float32 else jnp.asarray(a)
                for a in vs] for s, vs in ins.items()}
    outs = JREG.get(op_type).lower(ctx, jins, attrs)
    return {s: [np.asarray(jnp.asarray(o, jnp.float32)
                           if o.dtype == jnp.bfloat16 else o) for o in vs]
            for s, vs in outs.items()}


def run_torch(op_type, ins, attrs, is_test=False, bf16=False):
    ctx = tlow._OpCtx(tlow.LowerCtx("cpu", seed=0, is_test=is_test),
                      _op(attrs))
    tins = {s: [torch.from_numpy(a).to(torch.bfloat16)
                if bf16 and a.dtype == np.float32 else torch.from_numpy(a)
                for a in vs] for s, vs in ins.items()}
    outs = TREG.get(op_type).lower(ctx, tins, attrs)
    return {s: [(o.float() if o.dtype == torch.bfloat16 else o).numpy()
                for o in vs] for s, vs in outs.items()}


def _compare(op_type, ins, attrs, slots, bf16=False, is_test=False):
    oj = run_jax(op_type, ins, attrs, is_test, bf16)
    ot = run_torch(op_type, ins, attrs, is_test, bf16)
    for s in slots:
        for a, b in zip(oj[s], ot[s]):
            assert a.shape == b.shape, (s, a.shape, b.shape)
            if bf16:
                np.testing.assert_allclose(b, a, atol=BF16_TOL,
                                           rtol=BF16_TOL)
            else:
                np.testing.assert_allclose(b, a, atol=F32_ATOL)
    return oj, ot


R = np.random.RandomState(0)


def _randn(*shape):
    return R.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("xshape,yshape,xnc", [
    ((4, 8), (8, 5), 1), ((2, 3, 8), (8, 6), 2), ((2, 3, 4), (12, 5), 1)])
def test_mul(xshape, yshape, xnc, bf16):
    _compare("mul", {"X": [_randn(*xshape)], "Y": [_randn(*yshape)]},
             {"x_num_col_dims": xnc, "y_num_col_dims": 1}, ["Out"], bf16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("yshape,axis", [((4,), -1), ((3, 4), 1),
                                         ((2, 3, 4), -1), ((3,), 1)])
def test_elementwise_add(yshape, axis, bf16):
    _compare("elementwise_add",
             {"X": [_randn(2, 3, 4)], "Y": [_randn(*yshape)]},
             {"axis": axis}, ["Out"], bf16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("approximate", [False, True])
def test_gelu(approximate, bf16):
    _compare("gelu", {"X": [_randn(3, 17) * 3]},
             {"approximate": approximate}, ["Out"], bf16)


@pytest.mark.parametrize("bna,scale,shift", [(2, True, True), (1, True, True),
                                             (2, False, True),
                                             (2, True, False)])
def test_layer_norm(bna, scale, shift):
    x = _randn(2, 3, 8) * 2 + 1
    norm = int(np.prod(x.shape[bna:]))
    ins = {"X": [x]}
    if scale:
        ins["Scale"] = [_randn(norm)]
    if shift:
        ins["Bias"] = [_randn(norm)]
    _compare("layer_norm", ins, {"begin_norm_axis": bna, "epsilon": 1e-5},
             ["Y", "Mean", "Variance"])


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", [[6, 4], [-1, 3, 2, 2], [2, 12]])
def test_reshape2(shape, bf16):
    oj, ot = _compare("reshape2", {"X": [_randn(2, 3, 4)]},
                      {"shape": shape}, ["Out", "XShape"], bf16)
    assert ot["XShape"][0].shape == (0, 2, 3, 4)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("perm", [[0, 2, 1, 3], [3, 2, 1, 0]])
def test_transpose2(perm, bf16):
    _compare("transpose2", {"X": [_randn(2, 3, 4, 5)]}, {"axis": perm},
             ["Out", "XShape"], bf16)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("padding_idx", [-1, 3])
def test_lookup_table_v2(padding_idx, bf16):
    ids = np.array([[1, 3, 9], [0, 3, 2]], np.int64)
    _compare("lookup_table_v2", {"W": [_randn(10, 4)], "Ids": [ids]},
             {"padding_idx": padding_idx}, ["Out"], bf16)


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (0.5, 2.0)])
def test_add_position_encoding(alpha, beta):
    _compare("add_position_encoding", {"X": [_randn(2, 6, 8)]},
             {"alpha": alpha, "beta": beta}, ["Out"])


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_is_test_exact(impl):
    _compare("dropout", {"X": [_randn(4, 5)]},
             {"dropout_prob": 0.3, "is_test": True,
              "dropout_implementation": impl}, ["Out", "Mask"])


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_train_distribution(impl):
    """Keep fraction within 0.01 of 1-p on 200k draws in both packages;
    kept values scaled as the implementation says; Mask marks them."""
    x = np.abs(_randn(400, 500)) + 0.5
    attrs = {"dropout_prob": 0.25, "is_test": False,
             "dropout_implementation": impl}
    scale = 1 / 0.75 if impl == "upscale_in_train" else 1.0
    for outs in (run_jax("dropout", {"X": [x]}, attrs),
                 run_torch("dropout", {"X": [x]}, attrs)):
        out, mask = outs["Out"][0], outs["Mask"][0].astype(bool)
        assert abs(mask.mean() - 0.75) < 0.01
        np.testing.assert_allclose(out[mask], x[mask] * scale, rtol=1e-6)
        assert (out[~mask] == 0).all()


@pytest.mark.parametrize("dtype,value", [("float32", 1.5), ("int64", 3.0),
                                         ("bfloat16", -2.0)])
def test_fill_constant(dtype, value):
    _compare("fill_constant", {}, {"shape": [2, 3], "dtype": dtype,
                                   "value": value}, ["Out"])


@pytest.mark.parametrize("op,attrs,mean,std", [
    ("gaussian_random", {"mean": 0.5, "std": 2.0}, 0.5, 2.0),
    ("uniform_random", {"min": -1.0, "max": 3.0}, 1.0, 4 / 12 ** 0.5)])
def test_random_init_distribution(op, attrs, mean, std):
    """Mean and std within 0.02 of the target on 60k draws in both."""
    attrs = dict(attrs, shape=[200, 300], dtype="float32")
    for outs in (run_jax(op, {}, attrs), run_torch(op, {}, attrs)):
        out = outs["Out"][0]
        assert out.shape == (200, 300)
        assert abs(out.mean() - mean) < 0.02 * max(1.0, std)
        assert abs(out.std() - std) < 0.02 * max(1.0, std)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block_q", [None, 0])
def test_flash_attention_op(causal, block_q, bf16):
    """The op on [b, h, T, d] at T=128: the JAX side runs the Pallas
    kernel in interpret mode (or its exact path for block_q=0), the port
    its plain version on the CPU. float32 atol 3e-5 (tiled vs one-shot
    softmax)."""
    attrs = {"causal": causal, "attn_dropout": 0.0, "is_test": False,
             "sm_scale": 0.25}
    if block_q is not None:
        attrs["block_q"] = block_q
    ins = {"Q": [_randn(2, 2, 128, 16)], "K": [_randn(2, 2, 128, 16)],
           "V": [_randn(2, 2, 128, 16)]}
    oj = run_jax("flash_attention", ins, attrs, bf16=bf16)["Out"][0]
    ot = run_torch("flash_attention", ins, attrs, bf16=bf16)["Out"][0]
    if bf16:
        np.testing.assert_allclose(ot, oj, atol=BF16_TOL, rtol=BF16_TOL)
    else:
        np.testing.assert_allclose(ot, oj, atol=3e-5)


def test_every_slice_op_is_registered_in_both():
    ops = ["lookup_table_v2", "add_position_encoding", "dropout", "mul",
           "elementwise_add", "reshape2", "transpose2", "flash_attention",
           "gelu", "layer_norm", "gaussian_random", "fill_constant",
           "uniform_random"]
    for op in ops:
        assert TREG.has(op) and JREG.has(op)
        assert TREG.get(op).version == JREG.get(op).version
