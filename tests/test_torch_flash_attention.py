"""paddle_tpu_torch's flash attention against paddle_tpu's.

On the CPU the port's `flash_attention` takes its plain version (the
kernel is CUDA only); it is held against the JAX package's
`flash_attention`, whose Pallas kernel runs in interpret mode here, and
against the JAX `reference_attention`. Tolerance atol 3e-5 in float32
(tiled online softmax vs one-shot softmax sum in different orders).

The kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401
import paddle_tpu_torch  # noqa: F401
from paddle_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
    reference_attention as jax_reference_attention)
from paddle_tpu_torch.core import lowering as tlow
from paddle_tpu_torch.core.registry import REGISTRY as TREG
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

ATOL = 3e-5


def _qkv(shape, seed=0):
    r = np.random.RandomState(seed)
    return [r.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("layout", ["bhtd", "bh_td"])
@pytest.mark.parametrize("t", [64, 128, 256, 300])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax(causal, t, layout):
    shape = (2, 2, t, 16) if layout == "bhtd" else (4, t, 16)
    q, k, v = _qkv(shape)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_k=128))
    want_ref = np.asarray(jax_reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, causal=causal).numpy()
    got_ref = tfa.reference_attention(tq, tk, tv, causal=causal).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got_ref, want_ref, atol=ATOL)


def test_cpu_path_launches_no_kernel():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 256, 32)))
    before = tfa.flash_attention.launches
    tfa.flash_attention(q, k, v)
    assert tfa.flash_attention.launches == before


def test_meta_tensors_give_shapes():
    q = torch.empty((2, 3, 300, 64), dtype=torch.bfloat16, device="meta")
    out = tfa.flash_attention(q, q, q, causal=True)
    assert out.shape == q.shape and out.dtype == torch.bfloat16


def test_kernel_entry_refuses_cpu_tensors():
    q = torch.zeros((2, 128, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, q, q)


def _run_op(attrs, q, k, v, is_test=False, op_id=3):
    import types
    op = types.SimpleNamespace(attrs=attrs, id=op_id, block=None)
    ctx = tlow._OpCtx(tlow.LowerCtx("cpu", seed=0, is_test=is_test), op)
    ins = {"Q": [torch.from_numpy(q)], "K": [torch.from_numpy(k)],
           "V": [torch.from_numpy(v)]}
    return TREG.get("flash_attention").lower(ctx, ins, attrs)["Out"][0]


@pytest.mark.parametrize("causal", [False, True])
def test_op_block_q_zero_takes_the_exact_path(causal):
    q, k, v = _qkv((1, 2, 128, 16))
    out = _run_op({"causal": causal, "block_q": 0, "block_k": 0}, q, k, v)
    want = jax_reference_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)


def test_op_attention_dropout_routing():
    """attn_dropout > 0 outside is_test: the plain path with a dropout
    mask drawn from the op's generator (reproducible per op id); under
    is_test the mask is off and the answer is the no-dropout one."""
    q, k, v = _qkv((1, 2, 128, 16))
    attrs = {"causal": False, "attn_dropout": 0.5, "is_test": False}
    a = _run_op(attrs, q, k, v)
    b = _run_op(attrs, q, k, v)
    c = _run_op(attrs, q, k, v, op_id=4)
    clean = _run_op({"causal": False, "attn_dropout": 0.0}, q, k, v)
    test_mode = _run_op(attrs, q, k, v, is_test=True)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.allclose(a, clean, atol=1e-3)
    np.testing.assert_allclose(test_mode.numpy(), clean.numpy(), atol=0)
