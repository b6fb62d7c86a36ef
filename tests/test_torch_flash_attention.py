"""paddle_tpu_torch's flash attention against paddle_tpu's.

On the CPU the port's `flash_attention` takes its plain versions (the
kernels are CUDA only); it is held against the JAX package's
`flash_attention`, whose Pallas kernels run in interpret mode here, and
against the JAX `reference_attention`. Tolerances: atol 3e-5 on the
float32 forward (tiled online softmax vs one-shot softmax, sums in
different orders) and atol 1e-4 on the float32 gradients (three chained
products per gradient, each summed in a different order).

The kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
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


GRAD_ATOL = 1e-4


def _jax_grads(q, k, v, g, causal, dtype=jnp.float32):
    def loss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, block_q=128,
                                  block_k=128)
        return jnp.sum(out.astype(jnp.float32) * g)
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a).astype(dtype) for a in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


def _torch_grads(q, k, v, g, causal, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return [x.grad.float().numpy() for x in leaves]


@pytest.mark.parametrize("layout", ["bhtd", "bh_td"])
@pytest.mark.parametrize("t", [64, 128, 256, 300])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_grads_match_jax(causal, t, layout):
    """dq, dk, dv of the port's Function (plain forward and backward on
    the CPU; T < 128 through autograd of the plain attention) against
    jax.grad through the Pallas kernels in interpret mode."""
    shape = (2, 2, t, 16) if layout == "bhtd" else (4, t, 16)
    q, k, v = _qkv(shape, seed=1)
    g = np.random.RandomState(2).randn(*shape).astype(np.float32)
    for got, want in zip(_torch_grads(q, k, v, g, causal),
                         _jax_grads(q, k, v, g, causal)):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL)


def test_flash_attention_grads_match_jax_bf16():
    """bfloat16 operands: both sides round P and dS to bfloat16 before
    their products and store the gradients in bfloat16 (8 bits of
    mantissa), so the tolerance is 3e-2 against gradients of size ~1."""
    shape = (2, 2, 256, 32)
    q, k, v = _qkv(shape, seed=3)
    g = np.random.RandomState(4).randn(*shape).astype(np.float32)
    got = _torch_grads(q, k, v, g, True, torch.bfloat16)
    want = _jax_grads(q, k, v, g, True, jnp.bfloat16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("t,causal", [(128, False), (300, True)])
def test_plain_backward_matches_autograd_of_reference(t, causal):
    """The plain dq and dk/dv versions (the kernels' yardsticks on the
    card) against autograd through the plain attention, float32."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((3, t, 32), seed=5))
    do = torch.from_numpy(
        np.random.RandomState(6).randn(3, t, 32).astype(np.float32))
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal=causal)
    delta = (do * o).sum(-1)
    dq = tfa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                              causal=causal)
    dk, dv = tfa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                   causal=causal)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = tfa.reference_attention(*leaves, causal=causal)
    np.testing.assert_allclose(o.numpy(), ref.detach().numpy(), atol=ATOL)
    want = torch.autograd.grad(ref, leaves, do)
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=GRAD_ATOL)


def test_cpu_backward_launches_no_kernel():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv((2, 256, 32)))
    counts = (tfa.flash_attention_bwd_dq.launches,
              tfa.flash_attention_bwd_dkv.launches)
    tfa.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert (tfa.flash_attention_bwd_dq.launches,
            tfa.flash_attention_bwd_dkv.launches) == counts


def test_backward_kernel_entries_refuse_cpu_tensors():
    q = torch.zeros((2, 128, 64))
    lse = torch.zeros((2, 128))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dq(q, q, q, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_bwd_dkv(q, q, q, q, lse, lse)
