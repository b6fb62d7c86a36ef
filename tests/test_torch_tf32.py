"""The float32 backward kernels' arithmetic, emulated on the CPU.

`dq_kernel_tf32x3` and `dkv_kernel_tf32x3` (csrc/flash_attention_bwd.cu)
take every product on the TF32 tensor cores as 3xTF32: x = hi + lo with
hi = tf32(x), lo = tf32(x - hi), and a b = lo_a hi_b + hi_a lo_b + hi_a
hi_b, each product exact and every sum float32. Here the same products
are taken in float32 on tf32-rounded operands (round to nearest, ties away
from zero, low 13 bits cleared: `cvt.rna.tf32.f32`), and the gradients
are held against the plain versions the card checks them with: within the
float32 limit of 1e-4 (chip_smoke.F32_TOL) with three products, and
outside it with one (hi hi only), which is why the kernels take three.
The kernels sum in another order than this emulation, so it shows the
size of the error, not the card's bits.
"""
import math
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_attention as tfa

F32_TOL = 1e-4


def _tf32(x):
    """x rounded to the nearest tf32 (ties away from zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(eq, a, b, products):
    """einsum(eq, a, b) with tf32 operands: three products (3xTF32) or one
    (hi hi)."""
    ah, bh = _tf32(a), _tf32(b)
    hi = torch.einsum(eq, ah, bh)
    if products == 1:
        return hi
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + hi


def _emulated_grads(q, k, v, do, lse, delta, causal, products):
    """dQ, dK, dV as the kernels compute them, every product emulated."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = _mm("bqd,bkd->bqk", q, k, products) * sm_scale
    if causal:
        t = q.shape[1]
        keep = torch.arange(t)[:, None] >= torch.arange(t)[None, :]
        s = torch.where(keep, s, s.new_full((), -math.inf))
    p = torch.exp(s - lse[..., None])
    dp = _mm("bqd,bkd->bqk", do, v, products)
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = _mm("bqk,bkd->bqd", ds, k, products)
    dk = _mm("bqk,bqd->bkd", ds, q, products)
    dv = _mm("bqk,bqd->bkd", p, do, products)
    return dq, dk, dv


def _inputs(bh, t, d, causal, seed):
    r = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(r.randn(bh, t, d).astype(np.float32))
                   for _ in range(4))
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal=causal)
    return q, k, v, do, lse, (do * o).sum(-1)


def _rel(got, want):
    """chip_smoke's float32 reading: max|got - want| / max(1, max|want|)."""
    return ((got - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


@pytest.mark.parametrize("causal", [False, True])
def test_three_tf32_products_meet_the_float32_limit(causal):
    """3xTF32 dQ, dK, dV within 1e-4 of the plain versions; one TF32
    product per product is not (its worst gradient misses the limit)."""
    args = _inputs(4, 128, 64, causal, seed=7)
    want = (tfa.flash_attention_bwd_dq_reference(*args, causal=causal),
            *tfa.flash_attention_bwd_dkv_reference(*args, causal=causal))
    three = [_rel(g, w) for g, w in
             zip(_emulated_grads(*args, causal, 3), want)]
    one = [_rel(g, w) for g, w in
           zip(_emulated_grads(*args, causal, 1), want)]
    assert max(three) <= F32_TOL, three
    assert max(one) > F32_TOL, one


def test_tf32_rounding_clears_the_low_bits_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -11], dtype=torch.float32)
    got = _tf32(x)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    # tf32 keeps 10 bits after the point: 2^-10 is its last place at 1,
    # kept; half a place rounds away from zero; a quarter rounds down;
    # one and a half places round up to two
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                            -(1.0 + 2.0 ** -10), 1.0, 1.0 + 2.0 ** -9]


def _chip_smoke():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel,ms,cuda_core_ms", [
    ("flash_attention_bwd_dq", 0.2344, 0.5769),
    ("flash_attention_bwd_dkv", 0.3126, 0.7692)])
def test_float32_backward_bound_is_3xtf32(kernel, ms, cuda_core_ms):
    """The float32 backward's bound at [384, 512, 64]: three TF32 products
    per product at the TF32 tensor-core peak, bound by operations; the
    CUDA-core bound beside it is the same work at the float32 peak."""
    c = _chip_smoke()
    bound, by = c.attention_bound_ms(kernel, 384, 512, 64, False, 4)
    assert by == "operations" and round(bound, 4) == ms
    assert round(c.cuda_core_bound_ms(kernel, 384, 512, 64, False), 4) == \
        cuda_core_ms
