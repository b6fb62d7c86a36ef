"""The float32 kernels' arithmetic, emulated on the CPU.

`fwd_kernel_tf32wg` (csrc/flash_attention_fwd.cu), `dq_kernel_tf32wg` and
`dkv_kernel_tf32wg` (csrc/flash_attention_bwd.cu) take every product on
the TF32 tensor cores as 3xTF32: x = hi + lo with
hi = tf32(x), lo = tf32(x - hi), and a b = lo_a hi_b + hi_a lo_b + hi_a
hi_b, each product exact and every sum float32. Here the same products
are taken in float32 on tf32-rounded operands (round to nearest, ties away
from zero, low 13 bits cleared: `cvt.rna.tf32.f32`), and the gradients
are held against the plain versions the card checks them with: within the
float32 limit of 1e-4 (chip_smoke.F32_TOL) with three products, and
outside it with one (hi hi only), which is why the kernels take three.
A second emulation follows the kernels' order: tiles of 32 keys (dQ) and
16 queries (dK/dV), every product summed one 8-wide k step at a time, and
the products whose A operand comes from an accumulator (dS K, P^T dO,
dS^T Q) with the k columns of each step in the order 0, 2, 4, 6, 1, 3, 5,
7 on both operands, as the kernels' transposed B tiles are written
(sm90_tf32.cuh, key_slot). The forward's emulation walks its 32-key
stages with the online softmax (running max, rescaled sums and O), S
summed over d in k steps, and P V with the keys of each step in slot
order on both P and V^T. The kernels sum in another order than these
emulations, so they show the size of the error, not the card's bits.
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


# the key (or query) that column p of an 8-wide k step holds in a register
# A operand made from an accumulator: 0, 2, 4, 6 in columns 0 .. 3, then
# 1, 3, 5, 7
SLOT_KEYS = (0, 2, 4, 6, 1, 3, 5, 7)


def _slot_order(n):
    """Indices that put each 8-wide group of n keys in slot order."""
    return torch.tensor([8 * (i // 8) + SLOT_KEYS[i % 8] for i in range(n)])


def _mm_steps(a, b, products, a_order=None, b_order=None):
    """a [.., m, k] @ b [.., k, n] as the kernels sum it: one 8-wide k step
    at a time into a float32 accumulator, tf32 operands; a's k columns
    taken in a_order and b's k rows in b_order (natural by default)."""
    if a_order is not None:
        a = a[..., a_order]
    if b_order is not None:
        b = b[..., b_order, :]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        out = out + _mm("...mk,...kn->...mn", a[..., k0:k0 + 8],
                        b[..., k0:k0 + 8, :], products)
    return out


def _tiled_grads(q, k, v, do, lse, delta, causal, products,
                 b_order="slots"):
    """dQ, dK, dV in the kernels' order: dQ over key tiles of 32, dK and
    dV over query tiles of 16; S, dP, S^T and dP^T summed over d in k
    steps; dS K, P^T dO and dS^T Q with the A operand's k columns in slot
    order and the B operand's rows in `b_order` ("slots", as the kernels
    write their transposed tiles, or "natural")."""
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    t = q.shape[1]
    pos = torch.arange(t)

    def tile(rows, cols):
        s = _mm_steps(q[:, rows], k[:, cols].transpose(1, 2), products)
        s = s * sm_scale
        if causal:
            s = torch.where(pos[rows, None] >= pos[None, cols], s,
                            s.new_full((), -math.inf))
        p = torch.exp(s - lse[:, rows, None])
        dp = _mm_steps(do[:, rows], v[:, cols].transpose(1, 2), products)
        return p, p * (dp - delta[:, rows, None]) * sm_scale

    def ordered(a, b, n):
        order = _slot_order(n)
        return _mm_steps(a, b, products, order,
                         order if b_order == "slots" else None)

    every = torch.arange(t)
    dq = sum(ordered(tile(every, cols)[1], k[:, cols], 32)
             for cols in every.split(32))
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for rows in every.split(16):
        p, ds = tile(rows, every)
        dv = dv + ordered(p.transpose(1, 2), do[:, rows], 16)
        dk = dk + ordered(ds.transpose(1, 2), q[:, rows], 16)
    return dq, dk, dv


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_order_3xtf32_meets_the_float32_limit(causal):
    """The float32 kernels' order (tiles, k steps, the slot order on both
    operands of the register-A products): with three TF32 products dQ,
    dK, dV within 1e-4 of the plain versions, with one outside it; and a
    transposed tile left in natural key order (the mutant the card check
    catches) far outside it."""
    args = _inputs(2, 128, 64, causal, seed=11)
    want = (tfa.flash_attention_bwd_dq_reference(*args, causal=causal),
            *tfa.flash_attention_bwd_dkv_reference(*args, causal=causal))
    three = [_rel(g, w) for g, w in
             zip(_tiled_grads(*args, causal, 3), want)]
    one = [_rel(g, w) for g, w in
           zip(_tiled_grads(*args, causal, 1), want)]
    natural = [_rel(g, w) for g, w in
               zip(_tiled_grads(*args, causal, 3, "natural"), want)]
    assert max(three) <= F32_TOL, three
    assert max(one) > F32_TOL, one
    # dQ, dK and dV each read a transposed tile
    assert min(natural) > 100 * F32_TOL, natural


def _tiled_fwd(q, k, v, causal, products, v_order="slots"):
    """O and LSE as fwd_kernel_tf32wg computes them: 32-key stages (K and
    V zero past T, those keys masked), S = Q K^T in 8-wide k steps over
    d, the online softmax (running max on the raw scores, p = exp(sm_scale
    (s - m)), O and the row sums rescaled by exp(sm_scale (m_old - m))),
    O += P V in 8-key k steps with P's columns in slot order and V^T's
    rows in `v_order` ("slots", as the split stage writes V^T, or
    "natural"), then O / l and LSE = sm_scale m + ln l."""
    bh, t, d = q.shape
    sm_scale = 1.0 / math.sqrt(d)
    kr = 32
    pad = -t % kr
    k = torch.nn.functional.pad(k, (0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    rows = torch.arange(t)[:, None]
    m = torch.full((bh, t, 1), -1e30)
    l = torch.zeros(bh, t, 1)
    o = torch.zeros(bh, t, d)
    order = _slot_order(kr)
    for k0 in range(0, t + pad, kr):
        keys = torch.arange(k0, k0 + kr)[None, :]
        s = _mm_steps(q, k[:, k0:k0 + kr].transpose(1, 2), products)
        dead = (keys >= t) | (causal & (keys > rows))
        s = torch.where(dead, s.new_full((), -1e30), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(sm_scale * (m - m_new))
        p = torch.exp(sm_scale * (s - m_new))
        l = alpha * l + p.sum(-1, keepdim=True)
        o = alpha * o + _mm_steps(p, v[:, k0:k0 + kr], products, order,
                                  order if v_order == "slots" else None)
        m = m_new
    return o / l, (sm_scale * m + torch.log(l))[..., 0]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("variant", ["3xtf32", "one_product",
                                     "natural_order"])
def test_kernel_order_forward(variant, causal):
    """The float32 forward's order (32-key stages at a ragged T, k steps,
    the online softmax, P V with the slot order on both operands): with
    three TF32 products O and LSE within 1e-4 of the plain version; with
    one TF32 product O outside it; with V^T left in natural key order (the
    mutant the card check catches) far outside it."""
    r = np.random.RandomState(13)
    q, k, v = (torch.from_numpy(r.randn(2, 100, 64).astype(np.float32))
               for _ in range(3))
    want_o, want_lse = tfa.flash_attention_fwd_reference(q, k, v,
                                                         causal=causal)
    products, order = {"3xtf32": (3, "slots"), "one_product": (1, "slots"),
                       "natural_order": (3, "natural")}[variant]
    o, lse = _tiled_fwd(q, k, v, causal, products, order)
    err = (o - want_o).abs().max().item()
    if variant == "3xtf32":
        assert err <= F32_TOL, err
        assert (lse - want_lse).abs().max().item() <= F32_TOL
    elif variant == "one_product":
        assert err > F32_TOL, err
    else:
        assert err > 100 * F32_TOL, err


def test_slot_order_is_the_accumulator_to_operand_order():
    """An accumulator holds columns 2c and 2c + 1 of each 8-column block
    in lane c; a TF32 A operand holds columns c and c + 4. Slot c takes
    column 2c, slot c + 4 column 2c + 1."""
    for c in range(4):
        assert SLOT_KEYS[c] == 2 * c and SLOT_KEYS[c + 4] == 2 * c + 1
    assert _slot_order(16).tolist() == [0, 2, 4, 6, 1, 3, 5, 7,
                                        8, 10, 12, 14, 9, 11, 13, 15]


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


@pytest.mark.parametrize("bh,ms,cuda_core_ms", [
    (192, 0.0781, 0.1923), (96, 0.0391, 0.0962)])
def test_float32_forward_bound_is_3xtf32(bh, ms, cuda_core_ms):
    """The float32 forward's bound at the float32 training path's [192,
    512, 64] and the serving path's [96, 512, 64]: three TF32 products per
    product at the TF32 tensor-core peak, bound by operations (4 d
    operations a query-key pair); the CUDA-core bound beside it."""
    c = _chip_smoke()
    bound, by = c.attention_bound_ms("flash_attention_fwd", bh, 512, 64,
                                     False, 4)
    assert by == "operations" and round(bound, 4) == ms
    assert round(c.cuda_core_bound_ms("flash_attention_fwd", bh, 512, 64,
                                      False), 4) == cuda_core_ms


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
