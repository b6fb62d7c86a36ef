"""Flash attention: the Hopper kernels' wrappers, their plain PyTorch
versions and the autograd Function that joins them.

Three kernels replace the three TPU kernels of the JAX package's
``ops/pallas/flash_attention.py``:

- ``csrc/flash_attention_fwd.cu`` (``_fwd_kernel``): online-softmax
  attention O = softmax(s·QKᵀ, masked) V plus the row log-sum-exp,
  computed tile by tile so the [T, T] score matrix never reaches device
  memory;
- ``csrc/flash_attention_bwd.cu`` (``_bwd_dq_kernel`` and
  ``_bwd_dkv_kernel``): the FlashAttention-2 backward, dQ in one pass and
  dK, dV in another, each recomputing P from the saved log-sum-exp.

The entry points pick the design by dtype, and every design runs on the
tensor cores. bfloat16 runs ``fwd_kernel_wgmma``, ``dq_kernel_wgmma``
and ``dkv_kernel_wgmma``, Hopper designs (``csrc/sm90_bf16.cuh``): a
producer warpgroup keeps a ring of TMA tile loads in flight (tensor maps
over (d, T, bh), so a tile past T reads zeros, not the next head), two
consumer warpgroups of 64 rows each run every product as asynchronous
wgmma from the swizzled tiles, with the softmax or dS tile turned from
accumulator into register operand, and results leave by TMA store from
persistent blocks. float32 takes every product as 3xTF32: each operand
splits into a TF32 high and low part and each product is taken as three
TF32 products, which meets the float32 limit of 1e-4 where one TF32
product does not. It runs ``fwd_kernel_tf32wg``, ``dq_kernel_tf32wg``
and ``dkv_kernel_tf32wg``, the same Hopper designs on TF32 wgmma
(``csrc/sm90_tf32.cuh``), with a stage between TMA and wgmma that splits
each tile into hi and lo and writes the transposed copies TF32 wgmma
needs (the forward's Vᵀ, with its keys in the order of P's register
operand). The kernels sum in another order than the plain versions, so
they agree with them to rounding, not bit for bit.

``FlashAttentionFunction`` takes the place of the JAX package's
``_flash`` ``custom_vjp``: its forward saves q, k, v, o and the
log-sum-exp; its backward computes delta = rowsum(dO·O) in float32 and
runs the dq pass, then the dk/dv pass.

``flash_attention`` keeps the contract of the JAX package's function:
``[b, h, T, d]`` or ``[bh, T, d]`` inputs, ``sm_scale`` defaulting to
1/√d, T < 128 routed to the exact plain path (under autograd), output of
q's shape and dtype. For CUDA tensors the Function launches the kernels
or raises; it takes the plain versions only for tensors on the CPU, and
the meta device (shape inference) takes the exact plain path.
``block_q``/``block_k`` are TPU tile hints: the Hopper kernels pick their
own tile, and their numerics do not depend on them.
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
# head dims the kernels are instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(q, k, v, causal=False, sm_scale=None, dropout=0.0,
                        generator=None):
    """Naive exact attention over [..., T, d]: the plain version of the
    forward kernel. Scores in float32, masked with NEG_INF; attention
    dropout (when on) draws its keep mask from `generator`."""
    d = q.shape[-1]
    t = q.shape[-2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    s = torch.einsum("...qd,...kd->...qk", q, k).float() * sm_scale
    if causal:
        pos = torch.arange(t, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s,
                        s.new_full((), NEG_INF))
    w = torch.softmax(s, dim=-1)
    if dropout:
        if w.device.type == "meta":
            keep = torch.empty(w.shape, dtype=torch.bool, device="meta")
        else:
            keep = torch.rand(w.shape, generator=generator,
                              device=w.device) < (1.0 - dropout)
        w = torch.where(keep, w / (1.0 - dropout), w.new_zeros(()))
    return torch.einsum("...qk,...kd->...qd", w.to(q.dtype), v)


def _masked_scores(q, k, causal, sm_scale, dtype=None):
    """s·QKᵀ in float32 over [bh, T, d], causal entries set to NEG_INF.
    `dtype` is the type the product is taken in (q's own by default)."""
    t = q.shape[-2]
    if dtype is not None:
        q, k = q.to(dtype), k.to(dtype)
    s = torch.einsum("bqd,bkd->bqk", q, k).float() * sm_scale
    if causal:
        pos = torch.arange(t, device=q.device)
        s = torch.where(pos[:, None] >= pos[None, :], s,
                        s.new_full((), NEG_INF))
    return s


def flash_attention_fwd_reference(q, k, v, causal=False, sm_scale=None):
    """Plain version of the forward kernel over [bh, T, d]: (o in q's
    dtype, lse [bh, T] float32), the arithmetic of reference_attention."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = _masked_scores(q, k, causal, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.einsum("bqk,bkd->bqd", p.to(q.dtype), v), lse


def _bwd_tiles(q, k, v, do, lse, delta, causal, sm_scale):
    """P and dS of the FlashAttention-2 backward in float32."""
    f32 = torch.float32
    s = _masked_scores(q, k, causal, sm_scale, dtype=f32)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.to(f32), v.to(f32))
    ds = p * (dp - delta[..., None]) * sm_scale
    return p, ds


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, causal=False,
                                     sm_scale=None):
    """Plain version of the dq kernel over [bh, T, d]: dQ = dS·K with dS
    rounded to the input dtype before the product, as the TPU kernel
    does. Returns dQ in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds = _bwd_tiles(q, k, v, do, lse, delta, causal, sm_scale)
    dq = torch.einsum("bqk,bkd->bqd", ds.to(q.dtype).float(), k.float())
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, causal=False,
                                      sm_scale=None):
    """Plain version of the dk/dv kernel over [bh, T, d]: dV = Pᵀ·dO and
    dK = dSᵀ·Q, with P and dS rounded to the input dtype before the
    products. Returns (dK, dV) in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _bwd_tiles(q, k, v, do, lse, delta, causal, sm_scale)
    f32 = torch.float32
    dv = torch.einsum("bqk,bqd->bkd", p.to(q.dtype).to(f32), do.to(f32))
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).to(f32), q.to(f32))
    return dk.to(q.dtype), dv.to(q.dtype)


def _check_operands(name, *xs):
    """Raise on what the kernels do not take: CUDA [bh, T, d] tensors of
    one shape and dtype (float32 or bfloat16), d in KERNEL_HEAD_DIMS."""
    q = xs[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")
    if q.dim() != 3 or any(x.shape != q.shape for x in xs):
        raise ValueError(f"{name}: operands must share one [bh, T, d] "
                         f"shape; got {[tuple(x.shape) for x in xs]}")
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for x in xs):
        raise ValueError(f"{name} takes float32 or bfloat16 operands of "
                         f"one dtype; got {[x.dtype for x in xs]}")
    if q.shape[2] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[2]} not in {KERNEL_HEAD_DIMS}")
    if any(x.device != q.device for x in xs):
        raise ValueError(f"{name}: operands must lie on one device")


def _dense(x):
    """x contiguous, with its data on a 16-byte boundary: TMA's tensor
    maps and the kernels' 16-byte copies need it."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _rows(name, x, q):
    """A [bh, T] float32 row vector (lse, delta) on q's card."""
    bh, t = q.shape[:2]
    if x.shape != (bh, t) or x.dtype != torch.float32 or \
            x.device != q.device:
        raise ValueError(f"{name} must be [{bh}, {t}] float32 on "
                         f"{q.device}; got {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    return x.contiguous()


_LIB_FNS = {}


def _kernel_fn(lib, fn_name, n_ptrs, n_ints=3):
    """A kernel's C entry point, loaded (and built with nvcc) at first
    use, with its argument types: n_ptrs pointers, n_ints ints (bh, T, d
    and for the forward kv_len), sm_scale, causal, dtype, stream."""
    key = (lib, fn_name)
    if key not in _LIB_FNS:
        from .build import load
        fn = getattr(load(lib), fn_name)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [
            ctypes.c_int] * n_ints + [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB_FNS[key] = fn
    return _LIB_FNS[key]


def _launch(fn, ptrs, q, causal, sm_scale, what, extra_ints=()):
    """Call a kernel's entry point on PyTorch's current stream; raise if
    the launch failed."""
    bh, t, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*[x.data_ptr() for x in ptrs], bh, t, d, *extra_ints,
                 float(sm_scale), int(bool(causal)), _DTYPE_CODES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: cudaError {err} (bh={bh}, T={t}, "
            f"d={d}, dtype={q.dtype})")


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None):
    """Launch the forward kernel on CUDA [bh, T, d] q, k, v. Returns (o
    [bh, T, d] in q's dtype, lse [bh, T] float32). Raises on anything the
    kernel does not take, and if the launch fails."""
    _check_operands("flash_attention_fwd", q, k, v)
    bh, t, d = q.shape
    q, k, v = _dense(q), _dense(k), _dense(v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    # the C entry point takes kv_len beside T; the wrapper passes T
    _launch(_kernel_fn("flash_attention_fwd", "flash_attention_fwd", 5, 4),
            (q, k, v, o, lse), q, causal, sm_scale, "flash_attention_fwd",
            extra_ints=(t,))
    flash_attention.launches += 1
    return o, lse


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           sm_scale=None):
    """Launch the dq kernel on CUDA [bh, T, d] q, k, v, dO with the
    forward's lse and delta = rowsum(dO·O), both [bh, T] float32.
    Returns dQ in q's dtype."""
    _check_operands("flash_attention_bwd_dq", q, k, v, do)
    q, k, v, do = (_dense(x) for x in (q, k, v, do))
    lse, delta = _rows("lse", lse, q), _rows("delta", delta, q)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[2])
    dq = torch.empty_like(q)
    _launch(_kernel_fn("flash_attention_bwd", "flash_attention_bwd_dq", 7),
            (q, k, v, do, lse, delta, dq), q, causal, sm_scale,
            "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            sm_scale=None):
    """Launch the dk/dv kernel (arguments as flash_attention_bwd_dq).
    Returns (dK, dV) in q's dtype."""
    _check_operands("flash_attention_bwd_dkv", q, k, v, do)
    q, k, v, do = (_dense(x) for x in (q, k, v, do))
    lse, delta = _rows("lse", lse, q), _rows("delta", delta, q)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[2])
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _launch(_kernel_fn("flash_attention_bwd", "flash_attention_bwd_dkv", 8),
            (q, k, v, do, lse, delta, dk, dv), q, causal, sm_scale,
            "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention over [bh, T, d] with its FlashAttention-2
    backward: the kernels for CUDA tensors, the plain versions for CPU
    tensors, a raise for any other device."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        if q.device.type == "cuda":
            o, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        elif q.device.type == "cpu":
            o, lse = flash_attention_fwd_reference(q, k, v, causal, sm_scale)
        else:
            raise ValueError(f"flash_attention: no kernel for device "
                             f"{q.device.type}")
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        # delta = rowsum(dO·O) once per row, outside the kernels, as the
        # JAX package's wrapper computes it
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale)
        if q.device.type == "cuda":
            dq = flash_attention_bwd_dq(*args)
            dk, dv = flash_attention_bwd_dkv(*args)
        else:
            dq = flash_attention_bwd_dq_reference(*args)
            dk, dv = flash_attention_bwd_dkv_reference(*args)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None, block_q=None,
                    block_k=None):
    """q, k, v: [batch, heads, T, head_dim] (or [bh, T, d]). Returns the
    attention output, same shape and dtype as q, differentiable in q, k
    and v."""
    orig_shape = q.shape
    if q.dim() == 4:
        b, h, t, d = q.shape
        q = q.reshape(b * h, t, d)
        k = k.reshape(b * h, t, d)
        v = v.reshape(b * h, t, d)
    t, d = q.shape[1], q.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if t < 128 or q.device.type == "meta":
        # T < 128: the exact path is the reference's own routing there.
        # Meta tensors: shape inference.
        out = reference_attention(q, k, v, causal=causal, sm_scale=sm_scale)
        return out.reshape(orig_shape)
    # the kernels mask the ragged tail themselves: no padding to 128
    out = FlashAttentionFunction.apply(q, k, v, bool(causal),
                                       float(sm_scale))
    return out.reshape(orig_shape)


# kernel launches since each count was last set to 0: the forward's on
# flash_attention, each backward kernel's on its own wrapper
flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
