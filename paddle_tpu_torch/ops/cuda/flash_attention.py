"""Flash attention forward: the Hopper kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/flash_attention_fwd.cu``) replaces the TPU kernel
``_fwd_kernel`` of the JAX package's ``ops/pallas/flash_attention.py``:
online-softmax attention O = softmax(s·QKᵀ, masked) V plus the row
log-sum-exp, computed tile by tile so the [T, T] score matrix never
reaches device memory.

``flash_attention`` keeps the contract of the JAX package's function:
``[b, h, T, d]`` or ``[bh, T, d]`` inputs, ``sm_scale`` defaulting to
1/√d, T < 128 routed to the exact plain path, output of q's shape and
dtype. For a CUDA tensor it launches the kernel or raises; it takes the
plain version only for tensors on the CPU or the meta device (shape
inference). ``block_q``/``block_k`` are TPU tile hints: the Hopper
kernel picks its own tile, and its numerics do not depend on them.
"""
from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
# head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(q, k, v, causal=False, sm_scale=None, dropout=0.0,
                        generator=None):
    """Naive exact attention over [..., T, d]: the plain version of the
    kernel. Scores in float32, masked with NEG_INF; attention dropout
    (when on) draws its keep mask from `generator`."""
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


def _fwd_function():
    from .build import load
    fn = load("flash_attention_fwd").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_FWD = None


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None):
    """Launch the kernel on contiguous CUDA [bh, T, d] q, k, v.
    Returns (o [bh, T, d] in q's dtype, lse [bh, T] float32). Raises on
    anything the kernel does not take, and if the launch fails."""
    global _FWD
    if q.device.type != "cuda":
        raise ValueError("flash_attention_fwd takes CUDA tensors")
    if not (q.shape == k.shape == v.shape and q.dim() == 3):
        raise ValueError(f"q, k, v must share one [bh, T, d] shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention_fwd takes float32 or bfloat16 "
                         f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    bh, t, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {KERNEL_HEAD_DIMS}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one device")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    if _FWD is None:
        _FWD = _fwd_function()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _FWD(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   lse.data_ptr(), bh, t, d, t, float(sm_scale),
                   int(bool(causal)), _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_fwd kernel launch failed: cudaError {err} "
            f"(bh={bh}, T={t}, d={d}, dtype={q.dtype})")
    flash_attention.launches += 1
    return o, lse


def flash_attention(q, k, v, causal=False, sm_scale=None, block_q=None,
                    block_k=None):
    """q, k, v: [batch, heads, T, head_dim] (or [bh, T, d]). Returns the
    attention output, same shape and dtype as q."""
    orig_shape = q.shape
    if q.dim() == 4:
        b, h, t, d = q.shape
        q = q.reshape(b * h, t, d)
        k = k.reshape(b * h, t, d)
        v = v.reshape(b * h, t, d)
    t, d = q.shape[1], q.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    device = q.device.type
    if t < 128 or device in ("cpu", "meta"):
        # T < 128: the exact path is the reference's own routing there.
        # CPU / meta tensors: the plain version (tests, shape inference).
        out = reference_attention(q, k, v, causal=causal, sm_scale=sm_scale)
        return out.reshape(orig_shape)
    if device != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {device}")
    # the kernel masks the ragged tail itself: no padding to 128
    out, _ = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
    return out.reshape(orig_shape)


# kernel launches since the count was last set to 0
flash_attention.launches = 0
