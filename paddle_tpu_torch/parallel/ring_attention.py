"""Ring attention: sequence parallelism for long sequences on the flash
kernels.

Q, K and V are split on the sequence over the mesh's `sp` axis, one
chunk a rank. K/V chunks rotate around the ring (`dist.batch_isend_irecv`,
the irecv posted before the isend, so two gloo ranks do not deadlock);
at step i rank r holds chunk src = (r - i) mod n and attends its queries
to it with the flash forward (`ops/cuda/flash_attention.py`): src == r is
the aligned diagonal block (causal), src < r a full block, and src > r,
fully masked under causal, is skipped (the JAX package computes it and
merges it with weight 0: the same result). The blocks' (o, lse) pairs
merge in float32 (`lse_merge`). The backward runs the dq and dk/dv
kernels on each live block with the merged (global) lse and
delta = rowsum(dO·O); dK/dV accumulate in float32 in buffers that rotate
with their chunk and land back on its owner after the full ring.

On CUDA tensors the blocks launch the Hopper kernels; on CPU tensors the
same schedule runs their plain versions (`*_reference`), so the CPU
tests hold the schedule the card runs. The kernel's o of a block comes
back in the input dtype (bf16 under AMP) where the JAX package keeps a
block's o in float32 before the merge (ROADMAP §C).

The `ring_attention` op (and `ulysses_attention`, ulysses.py) takes
[b, h, T, d]: whole on every rank, it chunks them itself and gathers the
output; where the model-parallel rewrite already split them on the
sequence over the op's seq axis it runs on the chunks. A mesh without
the seq axis runs flash attention over the whole T, as the JAX package
does.
"""
from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from ..ops import collective as coll
from ..ops.collective import Split

__all__ = ["ring_attention", "ring_attention_sharded", "lse_merge",
           "seq_parallel_attention_op"]


def lse_merge(o, lse, o_i, lse_i):
    """The online-softmax merge of two (o, lse) pairs over disjoint key
    sets, in float32: o [.., T, d], lse [.., T]."""
    new = torch.logaddexp(lse, lse_i)
    o = o * torch.exp(lse - new)[..., None] + \
        o_i.float() * torch.exp(lse_i - new)[..., None]
    return o, new


def _kernels(x):
    from ..ops.cuda import flash_attention as fa
    if x.device.type == "cuda":
        return fa.flash_attention_fwd, fa.flash_attention_bwd_dq, \
            fa.flash_attention_bwd_dkv
    if x.device.type == "cpu":
        return fa.flash_attention_fwd_reference, \
            fa.flash_attention_bwd_dq_reference, \
            fa.flash_attention_bwd_dkv_reference
    raise ValueError(f"ring_attention: no kernel for device {x.device}")


def _rotate(tensors, group):
    """Each tensor sent to the next rank of the ring, the previous
    rank's received in its place."""
    import torch.distributed as dist
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return tensors
    nxt = dist.get_global_rank(group, (r + 1) % n) \
        if group is not None and group is not dist.group.WORLD \
        else (r + 1) % n
    prv = dist.get_global_rank(group, (r - 1) % n) \
        if group is not None and group is not dist.group.WORLD \
        else (r - 1) % n
    staged = any(t.is_cuda for t in tensors) and \
        dist.get_backend(group) == "gloo"
    send = [t.detach().contiguous() for t in tensors]
    if staged:
        send = [t.cpu() for t in send]
        nb = sum(t.numel() * t.element_size() for t in send)
        coll.STAGED_BYTES["bytes"] += 2 * nb
    recv = [torch.empty_like(t) for t in send]
    # irecv first: gloo pairs the posted operations in order
    ops = [dist.P2POp(dist.irecv, t, prv, group) for t in recv] + \
        [dist.P2POp(dist.isend, t, nxt, group) for t in send]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    coll.COLLECTIVE_BYTES["p2p"] += sum(
        t.numel() * t.element_size() for t in send)
    if staged:
        recv = [t.to(tensors[0].device) for t in recv]
    return recv


def _blocks(n, r, causal):
    """(step, src, masked) of each block rank r computes: under causal
    the diagonal block takes the aligned mask and a later chunk's block
    is skipped."""
    out = []
    for i in range(n):
        src = (r - i) % n
        if causal and src > r:
            continue
        out.append((i, src, causal and src == r))
    return out


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale):
        import torch.distributed as dist
        n, r = dist.get_world_size(group), dist.get_rank(group)
        b, h, t, d = q.shape
        q3, k3, v3 = (x.reshape(b * h, t, d).contiguous()
                      for x in (q, k, v))
        fwd, _, _ = _kernels(q)
        live = {i: diag for i, _, diag in _blocks(n, r, causal)}
        o = torch.zeros(q3.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((b * h, t), -1e30, dtype=torch.float32,
                         device=q.device)
        kb, vb = k3, v3
        for i in range(n):
            if i in live:
                o_i, lse_i = fwd(q3, kb, vb, live[i], sm_scale)
                o, lse = lse_merge(o, lse, o_i, lse_i)
            if i < n - 1:
                kb, vb = _rotate([kb, vb], group)
        out = o.to(q.dtype)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.group, ctx.causal, ctx.sm_scale = group, causal, sm_scale
        ctx.shape = (b, h, t, d)
        return out.reshape(b, h, t, d)

    @staticmethod
    def backward(ctx, do):
        import torch.distributed as dist
        q3, k3, v3, o, lse = ctx.saved_tensors
        group = ctx.group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        b, h, t, d = ctx.shape
        do = do.reshape(b * h, t, d).to(q3.dtype).contiguous()
        delta = (do.float() * o.float()).sum(-1)
        _, bwd_dq, bwd_dkv = _kernels(q3)
        live = {i: diag for i, _, diag in _blocks(n, r, ctx.causal)}
        dq = torch.zeros(q3.shape, dtype=torch.float32, device=q3.device)
        dk = torch.zeros_like(dq)
        dv = torch.zeros_like(dq)
        kb, vb = k3, v3
        for i in range(n):
            if i in live:
                args = (q3, kb, vb, do, lse, delta, live[i], ctx.sm_scale)
                dq += bwd_dq(*args).float()
                dk_i, dv_i = bwd_dkv(*args)
                dk += dk_i.float()
                dv += dv_i.float()
            # dK/dV travel with their chunk: after n hops they are home
            if i < n - 1:
                kb, vb, dk, dv = _rotate([kb, vb, dk, dv], group)
            else:
                dk, dv = _rotate([dk, dv], group)
        shape = (b, h, t, d)
        return (dq.to(q3.dtype).reshape(shape),
                dk.to(k3.dtype).reshape(shape),
                dv.to(v3.dtype).reshape(shape), None, None, None)


def ring_attention(q, k, v, group, causal=False, sm_scale=None):
    """The local sequence chunks [b, h, t_local, d] of this rank of
    `group` (chunk r holds positions [r·t, (r+1)·t)) -> this rank's
    output chunk; differentiable in q, k and v."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _Ring.apply(q, k, v, group, bool(causal), float(sm_scale))


def _global_run(local_fn, q, k, v, group):
    """Whole [b, h, T, d] inputs: this rank's sequence chunk through
    `local_fn`, the output gathered whole again (gradients flow)."""
    sp = Split(2)
    ql, kl, vl = (coll.scatter_to(x, group, sp) for x in (q, k, v))
    return coll.gather_from(local_fn(ql, kl, vl), group, sp)


def ring_attention_sharded(q, k, v, mesh, seq_axis, causal=False,
                           sm_scale=None, batch_axis=None):
    """Whole [b, h, T, d] arrays on every rank -> ring attention over
    the mesh's seq axis (T split in one chunk a rank); returns the whole
    output. The batch is the rank's own (the executor splits it)."""
    group = mesh.group(seq_axis)
    if group is None:
        return _whole(q, k, v, causal, sm_scale)
    return _global_run(lambda a, b, c: ring_attention(
        a, b, c, group, causal, sm_scale), q, k, v, group)


def _whole(q, k, v, causal, sm_scale):
    from ..ops.cuda.flash_attention import flash_attention
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)


def seq_parallel_attention_op(local_fn, whole_fn=None):
    """The op body shared by ring and Ulysses attention: chunks given by
    the model-parallel rewrite run as they are, whole inputs go through
    `whole_fn` (default: chunked here, the output gathered), and a mesh
    without the seq axis (or one rank on it) runs flash attention over
    the whole T."""

    def _op(ctx, ins, attrs):
        from .mesh import get_mesh, world
        q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
        causal = bool(attrs.get("causal", False))
        scale = attrs.get("sm_scale")
        seq_axis = attrs.get("seq_axis", "sp")
        if q.device.type == "meta":
            return {"Out": [torch.empty_like(q)]}
        mesh = get_mesh()
        group = mesh.group(seq_axis) if world()[0] > 1 and \
            seq_axis in mesh.axis_names else None
        if group is None:
            return {"Out": [_whole(q, k, v, causal, scale)]}
        fn = lambda a, b, c: local_fn(a, b, c, group, causal,  # noqa
                                      scale)
        if getattr(ctx, "mp", {}).get("chunked"):
            return {"Out": [fn(q, k, v)]}
        if whole_fn is not None:
            return {"Out": [whole_fn(q, k, v, group, causal, scale)]}
        return {"Out": [_global_run(fn, q, k, v, group)]}
    return _op


register_op("ring_attention")(seq_parallel_attention_op(ring_attention))
