"""Ulysses (all-to-all) sequence parallelism.

The second long-context scheme beside ring attention
(ring_attention.py): two all-to-alls trade the sequence split for a head
split. The first gives each rank the whole sequence for h/sp of the
heads, attention runs over the whole T on those heads, and the second
restores the sequence split. Requires sp | h.

The local attention is one flash attention call on [b·h/sp, T, d]: the
Hopper kernels on CUDA tensors, their plain versions on CPU tensors.
The JAX package computes the same exact function as a loop over 512-key
blocks merged by log-sum-exp (ROADMAP §C).

Whole inputs (every rank holds all of q, k and v) need no all-to-all:
each rank takes its own heads, runs the same flash call on them and the
heads are gathered (`ulysses_attention_sharded`, and the op where the
rewrite has not chunked its inputs).
"""
from __future__ import annotations

import math

from ..core.registry import register_op
from ..ops import collective as coll
from ..ops.collective import Split, _AllToAll
from .ring_attention import _whole, seq_parallel_attention_op

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def ulysses_attention(q, k, v, group, causal=False, sm_scale=None):
    """Local sequence chunks [b, h, t_local, d] of this rank of `group`
    -> its output chunk; differentiable in q, k and v."""
    _check_heads(q, group)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    # [b, h, t/n, d] -> [b, h/n, t, d]
    qf, kf, vf = (_AllToAll.apply(x, group, 1, 2) for x in (q, k, v))
    o = _whole(qf, kf, vf, causal, sm_scale)
    # [b, h/n, t, d] -> [b, h, t/n, d]
    return _AllToAll.apply(o, group, 2, 1)


def _check_heads(q, group):
    import torch.distributed as dist
    n = dist.get_world_size(group)
    h = q.shape[1]
    if h % n:
        raise ValueError(
            f"ulysses_attention: heads ({h}) must divide by the "
            f"sequence-parallel degree ({n}); use ring attention for "
            f"head counts below the mesh axis size")


def _own_heads(q, k, v, group, causal=False, sm_scale=None):
    """Whole [b, h, T, d] inputs: attention over this rank's heads, the
    heads gathered whole again (gradients flow: the backward gathers
    dq, dk and dv)."""
    _check_heads(q, group)
    sp = Split(1)
    ql, kl, vl = (coll.scatter_to(x, group, sp) for x in (q, k, v))
    return coll.gather_from(_whole(ql, kl, vl, causal, sm_scale), group,
                            sp)


def ulysses_attention_sharded(q, k, v, mesh, seq_axis, causal=False,
                              sm_scale=None, batch_axis=None):
    """Whole [b, h, T, d] arrays on every rank -> Ulysses attention over
    the mesh's seq axis (each rank on its own heads); returns the whole
    output (ring_attention's contract)."""
    group = mesh.group(seq_axis)
    if group is None:
        return _whole(q, k, v, causal, sm_scale)
    return _own_heads(q, k, v, group, causal, sm_scale)


register_op("ulysses_attention")(
    seq_parallel_attention_op(ulysses_attention, _own_heads))
