"""Collective + sharding ops over torch.distributed.

Reference: operators/collective/ — c_allreduce_{sum,max,min,prod},
c_allgather, c_reducescatter, c_broadcast, each over a ring_id-keyed NCCL
communicator (c_allreduce_op.h), bootstrapped by c_gen_nccl_id (TCP
broadcast of ncclUniqueId, c_gen_nccl_id_op.cc:68).

The JAX package runs one process over a device mesh: a c_* op is a
jax.lax collective inside shard_map and the identity under GSPMD, where
the partitioner inserts the collectives. The port runs one process per
rank, as the reference did, so a c_* op runs its collective over the
torch.distributed group of the mesh axis its ring_id selects
(parallel/mesh.axis_for_ring). With no process group, or one rank on
that axis, it is the identity, as in the JAX package's GSPMD mode.

- Gradients flow through each collective (a torch.autograd.Function):
  all-reduce sum is its own transpose, all-gather and reduce-scatter are
  each other's, all-to-all is undone by the swapped all-to-all,
  broadcast sums the gradients onto its root; max/min pass the summed
  gradient to the ranks that hold the result, prod scales it by
  out / x.
- c_sync_calc_stream and c_sync_comm_stream wait for the current CUDA
  stream; c_comm_init, c_comm_init_all and c_gen_nccl_id do nothing: the
  process group is the bootstrap.
- shard_hint is the identity in a lowering: the rank program of a
  model-parallel run (parallel/model_parallel.py) turns each hint into
  the reshard it asks for, as an adapter on the op. A spec that names an
  axis the mesh lacks raises.
- The model-parallel rewrite's own autograd pairs, each over one mesh
  axis and a `Split` (the dim a tensor is split on): Megatron's f
  (`copy_to`: identity, all-reduce backward) and g (`reduce_from`:
  all-reduce, identity backward); `scatter_to` (this rank's block,
  all-gather backward) and `gather_from` (all-gather, this rank's block
  backward); `reduce_scatter_to` and its all-gather backward; and
  `fsdp_gather` (a weight's dim-0 shards all-gathered before use, the
  gradient reduce-scattered, or sliced where the ranks computed alike).
  Unlike `c_allreduce_sum` (its backward all-reduces), g's backward is
  the identity: its output is used alike on every rank.

A group whose backend is gloo runs a CUDA tensor's collective through
host memory: the port copies it to the host and back and counts the
bytes (STAGED_BYTES, the `parallel.host_staged_bytes` stat), so nothing
hides that copy. `COLLECTIVE_BYTES` counts each kind's payload.
"""
from __future__ import annotations

from collections import Counter

import torch

from ..core.registry import register_op
from ..monitor import STAT_ADD

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "broadcast",
           "all_to_all", "coalesced", "COLLECTIVE_BYTES", "STAGED_BYTES",
           "reset_counts", "axis_group", "Split", "copy_to", "reduce_from",
           "scatter_to", "gather_from", "reduce_scatter_to", "fsdp_gather",
           "take_block", "join_blocks"]


# payload bytes each collective kind moved in this process, and the
# bytes a gloo group staged through host memory for CUDA tensors
COLLECTIVE_BYTES: Counter = Counter()
STAGED_BYTES = Counter()


def reset_counts():
    COLLECTIVE_BYTES.clear()
    STAGED_BYTES.clear()


def axis_group(attrs):
    """The group of the op's mesh axis (attrs axis_name, else ring_id),
    or None where the op is the identity."""
    from ..parallel.mesh import axis_for_ring, get_mesh, world
    if world()[0] == 1:
        return None
    mesh = get_mesh()
    axis = attrs.get("axis_name") or axis_for_ring(attrs.get("ring_id", 0))
    return mesh.group(axis)


def _backend(group):
    import torch.distributed as dist
    return dist.get_backend(group)


def _count(kind, t):
    n = t.numel() * t.element_size()
    COLLECTIVE_BYTES[kind] += n
    STAT_ADD("parallel.collective_bytes", n)


def _staged(group, fn, out, *inputs):
    """Run fn(out, *inputs) over `group`, the collective writing `out`; a
    gloo group gets host copies of CUDA tensors, and `out` is copied
    back (only `out`: a write into an input would bump the version of a
    tensor autograd saved)."""
    tensors = (out, *inputs)
    if not any(t.is_cuda for t in tensors) or _backend(group) != "gloo":
        return fn(*tensors)
    host = [t.cpu() for t in tensors]
    n = sum(t.numel() * t.element_size() for t in tensors)
    STAGED_BYTES["bytes"] += n
    STAT_ADD("parallel.host_staged_bytes", n)
    fn(*host)
    out.copy_(host[0])


def _size(group):
    import torch.distributed as dist
    return dist.get_world_size(group)


def _rank(group):
    import torch.distributed as dist
    return dist.get_rank(group)


_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "prod": "PRODUCT"}


def all_reduce(x, group, op="sum"):
    """A new tensor: x reduced elementwise over the group."""
    import torch.distributed as dist
    out = x.detach().clone().contiguous()
    _count("all_reduce", out)
    _staged(group, lambda t: dist.all_reduce(
        t, op=getattr(dist.ReduceOp, _OPS[op]), group=group), out)
    return out


def all_gather(x, group):
    """The group's x concatenated on dim 0, in rank order."""
    import torch.distributed as dist
    x = x.detach().contiguous()
    n = _size(group)
    out = x.new_empty((x.shape[0] * n, *x.shape[1:]))
    _count("all_gather", x)
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    _staged(group, lambda o, i: fn(o, i, group=group), out, x)
    return out


def reduce_scatter(x, group):
    """This rank's dim-0 block of the group's sum of x."""
    import torch.distributed as dist
    x = x.detach().contiguous()
    n = _size(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter of dim 0 {x.shape[0]} over "
                         f"{n} ranks: it must divide")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    _count("reduce_scatter", x)
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    _staged(group, lambda o, i: fn(o, i, group=group), out, x)
    return out


def broadcast(x, group, root=0):
    """The root rank's x (root is a rank of the group)."""
    import torch.distributed as dist
    out = x.detach().clone().contiguous()
    _count("broadcast", out)
    src = root if group is None or group is dist.group.WORLD \
        else dist.get_global_rank(group, root)
    _staged(group, lambda t: dist.broadcast(t, src, group=group), out)
    return out


def all_to_all(x, group, split_axis=0, concat_axis=0):
    """Split x on split_axis into one block a rank, exchange, and
    concatenate the received blocks on concat_axis (tiled)."""
    import torch.distributed as dist
    n = _size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all of dim {split_axis} "
                         f"({x.shape[split_axis]}) over {n} ranks: it "
                         f"must divide")
    blocks = torch.stack(torch.chunk(x.detach(), n, dim=split_axis))
    blocks = blocks.contiguous()
    out = torch.empty_like(blocks)
    _count("all_to_all", blocks)
    _staged(group, lambda o, i: dist.all_to_all_single(o, i, group=group),
            out, blocks)
    return torch.cat(list(out.unbind(0)), dim=concat_axis)


def coalesced(tensors, collective, blocks=1):
    """Run `collective` (flat tensor -> flat tensor) once a dtype over
    `tensors` flattened into one buffer; returns, in order, each tensor's
    part of the result as a (result blocks, piece) view.

    The buffer is block-major: each tensor is cut into `blocks` equal
    pieces and block b holds every tensor's piece b, which is what a
    reduce-scatter over `blocks` ranks wants. The result is read the same
    way with as many blocks as it holds: 1 after an all-reduce, a
    broadcast or a reduce-scatter, the group's size after an
    all-gather."""
    parts = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        pieces = [tensors[i].reshape(blocks, -1) for i in idx]
        out = collective(torch.cat([p[b] for b in range(blocks)
                                    for p in pieces]))
        out = out.view(-1, sum(p.shape[1] for p in pieces))
        off = 0
        for i, p in zip(idx, pieces):
            parts[i] = out[:, off:off + p.shape[1]]
            off += p.shape[1]
    return parts


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        out = all_reduce(x, group, op)
        ctx.group, ctx.op = group, op
        if op != "sum":
            ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g, ctx.group, "sum")
        if ctx.op == "sum":
            return total, None, None
        x, out = ctx.saved_tensors
        if ctx.op == "prod":
            return total * out / x, None, None
        return total * (x == out).to(g.dtype), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group), None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, root):
        ctx.group, ctx.root = group, root
        return broadcast(x, group, root)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g, ctx.group, "sum")
        if _rank(ctx.group) != ctx.root:
            total = torch.zeros_like(total)
        return total, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return all_to_all(g, ctx.group, concat_axis, split_axis), \
            None, None, None


def _on_meta(x):
    return x.device.type == "meta"


def _collective(name, apply):
    # NOT inplace: backward differentiates through the collective
    @register_op(name)
    def _low(ctx, ins, attrs, _apply=apply):
        x = ins["X"][0]
        group = None if _on_meta(x) else axis_group(attrs)
        return {"Out": [x if group is None else _apply(x, group, attrs)]}
    return _low


for _op in ("sum", "max", "min", "prod"):
    _collective(f"c_allreduce_{_op}",
                lambda x, g, a, _o=_op: _AllReduce.apply(x, g, _o))
_collective("allreduce", lambda x, g, a: _AllReduce.apply(x, g, "sum"))
_collective("c_allgather", lambda x, g, a: _AllGather.apply(x, g))
_collective("c_reducescatter", lambda x, g, a: _ReduceScatter.apply(x, g))
_collective("c_broadcast",
            lambda x, g, a: _Broadcast.apply(x, g, int(a.get("root", 0))))
_collective("c_alltoall", lambda x, g, a: _AllToAll.apply(
    x, g, int(a.get("split_axis", 0)), int(a.get("concat_axis", 0))))


def _sync(ctx, ins, attrs):
    x = ins["X"][0]
    if x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()
    return {"Out": [x]}


register_op("c_sync_calc_stream")(_sync)
register_op("c_sync_comm_stream")(_sync)


@register_op("c_comm_init")
def _c_comm_init(ctx, ins, attrs):
    return {}


@register_op("c_comm_init_all")
def _c_comm_init_all(ctx, ins, attrs):
    return {}


@register_op("c_gen_nccl_id")
def _c_gen_nccl_id(ctx, ins, attrs):
    # the process group is the bootstrap: nothing to hand-shake
    return {}


def check_shard_hint(spec, mesh=None):
    """A shard_hint spec the port runs: every axis it names is an axis of
    the mesh (the run's, else the registry's)."""
    if mesh is None:
        from ..parallel.mesh import get_mesh
        mesh = get_mesh()
    for dim, axes in enumerate(spec or ()):
        names = axes if isinstance(axes, (list, tuple)) else (axes,)
        for a in names:
            if a is not None and a not in mesh.axis_names:
                raise ValueError(
                    f"shard_hint {list(spec)}: axis {a!r} on dim {dim} is "
                    f"not an axis of the mesh {tuple(mesh.axis_names)}")


@register_op("shard_hint")
def _shard_hint(ctx, ins, attrs):
    """The identity: a model-parallel rank program reshards through the
    op's adapters before this runs (parallel/model_parallel.py)."""
    x = ins["X"][0]
    if not _on_meta(x):
        from ..parallel.mesh import world
        if world()[0] > 1:
            check_shard_hint(attrs.get("spec", []))
    return {"Out": [x]}


# -- the model-parallel rewrite's autograd pairs -----------------------------

class Split(tuple):
    """Where a tensor is split over a mesh axis: dim `k` of its shape is
    (outer, S, inner) with S cut into one block a rank (outer = inner = 1
    for a plain dim split; a reshape that merges the split dim with its
    neighbours keeps them)."""

    def __new__(cls, k, outer=1, inner=1):
        # with nothing outside it, a split's blocks are contiguous runs of
        # the dim whatever lies inside: the plain split of dim k
        if int(outer) == 1:
            inner = 1
        return super().__new__(cls, (int(k), int(outer), int(inner)))

    k = property(lambda self: self[0])
    outer = property(lambda self: self[1])
    inner = property(lambda self: self[2])

    def pure(self):
        return self[1] == 1 and self[2] == 1

    def __repr__(self):
        return f"Split{tuple(self)}"


def _fold(x, sp):
    """x viewed with its split dim as (outer, S, inner): the S axis is
    dim k + 1."""
    k, o, i = sp
    shape = tuple(x.shape)
    return x.reshape(*shape[:k], o, shape[k] // (o * i), i, *shape[k + 1:])


def take_block(x, sp, n, r):
    """Rank r's block of x (global) under split `sp` over n ranks."""
    k = sp[0]
    f = _fold(x, sp)
    s = f.shape[k + 1] // n
    blk = f.narrow(k + 1, r * s, s)
    shape = list(x.shape)
    shape[k] //= n
    return blk.reshape(shape)


def join_blocks(parts, sp):
    """The global tensor from the ranks' blocks (rank order)."""
    k = sp[0]
    f = torch.cat([_fold(p, sp) for p in parts], dim=k + 1)
    shape = list(parts[0].shape)
    shape[k] *= len(parts)
    return f.reshape(shape)


def _gather_blocks(x, sp, group):
    n = _size(group)
    flat = all_gather(x.detach().contiguous().reshape(1, -1), group)
    return join_blocks([p.view(x.shape) for p in flat.unbind(0)], sp) \
        if n > 1 else x.detach().clone()


def _reduce_blocks(x, sp, group):
    n, r = _size(group), _rank(group)
    blocks = torch.stack([take_block(x.detach(), sp, n, j).reshape(-1)
                          for j in range(n)])
    return reduce_scatter(blocks, group).view(
        take_block(x, sp, n, r).shape)


class _CopyTo(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, "sum"), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: all-reduce forward (partial sums), identity
    backward (the sum is used alike on every rank)."""

    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        out = all_reduce(x, group, "sum")
        return out.mul_(scale) if scale != 1.0 else out

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1.0 else g), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sp):
        ctx.group, ctx.sp = group, sp
        return take_block(x, sp, _size(group), _rank(group)).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather_blocks(g, ctx.sp, ctx.group), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sp):
        ctx.group, ctx.sp = group, sp
        return _gather_blocks(x, sp, group)

    @staticmethod
    def backward(ctx, g):
        return take_block(g, ctx.sp, _size(ctx.group),
                          _rank(ctx.group)).contiguous(), None, None


class _ReduceScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sp):
        ctx.group, ctx.sp = group, sp
        return _reduce_blocks(x, sp, group)

    @staticmethod
    def backward(ctx, g):
        return _gather_blocks(g, ctx.sp, ctx.group), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, reduce, scale):
        ctx.group, ctx.reduce, ctx.scale = group, reduce, scale
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            out = reduce_scatter(g, ctx.group)
            return (out.mul_(ctx.scale) if ctx.scale != 1.0 else out), \
                None, None, None
        n, r = _size(ctx.group), _rank(ctx.group)
        rows = g.shape[0] // n
        return g[r * rows:(r + 1) * rows].contiguous(), None, None, None


def copy_to(x, group):
    return _CopyTo.apply(x, group)


def reduce_from(x, group, scale=1.0):
    return _ReduceFrom.apply(x, group, float(scale))


def scatter_to(x, group, sp):
    if not x.is_floating_point():
        return take_block(x, sp, _size(group), _rank(group)).clone()
    return _ScatterTo.apply(x, group, Split(*sp))


def gather_from(x, group, sp):
    if not x.is_floating_point():
        return _gather_blocks(x, sp, group)
    return _GatherFrom.apply(x, group, Split(*sp))


def reduce_scatter_to(x, group, sp):
    return _ReduceScatterTo.apply(x, group, Split(*sp))


def fsdp_gather(x, group, reduce, scale=1.0):
    """A weight's dim-0 shards all-gathered; its gradient reduce-scattered
    and scaled (`reduce`: the ranks computed on different rows), else
    sliced (they computed alike)."""
    return _FsdpGather.apply(x, group, bool(reduce), float(scale))
