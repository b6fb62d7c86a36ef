"""Pipeline parallelism: the GPipe schedule over a `pp` mesh axis, and
SectionPipeline.

Reference analogue: PipelineOptimizer (optimizer.py:3020) cuts a Program
into sections streamed through ScopeQueues by PipelineTrainer /
SectionWorker threads. The JAX package runs the GPipe schedule as one
SPMD program: a `lax.scan` over the microbatch clock inside shard_map,
activations moved stage to stage by `lax.ppermute`, and jax.grad
transposes it into the mirrored backward pipeline.

The port runs one process per rank, so each rank of the `pp` group is
one stage and runs the same clock of n_micro + n_stages - 1 ticks:

- at tick t stage i works on microbatch m = t - i: stage 0 takes
  microbatch t of the input, stage i > 0 receives stage i-1's output of
  tick t-1, and every stage but the last sends its output on to i+1;
  the last stage keeps microbatch t - (n_stages - 1);
- the whole clock is ONE torch.autograd.Function (`_GPipe`). Its
  forward keeps each microbatch's stage graph; its backward runs the
  mirrored clock in reverse: receive dy from i+1, `torch.autograd.grad`
  through the stage, send dx to i-1, add up the parameter gradients.
  A send/recv Function a tick would leave stage 0's backward unreached
  (it never uses what it receives, and only the last stage feeds the
  loss), and gloo's matched send/recv would deadlock;
- the output is made replicated over `pp` by a broadcast from the last
  stage, returned [batch, ...] on every rank. Its backward hands the
  last stage its own dL/dout once: every rank computes the same loss
  from the same replicated output, so a sum over the ranks (the
  transpose of the JAX package's psum(outputs * mask) taken literally)
  would count it n_stages times;
- deliberate difference: the JAX scan computes every stage on every
  tick, garbage in the bubbles; the port skips the bubble ticks, so a
  rank calls `stage_fn` n_micro times a step, not n_micro + n_stages - 1;
- `stage_fn` may run collectives over another axis of the mesh (the
  Megatron f/g pairs of ops/collective.py over `tp`): they run inside
  the stage's graph, over that axis's group, in the same order on every
  rank of it, forward and backward;
- each rank holds the gradient of its own stage's slice of the stacked
  parameters (the other slices' gradients are zero): the JAX package's
  gradient of a `pp`-sharded array holds stage i's part on the devices
  of stage i. The input's gradient is broadcast from stage 0, so a
  replicated input gets the same gradient on every rank.

A gloo group moves a CUDA activation through host memory; the bytes are
counted in ops/collective.STAGED_BYTES, the payload in
COLLECTIVE_BYTES["p2p"]. Without a process group (or with one stage) the
stages run in sequence in this process.

SectionPipeline (heterogeneous sections, one process) runs each
microbatch through the sections in order and accumulates the mean loss
and the gradients over the microbatches.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops import collective as coll
from .mesh import get_mesh

__all__ = ["gpipe", "stack_stage_params", "SectionPipeline",
           "STAGE_CALLS"]

# stage_fn calls this process made inside gpipe (the bubble-skip count)
STAGE_CALLS = {"calls": 0}


def _tree_map(fn, *trees):
    """fn over the leaves of nested dicts / lists / tuples."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def stack_stage_params(params_list):
    """Stack per-stage parameter trees (dicts of tensors or numpy
    arrays) along a new leading stage dim:
    [{'w': [d, d]}] * n_stages -> {'w': [n_stages, d, d]}, the layout
    gpipe expects."""
    return _tree_map(lambda *xs: torch.stack([torch.as_tensor(x)
                                              for x in xs]),
                     *params_list)


def _peer(group, r):
    import torch.distributed as dist
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def _staged(t, group):
    import torch.distributed as dist
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _send(t, group, r):
    """Start sending `t` to rank r of `group`; returns the request and
    the buffer it reads (kept alive until the request is waited)."""
    import torch.distributed as dist
    t = t.detach().contiguous()
    if _staged(t, group):
        t = t.cpu()
        coll.STAGED_BYTES["bytes"] += t.numel() * t.element_size()
    coll.COLLECTIVE_BYTES["p2p"] += t.numel() * t.element_size()
    return dist.isend(t, _peer(group, r), group=group), t


def _recv(like, group, r):
    """A tensor shaped and typed as `like`, received from rank r."""
    import torch.distributed as dist
    staged = _staged(like, group)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if staged else like.device)
    dist.recv(buf, _peer(group, r), group=group)
    if staged:
        coll.STAGED_BYTES["bytes"] += buf.numel() * buf.element_size()
        buf = buf.to(like.device)
    return buf


def _call_stage(stage_fn, params, h, dtype):
    STAGE_CALLS["calls"] += 1
    return stage_fn(params, h).to(dtype)


class _GPipe(torch.autograd.Function):
    """The whole microbatch clock of one stage: forward and the mirrored
    backward (module docstring)."""

    @staticmethod
    def forward(ctx, stage_fn, tree, group, n_stages, idx, x_mb,
                *params):
        n_micro = x_mb.shape[0]
        local = [p.detach().requires_grad_(p.requires_grad)
                 for p in params]
        tree_p = _unflatten(tree, local)
        want_dx = idx > 0 or x_mb.requires_grad
        last = idx == n_stages - 1
        saved, outs, pending = [], [None] * n_micro, []
        with torch.enable_grad():
            for t in range(n_micro + n_stages - 1):
                m = t - idx
                if not 0 <= m < n_micro:
                    continue  # a bubble tick: nothing to compute
                inp = x_mb[m] if idx == 0 else \
                    _recv(x_mb[0], group, idx - 1)
                inp = inp.detach().requires_grad_(want_dx)
                y = _call_stage(stage_fn, tree_p, inp, x_mb.dtype)
                saved.append((inp, y))
                if last:
                    outs[m] = y.detach()
                else:
                    pending.append(_send(y, group, idx + 1))
        for req, _ in pending:
            req.wait()
        out = torch.stack(outs) if last else torch.empty_like(x_mb)
        out = coll.broadcast(out, group, n_stages - 1)
        ctx.saved, ctx.local = saved, local
        ctx.group, ctx.n_stages, ctx.idx = group, n_stages, idx
        ctx.x_req = x_mb.requires_grad
        ctx.like = x_mb[0]
        return out

    @staticmethod
    def backward(ctx, dout):
        group, n_stages, idx = ctx.group, ctx.n_stages, ctx.idx
        n_micro = len(ctx.saved)
        last = idx == n_stages - 1
        grads = [None] * len(ctx.local)
        dx = [None] * n_micro
        pending = []
        with_grad = [p for p in ctx.local if p.requires_grad]
        for m in reversed(range(n_micro)):
            inp, y = ctx.saved[m]
            dy = dout[m] if last else _recv(ctx.like, group, idx + 1)
            wrt = ([inp] if inp.requires_grad else []) + with_grad
            got = torch.autograd.grad(y, wrt, dy.to(y.dtype),
                                      allow_unused=True)
            if inp.requires_grad:
                g_in, got = got[0], got[1:]
                g_in = torch.zeros_like(inp) if g_in is None else g_in
                if idx > 0:
                    pending.append(_send(g_in, group, idx - 1))
                else:
                    dx[m] = g_in
            it = iter(got)
            for k, p in enumerate(ctx.local):
                if not p.requires_grad:
                    continue
                g = next(it)
                if g is not None:
                    grads[k] = g if grads[k] is None else grads[k] + g
        for req, _ in pending:
            req.wait()
        d_x = None
        if ctx.x_req:
            d_x = torch.stack(dx) if idx == 0 else \
                torch.empty((n_micro, *ctx.like.shape),
                            dtype=ctx.like.dtype, device=ctx.like.device)
            d_x = coll.broadcast(d_x, group, 0)
        ctx.saved = None
        return (None, None, None, None, None, d_x, *grads)


def _sequential(stage_fn, stacked, x_mb, n_stages):
    outs = []
    for m in range(x_mb.shape[0]):
        h = x_mb[m]
        for i in range(n_stages):
            STAGE_CALLS["calls"] += 1
            h = stage_fn(_tree_map(lambda a: a[i], stacked), h).to(
                x_mb.dtype)
        outs.append(h)
    return torch.stack(outs)


def gpipe(stage_fn: Callable, stacked_params, x, *, n_microbatches: int,
          mesh=None, axis: str = "pp"):
    """Run ``n_stages`` copies of ``stage_fn`` as a pipeline over
    ``axis``, one stage a rank of the axis's group.

    stage_fn(stage_params, acts) -> acts (shape and dtype of acts kept)
    stacked_params: a tree with leading dim n_stages
    (stack_stage_params); this rank takes stacked[axis_index].
    x: [batch, ...] global input, the same on every rank of the axis;
    batch must divide by n_microbatches. Returns [batch, ...] on every
    rank; differentiable in x and the stacked parameters."""
    mesh = mesh or get_mesh()
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    n_stages = int(mesh.shape[axis])
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} % n_microbatches {n_microbatches}")
    x_mb = x.reshape(n_microbatches, batch // n_microbatches,
                     *x.shape[1:])
    group = mesh.group(axis)
    if group is None:
        out = _sequential(stage_fn, stacked_params, x_mb, n_stages)
    else:
        idx = mesh.axis_index(axis)
        local = _tree_map(lambda a: a[idx], stacked_params)
        out = _GPipe.apply(stage_fn, local, group, n_stages, idx, x_mb,
                           *_leaves(local))
    return out.reshape(batch, *out.shape[2:])


class SectionPipeline:
    """Heterogeneous sections in one process: the reference's
    PipelineOptimizer semantics (sections in order per microbatch,
    gradients accumulated over the microbatches)."""

    def __init__(self, section_fns, n_microbatches: int):
        self.sections = list(section_fns)
        self.n_microbatches = n_microbatches

    def _check_batch(self, x):
        if x.shape[0] % self.n_microbatches:
            raise ValueError(f"batch {x.shape[0]} % n_microbatches "
                             f"{self.n_microbatches}")

    def _run(self, params_per_section, h):
        for fn, p in zip(self.sections, params_per_section):
            h = fn(p, h)
        return h

    def forward(self, params_per_section, x):
        self._check_batch(x)
        return torch.cat([self._run(params_per_section, mb)
                          for mb in torch.chunk(x, self.n_microbatches)])

    def grad(self, loss_fn, params_per_section, x, y):
        """(mean loss over the microbatches, the gradients of
        `params_per_section` averaged over them, in its structure)."""
        self._check_batch(x)
        leaves = [torch.as_tensor(p).detach().requires_grad_(True)
                  for p in _leaves(params_per_section)]
        params = _unflatten(params_per_section, leaves)
        k = self.n_microbatches
        loss_acc = None
        acc = [torch.zeros_like(p) for p in leaves]
        for xb, yb in zip(torch.chunk(x, k), torch.chunk(y, k)):
            loss = loss_fn(self._run(params, xb), yb)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            for a, g in zip(acc, gs):
                if g is not None:
                    a.add_(g)
            loss = loss.detach()
            loss_acc = loss if loss_acc is None else loss_acc + loss
        return loss_acc / k, _unflatten(params_per_section,
                                        [a / k for a in acc])
