"""Expert parallelism: a switch-style MoE FFN split over the `ep` mesh
axis.

Expert weights are held split on dim 0 over `ep` (a rank holds E/ep
experts). Gating is top-1 (Switch Transformer, arxiv 2101.03961): the
chosen expert's output is scaled by its softmax probability, so the
router learns through that factor while the choice is a mask with no
gradient. Two formulations, as in the JAX package:

- dense: every rank runs its experts over every token and the outputs
  are summed over `ep` (Megatron's g: an all-reduce whose gradient is
  the identity, since the sum is used alike on every rank); exact;
- sparse: tokens are packed into per-expert buffers of `capacity` slots
  and exchanged with two all-to-alls, so an expert computes only the
  tokens routed to it. A token's slot is its position among all the
  tokens routed to its expert (as the JAX package counts it, where every
  shard routes every token); a token past the capacity is dropped and
  its output is exactly 0. Each rank dispatches the tokens of its own
  block of rows, so each kept token reaches its expert once, and the
  outputs are gathered whole. Equal to the dense formulation when
  nothing is dropped.

A mesh without the `ep` axis runs the single-device dense evaluation
with the same routing.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register_op
from ..ops import collective as coll
from ..ops.collective import Split

__all__ = ["init_moe_params", "moe_ffn", "moe_ffn_sparse",
           "moe_ffn_sharded", "moe_ffn_sparse_sharded", "moe_ffn_dense"]


def init_moe_params(rng, n_experts, d_model, d_ff, dtype=torch.float32,
                    device="cpu"):
    """{gate_w [d, E], w1 [E, d, f], b1 [E, f], w2 [E, f, d], b2 [E, d]},
    drawn as the JAX package draws them (numpy RandomState(rng))."""
    r = np.random.RandomState(rng)
    s1 = (2.0 / d_model) ** 0.5
    s2 = (2.0 / d_ff) ** 0.5
    arrays = {
        "gate_w": r.randn(d_model, n_experts).astype(np.float32) * 0.02,
        "w1": r.randn(n_experts, d_model, d_ff).astype(np.float32) * s1,
        "b1": np.zeros((n_experts, d_ff), np.float32),
        "w2": r.randn(n_experts, d_ff, d_model).astype(np.float32) * s2,
        "b2": np.zeros((n_experts, d_model), np.float32),
    }
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in arrays.items()}


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def _route_top1(x, gate_w):
    """(probs, coef = prob on the chosen expert, load = mean top-1
    prob) of x [.., d]."""
    probs = torch.softmax(x @ gate_w, dim=-1)
    mask = F.one_hot(probs.argmax(-1), probs.shape[-1]).to(probs.dtype)
    coef = probs * mask.detach()
    return probs, coef, probs.max(-1).values.mean()


def _expert_eval_all(x, p):
    """Every expert of `p` over every token: [B, E, T, d]."""
    h = _gelu(torch.einsum("btd,edf->betf", x, p["w1"])
              + p["b1"][None, :, None, :])
    return torch.einsum("betf,efd->betd", h, p["w2"]) + \
        p["b2"][None, :, None, :]


def moe_ffn_dense(x, params):
    """The single-device evaluation: (y [B, T, d], load)."""
    _, coef, load = _route_top1(x, params["gate_w"])
    y = torch.einsum("betd,bte->btd", _expert_eval_all(x, params), coef)
    return y, load


def moe_ffn(x, params, group):
    """Dense formulation on this rank of `group`: `params`' expert
    arrays hold its experts [E_local, ...], gate_w is whole. x [B, T, d]
    is whole on every rank. Returns (y summed over the group, load)."""
    import torch.distributed as dist
    r = dist.get_rank(group)
    x = coll.copy_to(x, group)
    gate_w = coll.copy_to(params["gate_w"], group)
    e_local = params["w1"].shape[0]
    _, coef, load = _route_top1(x, gate_w)
    coef_local = coef[..., r * e_local:(r + 1) * e_local]
    y = torch.einsum("betd,bte->btd", _expert_eval_all(x, params),
                     coef_local)
    return coll.reduce_from(y, group), load


def moe_ffn_sparse(x, params, group, capacity=None):
    """Capacity-based dispatch on this rank of `group` (see the module
    doc); x [B, T, d] whole on every rank. Returns (y, load)."""
    import torch.distributed as dist
    n, r = dist.get_world_size(group), dist.get_rank(group)
    b, t, d = x.shape
    tokens = b * t
    e_local = params["w1"].shape[0]
    e = e_local * n
    if capacity is None:
        capacity = max(1, (2 * tokens + e - 1) // e)
    if tokens % n:
        raise ValueError(f"moe_ffn sparse: {tokens} tokens do not split "
                         f"over {n} ranks")
    xt = coll.copy_to(x, group).reshape(tokens, d)
    gate_w = coll.copy_to(params["gate_w"], group)
    probs = torch.softmax(xt @ gate_w, dim=-1)
    top = probs.argmax(-1)
    coef = probs.gather(1, top[:, None])[:, 0]
    onehot = F.one_hot(top, e)
    pos = ((onehot.cumsum(0) * onehot) - 1).max(-1).values
    keep = pos < capacity
    rows = tokens // n
    own = torch.zeros_like(keep)
    own[r * rows:(r + 1) * rows] = True
    send = keep & own
    idx = send.nonzero()[:, 0]
    disp = xt.new_zeros((e, capacity, d))
    disp = disp.index_put((top[idx], pos[idx]), xt[idx])
    recv = coll._AllToAll.apply(disp.reshape(n, e_local, capacity, d),
                                group, 0, 2)
    recv = recv.reshape(e_local, n * capacity, d)
    h = _gelu(torch.einsum("ecd,edf->ecf", recv, params["w1"])
              + params["b1"][:, None, :])
    out = torch.einsum("ecf,efd->ecd", h, params["w2"]) + \
        params["b2"][:, None, :]
    back = coll._AllToAll.apply(out.reshape(e_local, n, capacity, d),
                                group, 1, 0).reshape(e, capacity, d)
    mine = slice(r * rows, (r + 1) * rows)
    safe_e = torch.where(keep, top, torch.zeros_like(top))[mine]
    safe_p = torch.where(keep, pos, torch.zeros_like(pos))[mine]
    y = back[safe_e, safe_p] * coef[mine, None]
    y = torch.where(keep[mine, None], y, torch.zeros_like(y))
    y = coll.gather_from(y, group, Split(0))
    return y.reshape(b, t, d), probs.max(-1).values.mean()


def _local_experts(params, group, local):
    """The expert arrays of this rank: `params` as they are when they
    already hold its experts, else its block of the whole arrays."""
    if local:
        return params
    out = dict(params)
    for k in ("w1", "b1", "w2", "b2"):
        out[k] = coll.scatter_to(params[k], group, Split(0))
    return out


def moe_ffn_sharded(x, params, mesh, ep_axis="ep", batch_axis=None,
                    seq_axis=None):
    """Whole arrays on every rank -> the dense formulation over the
    mesh's ep axis; (y whole, load)."""
    group = mesh.group(ep_axis)
    if group is None:
        return moe_ffn_dense(x, params)
    return moe_ffn(x, _local_experts(params, group, False), group)


def moe_ffn_sparse_sharded(x, params, mesh, ep_axis="ep", capacity=None,
                           batch_axis=None, seq_axis=None):
    """Whole arrays on every rank -> the sparse formulation over the
    mesh's ep axis; (y whole, load)."""
    group = mesh.group(ep_axis)
    if group is None:
        return moe_ffn_dense(x, params)
    return moe_ffn_sparse(x, _local_experts(params, group, False), group,
                          capacity)


@register_op("moe_ffn", nondiff_outputs=("Load",))
def _moe_ffn_op(ctx, ins, attrs):
    """Inputs X [B, T, d], GateW [d, E], W1 [E, d, f], B1 [E, f],
    W2 [E, f, d], B2 [E, d]. On a mesh with the `ep` axis the dense (or,
    with a capacity, the sparse) formulation runs; elsewhere the
    single-device dense evaluation."""
    from .mesh import get_mesh, world
    x = ins["X"][0]
    params = {"gate_w": ins["GateW"][0], "w1": ins["W1"][0],
              "b1": ins["B1"][0], "w2": ins["W2"][0], "b2": ins["B2"][0]}
    ep_axis = attrs.get("ep_axis", "ep")
    if x.device.type == "meta":
        return {"Out": [torch.empty_like(x)],
                "Load": [torch.empty((), dtype=torch.float32,
                                     device="meta")]}
    mesh = get_mesh()
    group = mesh.group(ep_axis) if world()[0] > 1 and \
        ep_axis in mesh.axis_names else None
    if group is None:
        y, load = moe_ffn_dense(x, params)
        return {"Out": [y], "Load": [load.float()]}
    local = bool(getattr(ctx, "mp", {}).get("experts_local"))
    params = _local_experts(params, group, local)
    if attrs.get("capacity"):
        y, load = moe_ffn_sparse(x, params, group, int(attrs["capacity"]))
    else:
        y, load = moe_ffn(x, params, group)
    batch_axis = attrs.get("batch_axis", "dp")
    bgroup = mesh.group(batch_axis) if batch_axis in mesh.axis_names \
        else None
    if bgroup is not None:
        # the metric is global: averaged over the batch's ranks too
        load = coll.all_reduce(load.detach(), bgroup) / \
            mesh.shape[batch_axis]
    return {"Out": [y], "Load": [load.float()]}
