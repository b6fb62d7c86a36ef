"""Vision ops beyond the bench models' set: conv3d_transpose (and the
transposed convolution conv2d_transpose shares), pool3d,
max_pool3d_with_index, grid_sampler, spectral_norm and tree_conv. Plain
torch: cuDNN's transposed convolutions and torch's pooling and grid
sampling on the card, and the reference's matrix formulation of the
tree convolution."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register_op


def conv_transpose(x, w, attrs, nd):
    """Transposed convolution over `nd` spatial axes, filter [C_in,
    C_out/groups, k...] (torch's layout and the reference's).
    `output_padding` (each entry below its stride) widens the bottom and
    right edge: any output size in [natural, natural + stride). The
    output keeps the input's dtype."""
    fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    ones, zeros = [1] * nd, [0] * nd
    out = fn(x, w, stride=tuple(attrs.get("strides", ones)),
             padding=tuple(attrs.get("paddings", zeros)),
             output_padding=tuple(attrs.get("output_padding") or zeros),
             groups=attrs.get("groups", 1),
             dilation=tuple(attrs.get("dilations") or ones))
    return out.to(x.dtype)


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs):
    return {"Output": [conv_transpose(ins["Input"][0], ins["Filter"][0],
                                      attrs, 3)]}


@register_op("spectral_norm")
def _spectral_norm(ctx, ins, attrs):
    """Weight / sigma_max, sigma estimated by `power_iters` power
    iterations (at least one) started from the U and V inputs; the
    gradient runs through the iterations, as the reference's vjp of its
    scan does."""
    w = ins["Weight"][0]
    u = ins["U"][0].reshape(-1)
    v = ins["V"][0].reshape(-1)
    dim = attrs.get("dim", 0)
    eps = attrs.get("eps", 1e-12)
    wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    # the first iteration overwrites V, so its gradient is 0; the
    # reference's vjp still gives it that 0, and so does this term
    start = 0.0 * v
    for i in range(max(attrs.get("power_iters", 1), 1)):
        v = wm.t() @ u
        if i == 0:
            v = v + start
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = wm @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ (wm @ v)
    return {"Out": [w / sigma]}


@register_op("tree_conv")
def _tree_conv(ctx, ins, attrs):
    """TBCNN continuous binary tree convolution, as the reference writes
    it: for each node u the patch is u's subtree to relative depth below
    `max_depth`, each member v weighted by the (eta_l, eta_r, eta_t)
    position weights; out[u] = patch @ Filter [F, 3, out, nf]. Depth
    levels are powers of the child-adjacency matrix, sibling index and
    count come from one-hot products over the edge list, and the edge
    list ends at its first pair with a 0. NodesVector [B, N, F], EdgeSet
    [B, E, 2] of 1-based node ids."""
    nodes = ins["NodesVector"][0]
    edges = ins["EdgeSet"][0].long()
    w = ins["Filter"][0]
    md = int(attrs.get("max_depth", 8))
    n = nodes.shape[1]
    fdim, _, osz, nf = w.shape
    e_len = edges.shape[1]
    cd, dev = nodes.dtype, nodes.device
    ids = torch.arange(n, device=dev)
    eye = torch.eye(n, dtype=cd, device=dev)
    before = torch.tril(torch.ones((e_len, e_len), dtype=cd, device=dev),
                        -1)
    w2 = w.reshape(fdim, 3, osz * nf)
    outs = []
    for feat, ed in zip(nodes, edges):
        u, v = ed[:, 0], ed[:, 1]
        valid = torch.cumprod(((u != 0) & (v != 0)).long(), 0) == 1
        node_count = valid.sum() + 1
        # one-hot rows of the 0-based ids; an invalid edge's row is 0
        uh = (ids[None, :] == torch.where(valid, u - 1, -1)[:, None]).to(cd)
        vh = (ids[None, :] == torch.where(valid, v - 1, -1)[:, None]).to(cd)
        adj = uh.t() @ vh
        same_parent = uh @ uh.t()
        idx_e = torch.sum(same_parent * before, dim=1) + 1.0
        pclen_e = torch.sum(same_parent, dim=1)
        vf = valid.to(cd)
        idx_n = vh.t() @ (idx_e * vf)
        pclen_n = vh.t() @ (pclen_e * vf)
        temp = torch.where(pclen_n == 1.0, 0.5, (idx_n - 1.0) /
                           torch.clamp_min(pclen_n - 1.0, 1.0))
        p = eye
        wl = torch.zeros((n, n), dtype=cd, device=dev)
        wr = torch.zeros((n, n), dtype=cd, device=dev)
        wt = eye
        for k in range(1, max(md, 1)):
            p = p @ adj
            eta_t = (md - k) / md
            eta_l = (1.0 - eta_t) * temp
            eta_r = (1.0 - eta_t) * (1.0 - eta_l)
            wl = wl + p * eta_l[None, :]
            wr = wr + p * eta_r[None, :]
            wt = wt + p * eta_t
        active = (ids < node_count).to(cd)[:, None]
        out = ((wl @ feat) @ w2[:, 0] + (wr @ feat) @ w2[:, 1]
               + (wt @ feat) @ w2[:, 2]) * active
        outs.append(out.reshape(n, osz, nf))
    return {"Out": [torch.stack(outs)]}


@register_op("pool3d")
def _pool3d(ctx, ins, attrs):
    """Max or average pooling over NCDHW. Strides default to 2; an
    exclusive average divides by the count of unpadded elements; an
    adaptive pool (`ksize` the output size) needs divisible sizes, and
    `ceil_mode` an exact division, or it raises, as in the JAX package."""
    x = ins["X"][0]
    ksize = list(attrs.get("ksize", [2, 2, 2]))
    strides = list(attrs.get("strides", [2, 2, 2]))
    pads = list(attrs.get("paddings", [0, 0, 0]))
    ptype = attrs.get("pooling_type", "max")
    spatial = list(x.shape[2:])
    if attrs.get("ceil_mode", False):
        for s, k, st, p in zip(spatial, ksize, strides, pads):
            if (s + 2 * p - k) % st:
                raise NotImplementedError(
                    "pool3d ceil_mode=True with non-exact division is "
                    "not supported; pad the input or adjust ksize/strides")
    if attrs.get("adaptive", False):
        for s, o in zip(spatial, ksize):
            if s % o:
                raise NotImplementedError(
                    f"adaptive pool3d needs input sizes {tuple(spatial)} "
                    f"divisible by the output size {tuple(ksize)}")
        ksize = strides = [s // o for s, o in zip(spatial, ksize)]
        pads = [0, 0, 0]
    if attrs.get("global_pooling", False):
        red = torch.amax if ptype == "max" else torch.mean
        return {"Out": [red(x, dim=(2, 3, 4), keepdim=True)]}
    if ptype == "max":
        return {"Out": [F.max_pool3d(x, ksize, strides, pads)]}
    return {"Out": [F.avg_pool3d(
        x, ksize, strides, pads,
        count_include_pad=not attrs.get("exclusive", True))]}


@register_op("max_pool3d_with_index", nondiff_outputs=("Mask",))
def _max_pool3d_with_index(ctx, ins, attrs):
    """Max pooling and each window's winner as its (d * H + h) * W + w
    index in the unpadded input (int32), the first of tied maxima;
    strides default to 1."""
    out, idx = F.max_pool3d(
        ins["X"][0], tuple(attrs.get("ksize", [2, 2, 2])),
        tuple(attrs.get("strides", [1, 1, 1])),
        tuple(attrs.get("paddings", [0, 0, 0])), return_indices=True)
    return {"Out": [out], "Mask": [idx.to(torch.int32)]}


@register_op("grid_sampler")
def _grid_sampler(ctx, ins, attrs):
    """Bilinear samples of X [N, C, H, W] at Grid [N, H', W', 2] (x, y in
    [-1, 1], the corners' centres at the ends), zero outside."""
    return {"Output": [F.grid_sample(ins["X"][0], ins["Grid"][0],
                                     mode="bilinear", padding_mode="zeros",
                                     align_corners=True)]}
