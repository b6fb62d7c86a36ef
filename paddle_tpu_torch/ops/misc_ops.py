"""Host I/O ops (save, save_combine, load and load_combine), the
padded index ops (where, unique, unique_with_counts), hash and fsp.

They read and write numpy files on the host, as the JAX package's do:
``save`` writes one ``.npy`` and ``save_combine`` one ``.npz`` (numpy
appends the suffix when the path lacks it), ``load`` and ``load_combine``
read them back in the declared dtype and put the result on the
executor's device. A file written by either package reads in the other.
During build-time shape inference (the meta device) no file is touched:
``load`` gives its declared shape, ``save`` its token.

``save`` and ``save_combine`` return a scalar token (the JAX package's is
uint32, this one int32; both read 0).

``where`` and ``unique*`` keep the JAX package's static-shape contract:
their outputs have the input's element count as their length, padded
past the data-dependent count (-1 rows for ``where``; for ``unique``
+inf or the dtype's max in Out, count 0 in Count), never torch's
dynamic sizes. ``hash`` is XXH64 of each row's little-endian int64
bytes on the host, as the JAX package computes it in a callback.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..core.dtypes import as_np_dtype, as_torch_dtype
from ..core.registry import register_op
from ..core.scope import tensor_to_numpy


def _token(ctx):
    return torch.zeros((), dtype=torch.int32, device=ctx.device)


def _to_device(arr, dtype, ctx, shape=None):
    if shape is not None and all(d >= 0 for d in shape) and \
            tuple(arr.shape) != tuple(shape):
        raise ValueError(f"load: the file holds shape {list(arr.shape)}, "
                         f"the op declares {list(shape)}")
    t = torch.from_numpy(np.ascontiguousarray(arr.astype(as_np_dtype(dtype))))
    return t.to(ctx.device).to(as_torch_dtype(dtype))


def _mkdir_for(path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)


@register_op("save", nondiff_inputs=("X",))
def _save(ctx, ins, attrs):
    if ctx.device.type != "meta":
        path = attrs["file_path"]
        _mkdir_for(path)
        np.save(path, tensor_to_numpy(ins["X"][0]), allow_pickle=False)
    return {"Out": [_token(ctx)]}


@register_op("save_combine", nondiff_inputs=("X",))
def _save_combine(ctx, ins, attrs):
    if ctx.device.type != "meta":
        path = attrs["file_path"]
        names = attrs.get("var_names") or [str(i) for i in
                                           range(len(ins["X"]))]
        _mkdir_for(path)
        np.savez(path, **{n: tensor_to_numpy(x)
                          for n, x in zip(names, ins["X"])})
    return {"Out": [_token(ctx)]}


@register_op("load")
def _load(ctx, ins, attrs):
    shape = tuple(int(s) for s in attrs["shape"])
    dtype = attrs.get("dtype", "float32")
    if ctx.device.type == "meta":
        return {"Out": [torch.empty(shape, dtype=as_torch_dtype(dtype),
                                    device="meta")]}
    path = attrs["file_path"]
    arr = np.load(path if path.endswith(".npy") else path + ".npy")
    return {"Out": [_to_device(arr, dtype, ctx, shape)]}


@register_op("load_combine")
def _load_combine(ctx, ins, attrs):
    shapes = [tuple(int(d) for d in s) for s in attrs["shapes"]]
    dtypes = attrs["dtypes"]
    if ctx.device.type == "meta":
        return {"Out": [torch.empty(s, dtype=as_torch_dtype(d),
                                    device="meta")
                        for s, d in zip(shapes, dtypes)]}
    path = attrs["file_path"]
    with np.load(path if path.endswith(".npz") else path + ".npz") as blob:
        arrs = [blob[n] for n in attrs["var_names"]]
    return {"Out": [_to_device(a, d, ctx, s)
                    for a, d, s in zip(arrs, dtypes, shapes)]}


def where_rows(cond):
    """Indices [cond.numel(), cond.dim()] (int64) of the nonzero
    elements of `cond` in row-major order, then -1 rows."""
    flat = cond.reshape(-1) != 0
    order = torch.argsort((~flat).to(torch.uint8), stable=True)
    taken = torch.where(flat[order], order, -1)
    idx = torch.stack(torch.unravel_index(torch.clamp_min(taken, 0),
                                          cond.shape), dim=1)
    return torch.where((taken >= 0)[:, None], idx, -1)


@register_op("where", nondiff_inputs=("Condition",),
             nondiff_outputs=("Out",))
def _where(ctx, ins, attrs):
    return {"Out": [where_rows(ins["Condition"][0])]}


def _unique_fill(x):
    """The pad of the unique outputs: +inf for floats, True for bools,
    the dtype's max for integers."""
    if x.is_floating_point():
        return float("inf")
    if x.dtype == torch.bool:
        return True
    return torch.iinfo(x.dtype).max


def _unique(x):
    """Sorted unique values of flat `x` padded to its length, the index
    of each element's value, the counts padded with 0."""
    n = x.shape[0]
    if x.device.type == "meta":
        return (torch.empty(n, dtype=x.dtype, device="meta"),
                torch.empty(n, dtype=torch.int64, device="meta"),
                torch.empty(n, dtype=torch.int64, device="meta"))
    u, inv, cnt = torch.unique(x, sorted=True, return_inverse=True,
                               return_counts=True)
    pad = n - u.shape[0]
    u = torch.cat([u, torch.full((pad,), _unique_fill(x), dtype=x.dtype,
                                 device=x.device)])
    cnt = torch.cat([cnt, cnt.new_zeros(pad)])
    return u, inv, cnt


@register_op("unique", nondiff_inputs=("X",), nondiff_outputs=("Out",
                                                               "Index"))
def _unique_op(ctx, ins, attrs):
    u, inv, _ = _unique(ins["X"][0].reshape(-1))
    return {"Out": [u], "Index": [inv]}


@register_op("unique_with_counts", nondiff_inputs=("X",),
             nondiff_outputs=("Out", "Index", "Count"))
def _unique_with_counts(ctx, ins, attrs):
    u, inv, cnt = _unique(ins["X"][0].reshape(-1))
    return {"Out": [u], "Index": [inv], "Count": [cnt]}


# XXH64 (the public spec, github.com/Cyan4973/xxHash) on Python ints
# masked to 64 bits: the JAX package's own copy, bit-exact with the
# xxhash library the reference links
_XXH_MASK = (1 << 64) - 1
_XXH_P1 = 0x9E3779B185EBCA87
_XXH_P2 = 0xC2B2AE3D27D4EB4F
_XXH_P3 = 0x165667B19E3779F9
_XXH_P4 = 0x85EBCA77C2B2AE63
_XXH_P5 = 0x27D4EB2F165667C5


def _rotl64(v, r):
    return ((v << r) | (v >> (64 - r))) & _XXH_MASK


def _xxh_round(acc, lane):
    acc = (acc + lane * _XXH_P2) & _XXH_MASK
    return (_rotl64(acc, 31) * _XXH_P1) & _XXH_MASK


def xxh64(data: bytes, seed: int = 0) -> int:
    n = len(data)
    if n >= 32:
        v1 = (seed + _XXH_P1 + _XXH_P2) & _XXH_MASK
        v2 = (seed + _XXH_P2) & _XXH_MASK
        v3 = seed & _XXH_MASK
        v4 = (seed - _XXH_P1) & _XXH_MASK
        i = 0
        while i <= n - 32:
            lanes = [int.from_bytes(data[i + 8 * k:i + 8 * k + 8],
                                    "little") for k in range(4)]
            v1, v2, v3, v4 = (_xxh_round(v1, lanes[0]),
                              _xxh_round(v2, lanes[1]),
                              _xxh_round(v3, lanes[2]),
                              _xxh_round(v4, lanes[3]))
            i += 32
        h = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12)
             + _rotl64(v4, 18)) & _XXH_MASK
        for v in (v1, v2, v3, v4):
            h = ((h ^ _xxh_round(0, v)) * _XXH_P1 + _XXH_P4) & _XXH_MASK
    else:
        h = (seed + _XXH_P5) & _XXH_MASK
        i = 0
    h = (h + n) & _XXH_MASK
    while i <= n - 8:
        lane = int.from_bytes(data[i:i + 8], "little")
        h = ((_rotl64(h ^ _xxh_round(0, lane), 27) * _XXH_P1)
             + _XXH_P4) & _XXH_MASK
        i += 8
    if i <= n - 4:
        lane = int.from_bytes(data[i:i + 4], "little")
        h = ((_rotl64(h ^ (lane * _XXH_P1 & _XXH_MASK), 23) * _XXH_P2)
             + _XXH_P3) & _XXH_MASK
        i += 4
    while i < n:
        h = (_rotl64(h ^ (data[i] * _XXH_P5 & _XXH_MASK), 11)
             * _XXH_P1) & _XXH_MASK
        i += 1
    h ^= h >> 33
    h = (h * _XXH_P2) & _XXH_MASK
    h ^= h >> 29
    h = (h * _XXH_P3) & _XXH_MASK
    h ^= h >> 32
    return h


@register_op("hash", nondiff_inputs=("X",), nondiff_outputs=("Out",))
def _hash(ctx, ins, attrs):
    """Out[..., j, 0] = XXH64(the row's int64 bytes, seed j) % mod_by, in
    X's dtype, for j < num_hash. torch has no uint64 arithmetic, so the
    rows go to the host and the result comes back to X's device. mod_by
    above 2**31 raises, as in the JAX package (its int32 carrier)."""
    x = ins["X"][0]
    num_hash = attrs.get("num_hash", 1)
    mod_by = attrs.get("mod_by", 100000)
    if mod_by > (1 << 31):
        raise NotImplementedError(
            f"hash: mod_by {mod_by} exceeds the int32 bucket range "
            f"supported by this lowering (2**31)")
    shape = tuple(x.shape[:-1]) + (num_hash, 1)
    if x.device.type == "meta":
        return {"Out": [torch.empty(shape, dtype=x.dtype, device="meta")]}
    rows = tensor_to_numpy(x).reshape(-1, x.shape[-1]).astype("<i8")
    out = np.array([[xxh64(r.tobytes(), h) % mod_by
                     for h in range(num_hash)] for r in rows],
                   dtype=np.int64).reshape(shape)
    return {"Out": [torch.from_numpy(out).to(device=x.device,
                                             dtype=x.dtype)]}


@register_op("fsp")
def _fsp(ctx, ins, attrs):
    """The Gram matrix [b, c1, c2] of two feature maps over their
    spatial positions, over their count."""
    x, y = ins["X"][0], ins["Y"][0]
    b, c1, c2 = x.shape[0], x.shape[1], y.shape[1]
    hw = math.prod(x.shape[2:])
    return {"Out": [torch.einsum("bch,bdh->bcd", x.reshape(b, c1, hw),
                                 y.reshape(b, c2, hw)) / hw]}
