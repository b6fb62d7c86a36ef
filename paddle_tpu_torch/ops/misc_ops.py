"""Host I/O ops: save, save_combine, load and load_combine.

They read and write numpy files on the host, as the JAX package's do:
``save`` writes one ``.npy`` and ``save_combine`` one ``.npz`` (numpy
appends the suffix when the path lacks it), ``load`` and ``load_combine``
read them back in the declared dtype and put the result on the
executor's device. A file written by either package reads in the other.
During build-time shape inference (the meta device) no file is touched:
``load`` gives its declared shape, ``save`` its token.

``save`` and ``save_combine`` return a scalar token (the JAX package's is
uint32, this one int32; both read 0).
"""
from __future__ import annotations

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
