"""DataFeeder: minibatch rows -> feed dict.

A dense field of the rows is stacked into one numpy array in its var's
dtype, and reshaped to the var's declared shape when the element counts
match (a flat 784-value MNIST image fed to a [1, 28, 28] var). A ragged
(lod_level > 0) field becomes a LoDTensor of its rows, which the
executor pads and whose lengths it feeds to the var's companion. The
batches stay numpy; the executor moves them to the card and casts a
bfloat16 var's float32 batch (numpy has no bfloat16).
"""
from __future__ import annotations

import numpy as np

from .core.dtypes import as_np_dtype
from .core.lod import LoDTensor

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_vars = []
        for v in feed_list:
            if isinstance(v, str):
                from .framework import default_main_program
                v = (program or default_main_program()).global_block().var(v)
            self.feed_vars.append(v)
        self.place = place

    def feed(self, iterable):
        """iterable: list of tuples, one per example, fields aligned with
        feed_list. Ragged (lod_level > 0) fields become LoDTensors."""
        columns = list(zip(*iterable))
        out = {}
        for var, col in zip(self.feed_vars, columns):
            dtype = as_np_dtype(var.dtype)
            if var.lod_level > 0:
                out[var.name] = LoDTensor.from_ragged(col, dtype)
                continue
            arrs = [np.asarray(c, dtype=dtype) for c in col]
            batch = np.stack(arrs, axis=0)
            want = [d for d in (var.shape or []) if d != -1]
            if want and list(batch.shape[1:]) != want and \
                    int(np.prod(batch.shape[1:])) == int(np.prod(want)):
                batch = batch.reshape([batch.shape[0]] + want)
            out[var.name] = batch
        return out
