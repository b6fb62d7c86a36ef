"""LoDTensor: a host-side numpy buffer with level-of-detail offsets.

A ragged batch is its rows' steps concatenated ([sum of lengths, ...])
plus the offsets of each row (``lod()``). On the device it is always
dense: the executor pads it to [B, T, ...] (``to_padded``) and feeds the
lengths to the var's companion, which the sequence ops mask by
(ops/sequence_ops.py). The API is Fluid's: set_lod / lod /
recursive_sequence_lengths.
"""
from __future__ import annotations

import numpy as np


class LoDTensor:
    def __init__(self, data=None, lod=None):
        self._data = np.asarray(data) if data is not None else None
        self._lod = [list(level) for level in (lod or [])]

    # -- fluid API -------------------------------------------------------
    def set(self, data, place=None):
        self._data = np.asarray(data)

    def set_lod(self, lod):
        self._lod = [list(level) for level in lod]

    def lod(self):
        return self._lod

    def set_recursive_sequence_lengths(self, lengths):
        self._lod = []
        for level in lengths:
            offsets = [0]
            for n in level:
                offsets.append(offsets[-1] + n)
            self._lod.append(offsets)

    def recursive_sequence_lengths(self):
        out = []
        for level in self._lod:
            out.append([level[i + 1] - level[i]
                        for i in range(len(level) - 1)])
        return out

    def has_valid_recursive_sequence_lengths(self):
        for level in self._lod:
            if any(level[i] > level[i + 1] for i in range(len(level) - 1)):
                return False
        return True

    def shape(self):
        return list(self._data.shape)

    def numpy_value(self):
        return self._data

    def __array__(self, dtype=None):
        return self._data if dtype is None else self._data.astype(dtype)

    def to_padded(self, pad_value=0.0, multiple=1):
        """(padded [B, T, ...], lengths [B]) of the last LoD level, or
        (data, None) without LoD. multiple > 1 rounds T up (the executor
        uses 8): the sequence ops mask by lengths, so extra padding
        changes no result, and batches whose longest row varies reuse a
        few shapes."""
        if not self._lod:
            return self._data, None
        level = self._lod[-1]
        lengths = np.asarray([level[i + 1] - level[i]
                              for i in range(len(level) - 1)])
        maxlen = int(lengths.max()) if len(lengths) else 0
        if multiple > 1 and maxlen % multiple:
            maxlen += multiple - maxlen % multiple
        feat = self._data.shape[1:]
        out = np.full((len(lengths), maxlen) + feat, pad_value,
                      self._data.dtype)
        for i in range(len(lengths)):
            out[i, :lengths[i]] = self._data[level[i]:level[i + 1]]
        return out, lengths

    @staticmethod
    def from_ragged(rows, dtype="float32"):
        data = np.concatenate([np.asarray(r, dtype) for r in rows], axis=0)
        t = LoDTensor(data)
        t.set_recursive_sequence_lengths([[len(r) for r in rows]])
        return t


class LoDTensorArray(list):
    """A list of LoDTensors."""
