"""layers.io — data declaration."""
from __future__ import annotations

from ..framework import default_main_program

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=None, stop_gradient=True):
    """Declare a feed variable. append_batch_size=True prepends a dynamic
    batch dim (-1). Ragged (lod_level > 0) data is not ported yet."""
    if lod_level:
        raise NotImplementedError(
            "data(lod_level>0): ragged feeds are not ported yet")
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    blk = default_main_program().global_block()
    if blk.has_var(name):
        return blk.var(name)
    return blk.create_var(name=name, shape=shape, dtype=dtype,
                          lod_level=lod_level, stop_gradient=stop_gradient,
                          is_data=True)
