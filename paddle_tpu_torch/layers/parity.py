"""layers.parity — the dense layers of the JAX package's layers/parity.py:
pool3d, adaptive_pool3d and unique_with_counts (the rest waits for
ROADMAP §A8)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["pool3d", "adaptive_pool3d", "unique_with_counts"]


def _one_out(op_type, inputs, attrs=None, dtype=None, ref=None, name=None,
             out_slot="Out", stop_gradient=False):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(
        dtype or ref.dtype, stop_gradient)
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={out_slot: [out.name]}, attrs=attrs or {})
    return out


def _3(v):
    return [v, v, v] if isinstance(v, int) else list(v)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, name=None):
    return _one_out("pool3d", {"X": [input.name]},
                    {"ksize": _3(pool_size), "pooling_type": pool_type,
                     "strides": _3(pool_stride),
                     "paddings": _3(pool_padding),
                     "global_pooling": global_pooling,
                     "ceil_mode": ceil_mode, "exclusive": exclusive},
                    ref=input, name=name)


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """pool3d to a fixed output size `pool_size`; the indices
    (`require_index`) are not computed, as in the JAX package."""
    return _one_out("pool3d", {"X": [input.name]},
                    {"ksize": _3(pool_size), "pooling_type": pool_type,
                     "adaptive": True, "strides": [1, 1, 1],
                     "paddings": [0, 0, 0]},
                    ref=input, name=name)


def unique_with_counts(x, dtype="int32"):
    """unique's padded Out and Index, and each value's count (0 in the
    padded slots)."""
    helper = LayerHelper("unique_with_counts")
    out = helper.create_variable_for_type_inference(x.dtype, True)
    index = helper.create_variable_for_type_inference(dtype, True)
    count = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(type="unique_with_counts", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Index": [index.name],
                              "Count": [count.name]})
    return out, index, count
