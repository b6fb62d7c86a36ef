"""Distributed layer builders: sharding annotations + collectives.

Reference analogue: python/paddle/fluid/layers/collective.py (thin wrappers
over the c_* ops used by the transpiler). shard_hint is the JAX package's
addition: a sharding constraint on an activation, the tool behind
tensor/sequence parallelism. The port builds the same ops; a
model-parallel run turns each hint into its reshard
(parallel/model_parallel.py), and ring_attention and ulysses_attention
run over the mesh's seq axis (parallel/ring_attention.py, ulysses.py).
"""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["shard_hint", "c_allreduce_sum", "c_broadcast", "c_allgather",
           "c_reducescatter", "ring_attention", "ulysses_attention"]


def _seq_attention_layer(op_type, doc):
    def layer(q, k, v, causal=False, sm_scale=None, seq_axis="sp",
              batch_axis="dp", name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(q.dtype)
        attrs = {"causal": causal, "seq_axis": seq_axis,
                 "batch_axis": batch_axis}
        if sm_scale is not None:
            attrs["sm_scale"] = float(sm_scale)
        helper.append_op(type=op_type,
                         inputs={"Q": [q.name], "K": [k.name],
                                 "V": [v.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        return out
    layer.__name__ = op_type
    layer.__doc__ = doc
    return layer


ring_attention = _seq_attention_layer(
    "ring_attention",
    """Sequence-parallel attention over [b, h, T, d]: K/V blocks rotate
    around the mesh's seq axis, each block on the flash kernels.""")
ulysses_attention = _seq_attention_layer(
    "ulysses_attention",
    """All-to-all (Ulysses) sequence-parallel attention over
    [b, h, T, d]: two all-to-alls trade the sequence sharding for a
    head sharding, and one flash attention over the whole T runs per
    head group. Requires seq-axis size | n_heads; use ring_attention
    below that.""")


def shard_hint(x, spec, name=None):
    """Constrain x's sharding: spec = list per dim of mesh-axis name(s) or
    None, e.g. ["dp", None, "tp"]."""
    helper = LayerHelper("shard_hint", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="shard_hint", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"spec": list(spec)})
    return out


def _collective_layer(op_type):
    def layer(x, ring_id=0, axis_name=None, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]},
                         attrs={"ring_id": ring_id,
                                "axis_name": axis_name})
        return out
    layer.__name__ = op_type
    return layer


c_allreduce_sum = _collective_layer("c_allreduce_sum")
c_broadcast = _collective_layer("c_broadcast")
c_allgather = _collective_layer("c_allgather")
c_reducescatter = _collective_layer("c_reducescatter")
