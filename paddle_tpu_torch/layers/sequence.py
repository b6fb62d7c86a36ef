"""Sequence layers over the padded layout: a ragged var is padded
[B, T, ...] plus a lengths companion, which every layer here finds
through program.lod_link when the caller passes none (a var made by
layers.data(lod_level=1), or one an op of _LOD_PRESERVING made from it).
sequence_pad / sequence_unpad are the boundary converters.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["sequence_mask", "sequence_pool", "sequence_softmax",
           "sequence_reverse", "sequence_expand", "sequence_concat",
           "sequence_first_step", "sequence_last_step",
           "sequence_conv", "sequence_expand_as", "sequence_pad",
           "sequence_unpad", "sequence_slice", "sequence_reshape",
           "sequence_scatter", "sequence_enumerate"]


def _default_lengths(helper, input):
    """The ragged input's lengths var through program.lod_link (set by
    layers.data(lod_level>0), carried across length-preserving ops by
    LayerHelper), or None."""
    name = getattr(input, "name", None)
    if name is None:
        return None
    ln = helper.block.program.lod_link.get(name)
    if ln is None:
        return None
    return helper.block._find_var_recursive(ln)


def sequence_mask(x, maxlen=None, dtype="int64"):
    helper = LayerHelper("sequence_mask")
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(type="sequence_mask", inputs={"X": [x.name]},
                     outputs={"Y": [out.name]},
                     attrs={"maxlen": maxlen or -1, "out_dtype": dtype})
    return out


def sequence_pool(input, pool_type, lengths=None):
    """Padded-dense pooling: input [B, T, ...] (+ optional lengths [B])."""
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    idx = helper.create_variable_for_type_inference("int32", True)
    if lengths is None:
        lengths = _default_lengths(helper, input)
    inputs = {"X": [input.name]}
    if lengths is not None:
        inputs["Lengths"] = [lengths.name]
    helper.append_op(type="sequence_pool", inputs=inputs,
                     outputs={"Out": [out.name], "MaxIndex": [idx.name]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_softmax(input, lengths=None, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if lengths is None:
        lengths = _default_lengths(helper, input)
    inputs = {"X": [input.name]}
    if lengths is not None:
        inputs["Lengths"] = [lengths.name]
    helper.append_op(type="sequence_softmax", inputs=inputs,
                     outputs={"Out": [out.name]})
    return out


def sequence_reverse(x, lengths=None, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    if lengths is None:
        lengths = _default_lengths(helper, x)
    inputs = {"X": [x.name]}
    if lengths is not None:
        inputs["Lengths"] = [lengths.name]
    helper.append_op(type="sequence_reverse", inputs=inputs,
                     outputs={"Y": [out.name]})
    return out


def sequence_concat(input, name=None):
    from .tensor import concat
    return concat(input, axis=1, name=name)


def sequence_first_step(input):
    """sequence_pool FIRST."""
    return sequence_pool(input, "first")


def sequence_last_step(input):
    """sequence_pool LAST."""
    return sequence_pool(input, "last")


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, bias_attr=None, param_attr=None, act=None,
                  name=None):
    helper = LayerHelper("sequence_conv", name=name, param_attr=param_attr,
                         bias_attr=bias_attr, act=act)
    d = int(input.shape[-1])
    filt = helper.create_parameter(helper.param_attr,
                                   [filter_size * d, num_filters],
                                   input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input.name], "Filter": [filt.name]}
    lengths = _default_lengths(helper, input)
    if lengths is not None:
        ins["Lengths"] = [lengths.name]
    helper.append_op(type="sequence_conv", inputs=ins,
                     outputs={"Out": [out.name]},
                     attrs={"contextLength": filter_size,
                            "contextStride": filter_stride,
                            "contextStart": -(filter_size // 2)})
    out = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(out)


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand",
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"ref_level": ref_level})
    return out


def sequence_expand_as(x, y, name=None):
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand_as",
                     inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]})
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None):
    """(padded, lengths): the padded input as it is (widened to `maxlen`
    with pad_value) and its lengths."""
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int64", True)
    ins = {"X": [x.name], "PadValue": [pad_value.name]}
    lengths = _default_lengths(helper, x)
    if lengths is not None:
        ins["Lengths"] = [lengths.name]
    helper.append_op(type="sequence_pad", inputs=ins,
                     outputs={"Out": [out.name], "Length": [length.name]},
                     attrs={"padded_length": maxlen or -1})
    return out, length


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_unpad",
                     inputs={"X": [x.name], "Length": [length.name]},
                     outputs={"Out": [out.name]})
    # the result stays padded on the device: link the lengths, so later
    # sequence layers mask by them
    helper.block.program.lod_link[out.name] = length.name
    return out


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input.name], "Offset": [offset.name],
                             "Length": [length.name]},
                     outputs={"Out": [out.name]})
    return out


def sequence_reshape(input, new_dim, name=None):
    helper = LayerHelper("sequence_reshape", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_reshape", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"new_dim": new_dim})
    return out


def sequence_scatter(input, index, updates, name=None):
    helper = LayerHelper("sequence_scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_scatter",
                     inputs={"X": [input.name], "Ids": [index.name],
                             "Updates": [updates.name]},
                     outputs={"Out": [out.name]})
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="sequence_enumerate", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"win_size": win_size, "pad_value": pad_value})
    return out
