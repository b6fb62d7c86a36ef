"""layers.nn — graph-building functions over the op library.

The functions the transformer models (BERT, GPT, NMT), their training
losses, the GPT decode steps and the vision models (ResNet, LeNet, DeepLabv3+)
call.
Each emits the same op types and attrs as its counterpart in the JAX
package, so programs built by the two packages serialize identically.
"""
from __future__ import annotations

import math

from ..framework import unique_name
from ..initializer import Constant, Normal
from ..layer_helper import LayerHelper
from .math_ops import (elementwise_add, elementwise_div,  # noqa: F401
                       elementwise_max, elementwise_min, elementwise_mul,
                       elementwise_sub)

__all__ = ["fc", "embedding", "layer_norm", "dropout",
           "add_position_encoding", "flash_attention", "reshape",
           "transpose", "gelu", "elementwise_add", "mean",
           "softmax_with_cross_entropy", "gather", "softmax", "matmul",
           "scale", "slice", "one_hot", "reduce_mean", "conv2d", "pool2d",
           "adaptive_pool2d",
           "batch_norm", "relu", "tanh", "topk", "cross_entropy",
           "label_smooth", "image_resize", "resize_bilinear",
           "resize_nearest", "exp", "sqrt", "square", "sign", "pow",
           "clip", "clip_by_norm", "sums", "elementwise_sub",
           "elementwise_mul", "elementwise_div", "elementwise_max",
           "elementwise_min"]


def _unary_layer(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x.name]},
                         outputs={"Out": [out.name]}, attrs=attrs)
        return out
    layer.__name__ = op_type
    return layer


gelu = _unary_layer("gelu")
relu = _unary_layer("relu")
tanh = _unary_layer("tanh")
exp = _unary_layer("exp")
sqrt = _unary_layer("sqrt")
square = _unary_layer("square")
sign = _unary_layer("sign")


def pow(x, factor=1.0, name=None):
    return _unary_layer("pow")(x, name=name, factor=factor)


def clip(x, min, max, name=None):
    return _unary_layer("clip")(x, name=name, min=float(min), max=float(max))


def clip_by_norm(x, max_norm, name=None):
    return _unary_layer("clip_by_norm")(x, name=name,
                                        max_norm=float(max_norm))


def sums(input, out=None):
    """Out = the sum of the vars of `input` (one `sum` op)."""
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sum",
                     inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]})
    return out


def mean(x, name=None):
    return _unary_layer("mean")(x, name=name)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected layer: mul per input + sum + bias + activation."""
    helper = LayerHelper("fc", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        in_dim = math.prod(inp.shape[num_flatten_dims:])
        w = helper.create_parameter(helper.param_attr, [in_dim, size],
                                    inp.dtype)
        tmp = helper.create_variable_for_type_inference(inp.dtype)
        helper.append_op(type="mul",
                         inputs={"X": [inp.name], "Y": [w.name]},
                         outputs={"Out": [tmp.name]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            mul_results[0].dtype)
        helper.append_op(type="sum",
                         inputs={"X": [m.name for m in mul_results]},
                         outputs={"Out": [pre_bias.name]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """lookup over a [vocab, dim] parameter. Ids with a trailing dim of 1
    take lookup_table, which squeezes that dim ([B, 1] ids -> [B, dim]);
    any other ids take lookup_table_v2 ([..., dim])."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, size, dtype)
    out = helper.create_variable_for_type_inference(dtype)
    op_type = ("lookup_table"
               if input.shape and input.shape[-1] == 1 else "lookup_table_v2")
    helper.append_op(type=op_type,
                     inputs={"W": [w.name], "Ids": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"padding_idx": (-1 if padding_idx is None
                                            else padding_idx)})
    return out


def _conv_base(op_type, input, num_filters, filter_size, stride, padding,
               dilation, groups, param_attr, bias_attr, act, name):
    helper = LayerHelper(op_type, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    num_channels = input.shape[1]
    groups = groups or 1
    if isinstance(filter_size, int):
        filter_size = [filter_size] * 2
    if isinstance(stride, int):
        stride = [stride] * 2
    if isinstance(padding, int):
        padding = [padding] * 2
    if isinstance(dilation, int):
        dilation = [dilation] * 2
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    std = (2.0 / (math.prod(filter_size) * num_channels)) ** 0.5
    w = helper.create_parameter(helper.param_attr, filter_shape, input.dtype,
                                default_initializer=Normal(0.0, std))
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type=op_type,
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups})
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    return _conv_base("conv2d", input, num_filters, filter_size, stride,
                      padding, dilation, groups, param_attr, bias_attr, act,
                      name)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True):
    helper = LayerHelper("pool2d", name=name)
    if isinstance(pool_size, int):
        pool_size = [pool_size, pool_size]
    if isinstance(pool_stride, int):
        pool_stride = [pool_stride, pool_stride]
    if isinstance(pool_padding, int):
        pool_padding = [pool_padding, pool_padding]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="pool2d", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"pooling_type": pool_type, "ksize": pool_size,
                            "strides": pool_stride,
                            "paddings": pool_padding,
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode, "exclusive": exclusive})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """Pool to a fixed output size (`pool_size`): the pool2d op with
    `adaptive` set. The max pool's indices (`require_index`) are not
    computed; asking for them raises."""
    if require_index:
        raise NotImplementedError(
            "adaptive_pool2d(require_index=True): the max pool's indices "
            "are not computed")
    helper = LayerHelper("pool2d", name=name)
    if isinstance(pool_size, int):
        pool_size = [pool_size, pool_size]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="pool2d", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"pooling_type": pool_type, "ksize": pool_size,
                            "adaptive": True})
    return out


def _create_persistable_stat(helper, name_hint, shape, dtype, init_value):
    """A non-trainable persistable var in both programs, initialised in
    the startup program (batch_norm's running mean and variance)."""
    name = unique_name.generate(name_hint)
    sp = helper.startup_program.global_block()
    sv = sp.create_var(name=name, shape=shape, dtype=dtype, persistable=True,
                       stop_gradient=True)
    Constant(init_value)(sv, sp)
    return helper.main_program.global_block().create_var(
        name=name, shape=shape, dtype=dtype, persistable=True,
        stop_gradient=True)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=
               False, use_global_stats=False):
    """MeanOut and VarianceOut name the running Mean and Variance vars
    themselves: a training step updates them in the Scope."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(helper.param_attr, [c], input.dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(helper.bias_attr, [c], input.dtype,
                                   is_bias=True)
    mean = _create_persistable_stat(helper, f"{helper.name}.mean", [c],
                                    input.dtype, 0.0)
    var = _create_persistable_stat(helper, f"{helper.name}.var", [c],
                                   input.dtype, 1.0)
    y = helper.create_variable_for_type_inference(input.dtype)
    saved_m = helper.create_variable_for_type_inference(input.dtype, True)
    saved_v = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input.name], "Scale": [scale.name],
                "Bias": [bias.name], "Mean": [mean.name],
                "Variance": [var.name]},
        outputs={"Y": [y.name], "MeanOut": [mean.name],
                 "VarianceOut": [var.name], "SavedMean": [saved_m.name],
                 "SavedVariance": [saved_v.name]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(y)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    norm_size = math.prod(input.shape[begin_norm_axis:])
    inputs = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(helper.param_attr, [norm_size],
                                    input.dtype,
                                    default_initializer=Constant(1.0))
        inputs["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(helper.bias_attr, [norm_size],
                                    input.dtype, is_bias=True)
        inputs["Bias"] = [b.name]
    y = helper.create_variable_for_type_inference(input.dtype)
    m = helper.create_variable_for_type_inference(input.dtype, True)
    v = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [y.name], "Mean": [m.name],
                              "Variance": [v.name]},
                     attrs={"begin_norm_axis": begin_norm_axis,
                            "epsilon": epsilon})
    return helper.append_activation(y)


def dropout(x, dropout_prob, is_test=False, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8", True)
    helper.append_op(type="dropout", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Mask": [mask.name]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "dropout_implementation":
                                dropout_implementation})
    return out


def add_position_encoding(input, alpha, beta, name=None):
    return _unary_layer("add_position_encoding")(input, name=name,
                                                 alpha=alpha, beta=beta)


def flash_attention(q, k, v, causal=False, sm_scale=None, block_q=None,
                    block_k=None, attn_dropout=0.0, name=None):
    """Fused attention over [b, h, t, d] q/k/v (the Hopper kernel of
    ops/cuda/flash_attention.py; exact plain path when dropout is on).

    block_q/block_k=None omits the tile attrs; 0 forces the exact plain
    path. Other values are TPU tile hints that the Hopper kernel reads
    no further."""
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype)
    # is_test present so clone(for_test=True) turns attention dropout off
    attrs = {"causal": causal, "attn_dropout": float(attn_dropout),
             "is_test": False}
    if block_q is not None:
        attrs["block_q"] = block_q
    if block_k is not None:
        attrs["block_k"] = block_k
    if sm_scale is not None:
        attrs["sm_scale"] = float(sm_scale)
    helper.append_op(type="flash_attention",
                     inputs={"Q": [q.name], "K": [k.name], "V": [v.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False,
            name=None):
    helper = LayerHelper("reshape2", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="reshape2", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "XShape": [xshape.name]},
                     attrs={"shape": [int(s) for s in shape]})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="transpose2", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "XShape": [xshape.name]},
                     attrs={"axis": list(perm)})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits.name],
                             "Label": [label.name]},
                     outputs={"Softmax": [softmax_out.name],
                              "Loss": [loss.name]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index, "axis": axis})
    if return_softmax:
        return loss, softmax_out
    return loss


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Y": [out.name]},
                     attrs={"soft_label": soft_label,
                            "ignore_index": ignore_index})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label.name]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist.name]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out.name]},
                     attrs={"epsilon": float(epsilon)})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(type="top_k", inputs={"X": [input.name]},
                     outputs={"Out": [values.name],
                              "Indices": [indices.name]},
                     attrs={"k": k})
    return values, indices


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather",
                     inputs={"X": [input.name], "Index": [index.name]},
                     outputs={"Out": [out.name]})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="matmul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y,
                            "alpha": float(alpha)})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="scale", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"axes": axes, "starts": starts, "ends": ends})
    return out


def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"depth": depth})
    return out


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    """Mean over the axes `dim` (an int or a list); over all of them when
    `dim` is None."""
    helper = LayerHelper("reduce_mean", name=name)
    if dim is None:
        dim, reduce_all = [0], True
    else:
        dim = [dim] if isinstance(dim, int) else list(dim)
        reduce_all = False
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="reduce_mean", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"dim": dim, "keep_dim": keep_dim,
                            "reduce_all": reduce_all})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", align_corners=True, align_mode=1):
    op = {"BILINEAR": "bilinear_interp",
          "NEAREST": "nearest_interp"}[resample]
    helper = LayerHelper(op, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs = {"align_corners": align_corners, "align_mode": align_mode}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
    if scale is not None:
        attrs["scale"] = float(scale)
    helper.append_op(type=op, inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None,
                    align_corners=True, align_mode=1):
    return image_resize(input, out_shape, scale, name, "BILINEAR",
                        align_corners, align_mode)


def resize_nearest(input, out_shape=None, scale=None, name=None,
                   align_corners=True):
    return image_resize(input, out_shape, scale, name, "NEAREST",
                        align_corners)
