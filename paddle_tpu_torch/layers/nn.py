"""layers.nn — graph-building functions over the op library.

Every layer of the JAX package's layers/nn.py. Each emits the same op
types and attrs as its counterpart in the JAX package, so programs built
by the two packages serialize identically.
"""
from __future__ import annotations

import math

from ..framework import unique_name
from ..initializer import Constant, Normal
from ..layer_helper import LayerHelper
from .math_ops import (elementwise_add, elementwise_div,  # noqa: F401
                       elementwise_max, elementwise_min, elementwise_mul,
                       elementwise_sub)

__all__ = [
    "fc", "embedding", "conv2d", "conv3d", "depthwise_conv2d",
    "conv2d_transpose", "pool2d", "adaptive_pool2d", "batch_norm",
    "layer_norm", "instance_norm", "group_norm", "dropout", "softmax",
    "log_softmax", "one_hot", "matmul", "topk", "relu", "sigmoid", "tanh",
    "exp", "sqrt", "square", "log", "gelu", "leaky_relu", "elu", "relu6",
    "pow", "stanh", "hard_sigmoid", "swish", "hard_swish", "prelu", "selu",
    "soft_relu", "brelu", "maxout", "lrn", "l2_normalize", "label_smooth",
    "pad", "pad2d", "image_resize", "resize_bilinear", "resize_nearest",
    "pixel_shuffle", "space_to_depth", "shuffle_channel", "temporal_shift",
    "affine_channel", "flatten", "unfold", "add_position_encoding",
    "bilinear_tensor_product", "clip", "clip_by_norm", "mean", "mul",
    "scale", "cos_sim", "dice_loss", "mse_loss", "npair_loss",
    "square_error_cost", "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "huber_loss", "kldiv_loss",
    "log_loss", "rank_loss", "margin_rank_loss", "bpr_loss", "smooth_l1",
    "center_loss", "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
    "reduce_prod", "reduce_all", "reduce_any", "split", "reshape",
    "squeeze", "unsqueeze", "transpose", "stack", "unstack", "expand",
    "expand_as", "gather", "gather_nd", "scatter", "scatter_nd_add",
    "slice", "strided_slice", "shape", "rank", "size", "cumsum",
    "uniform_random", "gaussian_random", "sampling_id", "logical_and",
    "logical_or", "logical_xor", "logical_not", "sign", "where", "unique",
    "shard_index", "hash", "grid_sampler", "erf", "fsp_matrix",
    "flash_attention", "sums", "warpctc", "elementwise_add",
    "elementwise_sub",
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
sigmoid = _unary_layer("sigmoid")
log = _unary_layer("log")
erf = _unary_layer("erf")
logical_not = _unary_layer("logical_not")
log_softmax = _unary_layer("log_softmax")
cumsum = _unary_layer("cumsum")
selu = _unary_layer("selu")


def leaky_relu(x, alpha=0.02, name=None):
    return _unary_layer("leaky_relu")(x, name=name, alpha=alpha)


def elu(x, alpha=1.0, name=None):
    return _unary_layer("elu")(x, name=name, alpha=alpha)


def relu6(x, threshold=6.0, name=None):
    return _unary_layer("relu6")(x, name=name, threshold=threshold)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return _unary_layer("stanh")(x, name=name, scale_a=scale_a,
                                 scale_b=scale_b)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _unary_layer("hard_sigmoid")(x, name=name, slope=slope,
                                        offset=offset)


def swish(x, beta=1.0, name=None):
    return _unary_layer("swish")(x, name=name, beta=beta)


def hard_swish(x, threshold=6.0, scale=6.0, offset=3.0, name=None):
    return _unary_layer("hard_swish")(x, name=name, threshold=threshold,
                                      scale=scale, offset=offset)


def soft_relu(x, threshold=40.0, name=None):
    return _unary_layer("soft_relu")(x, name=name, threshold=threshold)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _unary_layer("brelu")(x, name=name, t_min=t_min, t_max=t_max)


def maxout(x, groups, name=None, axis=1):
    return _unary_layer("maxout")(x, name=name, groups=groups, axis=axis)


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
               dilation, groups, param_attr, bias_attr, act, name,
               num_spatial=2):
    helper = LayerHelper(op_type, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    num_channels = input.shape[1]
    groups = groups or 1
    if isinstance(filter_size, int):
        filter_size = [filter_size] * num_spatial
    if isinstance(stride, int):
        stride = [stride] * num_spatial
    if isinstance(padding, int):
        padding = [padding] * num_spatial
    if isinstance(dilation, int):
        dilation = [dilation] * num_spatial
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


def depthwise_conv2d(input, num_filters, filter_size, stride=1, padding=0,
                     dilation=1, param_attr=None, bias_attr=None, act=None,
                     name=None):
    return _conv_base("depthwise_conv2d", input, num_filters, filter_size,
                      stride, padding, dilation, input.shape[1], param_attr,
                      bias_attr, act, name)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    return _conv_base("conv3d", input, num_filters, filter_size, stride,
                      padding, dilation, groups, param_attr, bias_attr, act,
                      name, num_spatial=3)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """Filter [C_in, num_filters / groups, kh, kw]; without `filter_size`
    it is the one that gives `output_size`."""
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    num_channels = input.shape[1]
    if isinstance(stride, int):
        stride = [stride, stride]
    if isinstance(padding, int):
        padding = [padding, padding]
    if isinstance(dilation, int):
        dilation = [dilation, dilation]
    if filter_size is None:
        if output_size is None:
            raise ValueError("need filter_size or output_size")
        if isinstance(output_size, int):
            output_size = [output_size, output_size]
        h_in, w_in = input.shape[2], input.shape[3]
        filter_size = [
            (output_size[0] - (h_in - 1) * stride[0] + 2 * padding[0] - 1)
            // dilation[0] + 1,
            (output_size[1] - (w_in - 1) * stride[1] + 2 * padding[1] - 1)
            // dilation[1] + 1]
    elif isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    groups = groups or 1
    filter_shape = [num_channels, num_filters // groups] + list(filter_size)
    w = helper.create_parameter(helper.param_attr, filter_shape, input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="conv2d_transpose",
                     inputs={"Input": [input.name], "Filter": [w.name]},
                     outputs={"Output": [out.name]},
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups})
    pre_act = helper.append_bias_op(out, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


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


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    c = input.shape[1]
    s = helper.create_parameter(helper.param_attr, [c], input.dtype,
                                default_initializer=Constant(1.0))
    b = helper.create_parameter(helper.bias_attr, [c], input.dtype,
                                is_bias=True)
    y = helper.create_variable_for_type_inference(input.dtype)
    sm = helper.create_variable_for_type_inference(input.dtype, True)
    sv = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="instance_norm",
                     inputs={"X": [input.name], "Scale": [s.name],
                             "Bias": [b.name]},
                     outputs={"Y": [y.name], "SavedMean": [sm.name],
                              "SavedVariance": [sv.name]},
                     attrs={"epsilon": epsilon})
    return y


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    """Scale and Bias are left out when their attr is False."""
    helper = LayerHelper("group_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c = input.shape[1]
    inputs = {"X": [input.name]}
    if helper.param_attr is not False:
        s = helper.create_parameter(helper.param_attr, [c], input.dtype,
                                    default_initializer=Constant(1.0))
        inputs["Scale"] = [s.name]
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, [c], input.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b.name]
    y = helper.create_variable_for_type_inference(input.dtype)
    m = helper.create_variable_for_type_inference(input.dtype, True)
    v = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="group_norm", inputs=inputs,
                     outputs={"Y": [y.name], "Mean": [m.name],
                              "Variance": [v.name]},
                     attrs={"groups": groups, "epsilon": epsilon})
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


def _reduce_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        """Reduce over the axes `dim` (an int or a list); over all of
        them when `dim` is None."""
        helper = LayerHelper(op_type, name=name)
        if dim is None:
            dim, reduce_all = [0], True
        else:
            dim = [dim] if isinstance(dim, int) else list(dim)
            reduce_all = False
        out = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(type=op_type, inputs={"X": [input.name]},
                         outputs={"Out": [out.name]},
                         attrs={"dim": dim, "keep_dim": keep_dim,
                                "reduce_all": reduce_all})
        return out
    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")
reduce_all = _reduce_layer("reduce_all")
reduce_any = _reduce_layer("reduce_any")


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


def prelu(x, mode, param_attr=None, name=None):
    """One alpha (`all`), one a channel (`channel`) or one an element of a
    sample (`element`), initialised to 0.25."""
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    alpha_shape = {"all": [1], "channel": [x.shape[1]],
                   "element": list(x.shape[1:])}[mode]
    alpha = helper.create_parameter(helper.param_attr, alpha_shape, x.dtype,
                                    default_initializer=Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="prelu",
                     inputs={"X": [x.name], "Alpha": [alpha.name]},
                     outputs={"Out": [out.name]}, attrs={"mode": mode})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="lrn", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "MidOut": [mid.name]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type="l2_normalize", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Norm": [norm.name]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pad", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]},
                     attrs={"paddings": paddings, "pad_value": pad_value})
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="pad2d", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": pad_value,
                            "data_format": data_format})
    return out


pixel_shuffle_raw = _unary_layer("pixel_shuffle")


def pixel_shuffle(x, upscale_factor):
    return pixel_shuffle_raw(x, upscale_factor=upscale_factor)


def space_to_depth(x, blocksize, name=None):
    return _unary_layer("space_to_depth")(x, name=name, blocksize=blocksize)


def shuffle_channel(x, group, name=None):
    return _unary_layer("shuffle_channel")(x, name=name, group=group)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _unary_layer("temporal_shift")(x, name=name, seg_num=seg_num,
                                          shift_ratio=shift_ratio)


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None,
                   act=None):
    helper = LayerHelper("affine_channel", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="affine_channel",
                     inputs={"X": [x.name], "Scale": [scale.name],
                             "Bias": [bias.name]},
                     outputs={"Out": [out.name]})
    return helper.append_activation(out)


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="flatten", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    helper = LayerHelper("unfold", name=name)
    if isinstance(kernel_sizes, int):
        kernel_sizes = [kernel_sizes, kernel_sizes]
    if isinstance(strides, int):
        strides = [strides, strides]
    if isinstance(paddings, int):
        paddings = [paddings] * 4
    if isinstance(dilations, int):
        dilations = [dilations, dilations]
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="unfold", inputs={"X": [x.name]},
                     outputs={"Y": [out.name]},
                     attrs={"kernel_sizes": kernel_sizes, "strides": strides,
                            "paddings": paddings, "dilations": dilations})
    return out


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    w = helper.create_parameter(helper.param_attr,
                                [size, x.shape[1], y.shape[1]], x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x.name], "Y": [y.name], "Weight": [w.name]}
    if helper.bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, [1, size], x.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b.name]
    helper.append_op(type="bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out.name]})
    return helper.append_activation(out)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(X.dtype)
    xn = helper.create_variable_for_type_inference(X.dtype, True)
    yn = helper.create_variable_for_type_inference(X.dtype, True)
    helper.append_op(type="cos_sim",
                     inputs={"X": [X.name], "Y": [Y.name]},
                     outputs={"Out": [out.name], "XNorm": [xn.name],
                              "YNorm": [yn.name]})
    return out


# -- losses ---------------------------------------------------------------

def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x.name], "Label": [label.name]},
                     outputs={"Out": [out.name]},
                     attrs={"ignore_index": ignore_index,
                            "normalize": normalize})
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="square_error_cost",
                     inputs={"X": [input.name], "Y": [label.name]},
                     outputs={"Out": [out.name]})
    return out


def _two_in_loss(op_type, slots, outs_main, x, y, **attrs):
    """One op of inputs `slots` (x, y) and outputs `outs_main`, the
    first of which is returned (the others stop gradients)."""
    helper = LayerHelper(op_type)
    outs = {}
    for i, slot in enumerate(outs_main):
        v = helper.create_variable_for_type_inference(x.dtype, i > 0)
        outs[slot] = [v.name]
        if i == 0:
            main = v
    helper.append_op(type=op_type,
                     inputs={slots[0]: [x.name], slots[1]: [y.name]},
                     outputs=outs, attrs=attrs)
    return main


def huber_loss(input, label, delta):
    return _two_in_loss("huber_loss", ("X", "Y"), ["Out", "Residual"],
                        input, label, delta=float(delta))


def kldiv_loss(x, target, reduction="mean", name=None):
    return _two_in_loss("kldiv_loss", ("X", "Target"), ["Loss"], x, target,
                        reduction=reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return _two_in_loss("log_loss", ("Predicted", "Labels"), ["Loss"],
                        input, label, epsilon=epsilon)


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    helper.append_op(type="rank_loss",
                     inputs={"Label": [label.name], "Left": [left.name],
                             "Right": [right.name]},
                     outputs={"Out": [out.name]})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(left.dtype)
    act = helper.create_variable_for_type_inference(left.dtype, True)
    helper.append_op(type="margin_rank_loss",
                     inputs={"Label": [label.name], "X1": [left.name],
                             "X2": [right.name]},
                     outputs={"Out": [out.name], "Activated": [act.name]},
                     attrs={"margin": margin})
    return out


def bpr_loss(input, label, name=None):
    helper = LayerHelper("bpr_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="bpr_loss",
                     inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Y": [out.name]})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    out = helper.create_variable_for_type_inference(x.dtype)
    diff = helper.create_variable_for_type_inference(x.dtype, True)
    inputs = {"X": [x.name], "Y": [y.name]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight.name]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight.name]
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Out": [out.name], "Diff": [diff.name]},
                     attrs={"sigma": sigma or 1.0})
    return out


def dice_loss(input, label, epsilon=1e-5):
    """The op's own 1e-5 smooths the quotient; `epsilon` is not read (as
    in the JAX package)."""
    return _two_in_loss("dice_loss", ("X", "Label"), ["Out"], input, label)


def mse_loss(input, label):
    return _two_in_loss("mse_loss", ("X", "Y"), ["Out"], input, label)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    helper = LayerHelper("npair_loss")
    out = helper.create_variable_for_type_inference(anchor.dtype)
    helper.append_op(type="npair_loss",
                     inputs={"Anchor": [anchor.name],
                             "Positive": [positive.name],
                             "Labels": [labels.name]},
                     outputs={"Out": [out.name]},
                     attrs={"l2_reg": float(l2_reg)})
    return out


def center_loss(input, label, num_classes, alpha, param_attr=None,
                update_center=True):
    """With `update_center`, the op writes the moved centers back to their
    parameter (CentersOut names it)."""
    from .tensor import fill_constant
    helper = LayerHelper("center_loss", param_attr=param_attr)
    centers = helper.create_parameter(helper.param_attr,
                                      [num_classes, input.shape[1]],
                                      input.dtype,
                                      default_initializer=Constant(0.0))
    rate = fill_constant([1], "float32", float(alpha))
    loss = helper.create_variable_for_type_inference(input.dtype)
    diff = helper.create_variable_for_type_inference(input.dtype, True)
    outs = {"Loss": [loss.name], "SampleCenterDiff": [diff.name]}
    if update_center:
        outs["CentersOut"] = [centers.name]
    helper.append_op(type="center_loss",
                     inputs={"X": [input.name], "Label": [label.name],
                             "Centers": [centers.name],
                             "CenterUpdateRate": [rate.name]},
                     outputs=outs, attrs={"need_update": update_center})
    return loss


# -- shapes, indices and draws ---------------------------------------------

def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype)
            for _ in range(n)]
    helper.append_op(type="split", inputs={"X": [input.name]},
                     outputs={"Out": [o.name for o in outs]}, attrs=attrs)
    return outs


def _xshape_layer(op_type, x, attrs, name):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, True)
    helper.append_op(type=op_type, inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "XShape": [xshape.name]},
                     attrs=attrs)
    return out


def squeeze(input, axes, name=None):
    return _xshape_layer("squeeze2", input, {"axes": axes}, name)


def unsqueeze(input, axes, name=None):
    return _xshape_layer("unsqueeze2", input, {"axes": axes}, name)


def stack(x, axis=0):
    helper = LayerHelper("stack")
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": [v.name for v in x]},
                     outputs={"Y": [out.name]}, attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    num = num if num is not None else x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype)
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x.name]},
                     outputs={"Y": [o.name for o in outs]},
                     attrs={"axis": axis, "num": num})
    return outs


def expand(x, expand_times, name=None):
    return _unary_layer("expand")(x, name=name, expand_times=expand_times)


def expand_as(x, target_tensor, name=None):
    helper = LayerHelper("expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="expand_as",
                     inputs={"X": [x.name],
                             "target_tensor": [target_tensor.name]},
                     outputs={"Out": [out.name]})
    return out


def _indexed(op_type, slots, x, name=None, attrs=None):
    """One op over X and the named index/update vars, Out of X's dtype."""
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type,
                     inputs={s: [v.name] for s, v in slots.items()},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def gather_nd(input, index, name=None):
    return _indexed("gather_nd", {"X": input, "Index": index}, input, name)


def scatter(input, index, updates, name=None, overwrite=True):
    return _indexed("scatter", {"X": input, "Ids": index,
                                "Updates": updates}, input, name,
                    {"overwrite": overwrite})


def scatter_nd_add(ref, index, updates, name=None):
    return _indexed("scatter_nd_add", {"X": ref, "Index": index,
                                       "Updates": updates}, ref, name)


def strided_slice(input, axes, starts, ends, strides):
    helper = LayerHelper("strided_slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="strided_slice", inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"axes": axes, "starts": starts, "ends": ends,
                            "strides": strides})
    return out


def _count(op_type, input, dtype):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(type=op_type, inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]})
    return out


def shape(input):
    """The int32 [rank] shape of `input`, batch dim included."""
    return _count("shape", input, "int32")


def rank(input):
    from .tensor import fill_constant
    return fill_constant([1], "int32", len(input.shape))


def size(input):
    """The element count, int64 (int32 in the IR, as in the JAX
    package)."""
    return _count("size", input, "int64")


def argsort(input, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ids = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(type="argsort", inputs={"X": [input.name]},
                     outputs={"Out": [out.name], "Indices": [ids.name]},
                     attrs={"axis": axis, "descending": descending})
    return out, ids


def _draw(op_type, dtype, attrs):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype, True)
    helper.append_op(type=op_type, outputs={"Out": [out.name]}, attrs=attrs)
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    return _draw("uniform_random", dtype, {"shape": shape, "dtype": dtype,
                                           "min": min, "max": max})


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    return _draw("gaussian_random", dtype, {"shape": shape, "dtype": dtype,
                                            "mean": mean, "std": std})


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(type="sampling_id", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]})
    return out


def _logical(op_type):
    def layer(x, y=None, out=None, name=None):
        helper = LayerHelper(op_type, name=name)
        if out is None:
            out = helper.create_variable_for_type_inference("bool", True)
        inputs = {"X": [x.name]}
        if y is not None:
            inputs["Y"] = [y.name]
        helper.append_op(type=op_type, inputs=inputs,
                         outputs={"Out": [out.name]})
        return out
    layer.__name__ = op_type
    return layer


logical_and = _logical("logical_and")
logical_or = _logical("logical_or")
logical_xor = _logical("logical_xor")


_PADDED_CONTRACT_WARNED = set()


def _warn_padded_contract(name, detail):
    """Once a process: the layer's output is padded to a static shape
    where the reference emits a dynamically sized tensor (the JAX
    package's contract, and its warning word for word)."""
    if name not in _PADDED_CONTRACT_WARNED:
        _PADDED_CONTRACT_WARNED.add(name)
        import warnings
        warnings.warn(
            f"layers.{name}: {detail} (static-shape contract; the "
            f"reference returns a dynamically sized tensor)",
            UserWarning, stacklevel=3)


def where(condition):
    """Indices [condition.size, rank] of the true elements, -1 rows past
    their count (mask on row >= 0)."""
    _warn_padded_contract(
        "where", "output is [size, rank] with -1 rows past the true "
        "count; mask on row >= 0")
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(type="where_index",
                     inputs={"Condition": [condition.name]},
                     outputs={"Out": [out.name]})
    return out


def unique(x, dtype="int32"):
    """Sorted unique values padded to x.size (+inf for floats, the dtype's
    max for integers; valid count = max(Index) + 1) and each element's
    index into them, cast to `dtype` unless it is int64."""
    _warn_padded_contract(
        "unique", "Out is sentinel-padded to x.size past the unique "
        "count (valid count = max(Index) + 1)")
    helper = LayerHelper("unique")
    out = helper.create_variable_for_type_inference(x.dtype, True)
    index = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(type="unique", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Index": [index.name]})
    if dtype and dtype not in ("int64",):
        from .tensor import cast
        index = cast(index, dtype)
    return out, index


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    helper = LayerHelper("shard_index")
    out = helper.create_variable_for_type_inference(input.dtype, True)
    helper.append_op(type="shard_index", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"index_num": index_num, "nshards": nshards,
                            "shard_id": shard_id,
                            "ignore_value": ignore_value})
    return out


def hash(input, hash_size, num_hash=1, name=None):
    """Feature hashing of int id rows: [..., num_hash, 1], each
    XXH64(row, j) % hash_size."""
    helper = LayerHelper("hash")
    out = helper.create_variable_for_type_inference("int64", True)
    helper.append_op(type="hash", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"num_hash": num_hash, "mod_by": hash_size})
    return out


def grid_sampler(x, grid, name=None):
    helper = LayerHelper("grid_sampler")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="grid_sampler",
                     inputs={"X": [x.name], "Grid": [grid.name]},
                     outputs={"Output": [out.name]})
    return out


def fsp_matrix(x, y):
    helper = LayerHelper("fsp")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="fsp", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]})
    return out


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """CTC loss [B, 1] over padded [B, T, C] logits; input_length and
    label_length give the true lengths, so padded steps emit nothing."""
    helper = LayerHelper("warpctc")
    loss = helper.create_variable_for_type_inference(input.dtype)
    grad = helper.create_variable_for_type_inference(input.dtype, True)
    ins = {"Logits": [input.name], "Label": [label.name]}
    if input_length is not None:
        ins["LogitsLength"] = [input_length.name]
    if label_length is not None:
        ins["LabelLength"] = [label_length.name]
    helper.append_op(type="warpctc", inputs=ins,
                     outputs={"Loss": [loss.name],
                              "WarpCTCGrad": [grad.name]},
                     attrs={"blank": blank,
                            "norm_by_times": norm_by_times})
    return loss
