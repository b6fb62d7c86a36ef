"""layers.nn — graph-building functions over the op library.

The functions the transformer encoder, its training losses and the GPT
decode steps call.
Each emits the same op types and attrs as its counterpart in the JAX
package, so programs built by the two packages serialize identically.
"""
from __future__ import annotations

import math

from ..initializer import Constant
from ..layer_helper import LayerHelper
from .math_ops import elementwise_add  # noqa: F401

__all__ = ["fc", "embedding", "layer_norm", "dropout",
           "add_position_encoding", "flash_attention", "reshape",
           "transpose", "gelu", "elementwise_add", "mean",
           "softmax_with_cross_entropy", "gather", "softmax", "matmul",
           "scale", "slice", "one_hot", "reduce_mean"]


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
