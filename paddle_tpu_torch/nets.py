"""Composed blocks of the JAX package's nets.py: simple_img_conv_pool,
img_conv_group, sequence_conv_pool, glu and
scaled_dot_product_attention."""
from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool",
           "glu", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None,
                         use_cudnn=True):
    """conv2d (with bias and `act`) then pool2d."""
    conv_out = layers.conv2d(input, num_filters, filter_size,
                             stride=conv_stride, padding=conv_padding,
                             dilation=conv_dilation, groups=conv_groups,
                             param_attr=param_attr, bias_attr=bias_attr,
                             act=act)
    return layers.pool2d(conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """conv2d (then batch_norm and dropout, optionally) for each entry of
    `conv_num_filter`, then pool2d."""
    tmp = input
    if isinstance(conv_num_filter, int):
        conv_num_filter = [conv_num_filter]
    for nf in conv_num_filter:
        local_act = None if conv_with_batchnorm else conv_act
        tmp = layers.conv2d(tmp, nf, conv_filter_size,
                            padding=conv_padding, param_attr=param_attr,
                            act=local_act)
        if conv_with_batchnorm:
            tmp = layers.batch_norm(tmp, act=conv_act)
            if conv_batchnorm_drop_rate > 0:
                tmp = layers.dropout(tmp, conv_batchnorm_drop_rate)
    return layers.pool2d(tmp, pool_size=pool_size, pool_stride=pool_stride,
                         pool_type=pool_type)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    """sequence_conv (with bias and `act`) then sequence_pool, the pool
    masked by the input's lengths when it is ragged (its lod_link). The
    JAX package's raises NotImplementedError; its own layers compose the
    same program."""
    conv_out = layers.sequence_conv(input, num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    ln = input.block.program.lod_link.get(input.name)
    lengths = input.block._find_var_recursive(ln) if ln else None
    return layers.sequence_pool(conv_out, pool_type, lengths=lengths)


def glu(input, dim=-1):
    """The first half of `input` along `dim` gated by the sigmoid of the
    second."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head attention composed of matmul and softmax ([b, t, d]
    inputs); the fused kernel is models.transformer's flash_attention."""
    d = queries.shape[-1]
    head_dim = d // num_heads

    def _split_heads(x):
        b, t = x.shape[0], x.shape[1]
        x = layers.reshape(x, [b, t, num_heads, head_dim])
        return layers.transpose(x, [0, 2, 1, 3])

    q = _split_heads(queries)
    k = _split_heads(keys)
    v = _split_heads(values)
    logits = layers.matmul(q, k, transpose_y=True,
                           alpha=float(head_dim) ** -0.5)
    weights = layers.softmax(logits)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_rate)
    ctx = layers.matmul(weights, v)
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    b, t = ctx.shape[0], ctx.shape[1]
    return layers.reshape(ctx, [b, t, num_heads * head_dim])
