"""Composed blocks: simple_img_conv_pool (the JAX package's nets.py)."""
from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool"]


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
