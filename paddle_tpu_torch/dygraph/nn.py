"""dygraph.nn layers (reference: python/paddle/fluid/dygraph/nn.py), the
JAX package's 18 classes with its attrs, defaults and shape checks:
Conv2D, Pool2D, FC (weights made on the first call), Linear, BatchNorm
(running statistics as non-trainable parameters), Embedding, LayerNorm,
Dropout, GroupNorm, PRelu, Conv3D, Conv2DTranspose and Conv3DTranspose
(an output_size in [natural, natural + stride)), GRUUnit, NCE,
BilinearTensorProduct, SpectralNorm and TreeConv (weights made on the
first call)."""
from __future__ import annotations

import numpy as np
import torch

from . import VarBase, current_device, trace_op
from .layers import Layer
from ..initializer import Constant, Normal

__all__ = ["Conv2D", "Pool2D", "FC", "Linear", "BatchNorm", "Embedding",
           "LayerNorm", "Dropout", "GroupNorm", "PRelu", "Conv3D",
           "Conv2DTranspose", "Conv3DTranspose", "GRUUnit", "NCE",
           "BilinearTensorProduct", "SpectralNorm", "TreeConv"]


class Conv2D(Layer):
    def __init__(self, name_scope=None, num_channels=None, num_filters=None,
                 filter_size=None, stride=1, padding=0, dilation=1,
                 groups=None, param_attr=None, bias_attr=None,
                 use_cudnn=True, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._groups = groups or 1
        self._stride = [stride] * 2 if isinstance(stride, int) else stride
        self._padding = [padding] * 2 if isinstance(padding, int) \
            else padding
        self._dilation = [dilation] * 2 if isinstance(dilation, int) \
            else dilation
        self._act = act
        if isinstance(filter_size, int):
            filter_size = [filter_size] * 2
        fan = int(np.prod(filter_size)) * num_channels
        std = (2.0 / fan) ** 0.5
        self.weight = self.create_parameter(
            [num_filters, num_channels // self._groups] + list(filter_size),
            dtype, initializer=Normal(0.0, std))
        self.bias = (None if bias_attr is False else
                     self.create_parameter([num_filters], dtype,
                                           is_bias=True))

    def forward(self, x):
        out = trace_op("conv2d", {"Input": [x], "Filter": [self.weight]},
                       {"strides": self._stride, "paddings": self._padding,
                        "dilations": self._dilation,
                        "groups": self._groups})["Output"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]},
                           {"axis": 1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class Pool2D(Layer):
    def __init__(self, name_scope=None, pool_size=-1, pool_type="max",
                 pool_stride=1, pool_padding=0, global_pooling=False,
                 use_cudnn=True, ceil_mode=False, exclusive=True):
        super().__init__(name_scope)
        self._attrs = {
            "pooling_type": pool_type,
            "ksize": [pool_size] * 2 if isinstance(pool_size, int)
            else pool_size,
            "strides": [pool_stride] * 2 if isinstance(pool_stride, int)
            else pool_stride,
            "paddings": [pool_padding] * 2 if isinstance(pool_padding, int)
            else pool_padding,
            "global_pooling": global_pooling, "ceil_mode": ceil_mode,
            "exclusive": exclusive}

    def forward(self, x):
        return trace_op("pool2d", {"X": [x]}, self._attrs)["Out"][0]


class Linear(Layer):
    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(None, dtype)
        self._act = act
        self.weight = self.create_parameter([input_dim, output_dim], dtype)
        self.bias = (None if bias_attr is False else
                     self.create_parameter([output_dim], dtype,
                                           is_bias=True))

    def forward(self, x):
        out = trace_op("mul", {"X": [x], "Y": [self.weight]},
                       {"x_num_col_dims": len(x.shape) - 1,
                        "y_num_col_dims": 1})["Out"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]},
                           {"axis": -1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class FC(Layer):
    """reference dygraph FC: flattens input to 2-D (num_flatten_dims)."""

    def __init__(self, name_scope=None, size=None, num_flatten_dims=1,
                 param_attr=None, bias_attr=None, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._size = size
        self._nfd = num_flatten_dims
        self._act = act
        self._dtype = dtype
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self.weight = None
        self.bias = None

    def forward(self, x):
        if self.weight is None:
            in_dim = int(np.prod(x.shape[self._nfd:]))
            self.weight = self.create_parameter([in_dim, self._size],
                                                self._dtype)
            self.add_parameter("weight", self.weight)
            if self._bias_attr is not False:
                self.bias = self.create_parameter([self._size], self._dtype,
                                                  is_bias=True)
                self.add_parameter("bias", self.bias)
        out = trace_op("mul", {"X": [x], "Y": [self.weight]},
                       {"x_num_col_dims": self._nfd,
                        "y_num_col_dims": 1})["Out"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]},
                           {"axis": self._nfd})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class BatchNorm(Layer):
    def __init__(self, name_scope=None, num_channels=None, act=None,
                 is_test=False, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", use_global_stats=False):
        super().__init__(name_scope, dtype)
        c = num_channels
        self.weight = self.create_parameter([c], dtype,
                                            initializer=Constant(1.0))
        self.bias = self.create_parameter([c], dtype, is_bias=True)
        self._mean = VarBase(torch.zeros(c, device=current_device()),
                             stop_gradient=True, persistable=True,
                             trainable=False)
        self._variance = VarBase(torch.ones(c, device=current_device()),
                                 stop_gradient=True, persistable=True,
                                 trainable=False)
        self._attrs = {"momentum": momentum, "epsilon": epsilon,
                       "data_layout": data_layout,
                       "use_global_stats": use_global_stats}
        self._act = act

    def forward(self, x):
        attrs = dict(self._attrs, is_test=not self.training)
        outs = trace_op("batch_norm",
                        {"X": [x], "Scale": [self.weight],
                         "Bias": [self.bias], "Mean": [self._mean],
                         "Variance": [self._variance]}, attrs)
        self._mean.value = outs["MeanOut"][0].value
        self._variance.value = outs["VarianceOut"][0].value
        y = outs["Y"][0]
        if self._act:
            y = trace_op(self._act, {"X": [y]}, {})["Out"][0]
        return y


class Embedding(Layer):
    def __init__(self, name_scope=None, size=None, is_sparse=False,
                 padding_idx=None, param_attr=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._padding_idx = -1 if padding_idx is None else padding_idx
        self.weight = self.create_parameter(size, dtype,
                                            initializer=Normal(0.0, 0.02))

    def forward(self, ids):
        op = "lookup_table" if ids.shape and ids.shape[-1] == 1 \
            else "lookup_table_v2"
        return trace_op(op, {"W": [self.weight], "Ids": [ids]},
                        {"padding_idx": self._padding_idx})["Out"][0]


class LayerNorm(Layer):
    def __init__(self, name_scope=None, normalized_shape=None, scale=True,
                 shift=True, epsilon=1e-5, param_attr=None, bias_attr=None,
                 act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        n = int(np.prod(normalized_shape)) if \
            isinstance(normalized_shape, (list, tuple)) else normalized_shape
        self._eps = epsilon
        self._act = act
        self.weight = self.create_parameter([n], dtype,
                                            initializer=Constant(1.0)) \
            if scale else None
        self.bias = self.create_parameter([n], dtype, is_bias=True) \
            if shift else None

    def forward(self, x):
        ins = {"X": [x]}
        if self.weight is not None:
            ins["Scale"] = [self.weight]
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        y = trace_op("layer_norm", ins,
                     {"begin_norm_axis": len(x.shape) - 1,
                      "epsilon": self._eps})["Y"][0]
        if self._act:
            y = trace_op(self._act, {"X": [y]}, {})["Out"][0]
        return y


class Dropout(Layer):
    def __init__(self, p=0.5, dropout_implementation="downgrade_in_infer"):
        super().__init__()
        self._p = p
        self._impl = dropout_implementation

    def forward(self, x):
        return trace_op("dropout", {"X": [x]},
                        {"dropout_prob": self._p,
                         "is_test": not self.training,
                         "dropout_implementation": self._impl})["Out"][0]


class GroupNorm(Layer):
    def __init__(self, name_scope=None, channels=None, groups=1,
                 epsilon=1e-5, dtype="float32", act=None):
        super().__init__(name_scope, dtype)
        self._groups = groups
        self._eps = epsilon
        self._act = act
        self.weight = self.create_parameter([channels], dtype,
                                            initializer=Constant(1.0))
        self.bias = self.create_parameter([channels], dtype, is_bias=True)

    def forward(self, x):
        y = trace_op("group_norm",
                     {"X": [x], "Scale": [self.weight],
                      "Bias": [self.bias]},
                     {"groups": self._groups, "epsilon": self._eps})["Y"][0]
        if self._act:
            y = trace_op(self._act, {"X": [y]}, {})["Out"][0]
        return y


class PRelu(Layer):
    def __init__(self, name_scope=None, mode="all", channel=None,
                 input_shape=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._mode = mode
        shape = {"all": [1], "channel": [channel]}.get(
            mode, list(input_shape or [1]))
        self.weight = self.create_parameter(shape, dtype,
                                            initializer=Constant(0.25))

    def forward(self, x):
        return trace_op("prelu", {"X": [x], "Alpha": [self.weight]},
                        {"mode": self._mode})["Out"][0]


class Conv3D(Layer):
    def __init__(self, name_scope=None, num_channels=None, num_filters=None,
                 filter_size=None, stride=1, padding=0, dilation=1,
                 groups=None, param_attr=None, bias_attr=None,
                 use_cudnn=True, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._groups = groups or 1
        def _3(v):
            return [v] * 3 if isinstance(v, int) else list(v)
        self._stride = _3(stride)
        self._padding = _3(padding)
        self._dilation = _3(dilation)
        self._act = act
        fs = _3(filter_size)
        fan = int(np.prod(fs)) * num_channels
        self.weight = self.create_parameter(
            [num_filters, num_channels // self._groups] + fs, dtype,
            initializer=Normal(0.0, (2.0 / fan) ** 0.5))
        self.bias = (None if bias_attr is False else
                     self.create_parameter([num_filters], dtype,
                                           is_bias=True))

    def forward(self, x):
        out = trace_op("conv3d", {"Input": [x], "Filter": [self.weight]},
                       {"strides": self._stride, "paddings": self._padding,
                        "dilations": self._dilation,
                        "groups": self._groups})["Output"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]},
                           {"axis": 1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class Conv2DTranspose(Layer):
    def __init__(self, name_scope=None, num_channels=None, num_filters=None,
                 filter_size=None, output_size=None, padding=0, stride=1,
                 dilation=1, groups=None, param_attr=None, bias_attr=None,
                 use_cudnn=True, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._groups = groups or 1
        def _2(v):
            return [v] * 2 if isinstance(v, int) else list(v)
        self._stride = _2(stride)
        self._padding = _2(padding)
        self._dilation = _2(dilation)
        self._output_size = output_size
        self._act = act
        fs = _2(filter_size)
        self.weight = self.create_parameter(
            [num_channels, num_filters // self._groups] + fs, dtype,
            initializer=Normal(0.0, 0.02))
        self.bias = (None if bias_attr is False else
                     self.create_parameter([num_filters], dtype,
                                           is_bias=True))

    def forward(self, x):
        attrs = {"strides": self._stride, "paddings": self._padding,
                 "dilations": self._dilation, "groups": self._groups}
        if self._output_size is not None:
            fs = self.weight.shape[-2:]
            natural = [(int(x.shape[2 + i]) - 1) * self._stride[i]
                       - 2 * self._padding[i]
                       + self._dilation[i] * (fs[i] - 1) + 1
                       for i in range(2)]
            want = list(self._output_size)
            extra = [want[i] - natural[i] for i in range(2)]
            # reference conv2d_transpose accepts the whole reachable
            # range [natural, natural + stride); realized by trimming
            # less off the bottom/right of the col2im buffer
            if any(e < 0 or e >= self._stride[i]
                   for i, e in enumerate(extra)):
                raise ValueError(
                    f"Conv2DTranspose: output_size {want} unreachable "
                    f"with stride/padding/filter (natural output "
                    f"{natural}, reachable up to "
                    f"{[natural[i] + self._stride[i] - 1 for i in range(2)]})")
            if any(extra):
                attrs["output_padding"] = extra
        out = trace_op("conv2d_transpose",
                       {"Input": [x], "Filter": [self.weight]},
                       attrs)["Output"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]},
                           {"axis": 1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class Conv3DTranspose(Layer):
    def __init__(self, name_scope=None, num_channels=None, num_filters=None,
                 filter_size=None, output_size=None, padding=0, stride=1,
                 dilation=1, groups=None, param_attr=None, bias_attr=None,
                 use_cudnn=True, act=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._groups = groups or 1
        def _3(v):
            return [v] * 3 if isinstance(v, int) else list(v)
        self._stride = _3(stride)
        self._padding = _3(padding)
        self._dilation = _3(dilation)
        self._output_size = output_size
        self._act = act
        fs = _3(filter_size)
        self.weight = self.create_parameter(
            [num_channels, num_filters // self._groups] + fs, dtype,
            initializer=Normal(0.0, 0.02))
        self.bias = (None if bias_attr is False else
                     self.create_parameter([num_filters], dtype,
                                           is_bias=True))

    def forward(self, x):
        attrs = {"strides": self._stride, "paddings": self._padding,
                 "dilations": self._dilation, "groups": self._groups}
        if self._output_size is not None:
            fs = self.weight.shape[-3:]
            natural = [(int(x.shape[2 + i]) - 1) * self._stride[i]
                       - 2 * self._padding[i]
                       + self._dilation[i] * (fs[i] - 1) + 1
                       for i in range(3)]
            want = list(self._output_size)
            extra = [want[i] - natural[i] for i in range(3)]
            # reachable range [natural, natural + stride), as in the
            # reference conv3d_transpose
            if any(e < 0 or e >= self._stride[i]
                   for i, e in enumerate(extra)):
                raise ValueError(
                    f"Conv3DTranspose: output_size {want} unreachable "
                    f"with stride/padding/filter (natural output "
                    f"{natural}, reachable up to "
                    f"{[natural[i] + self._stride[i] - 1 for i in range(3)]})")
            if any(extra):
                attrs["output_padding"] = extra
        out = trace_op("conv3d_transpose",
                       {"Input": [x], "Filter": [self.weight]},
                       attrs)["Output"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]},
                           {"axis": 1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class GRUUnit(Layer):
    def __init__(self, name_scope=None, size=None, param_attr=None,
                 bias_attr=None, activation="tanh",
                 gate_activation="sigmoid", origin_mode=False,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        d = size // 3
        self._attrs = {"activation": activation,
                       "gate_activation": gate_activation,
                       "origin_mode": origin_mode}
        self.weight = self.create_parameter([d, d * 3], dtype)
        self.bias = (None if bias_attr is False else
                     self.create_parameter([1, d * 3], dtype,
                                           is_bias=True))

    def forward(self, input, hidden):
        ins = {"Input": [input], "HiddenPrev": [hidden],
               "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        out = trace_op("gru_unit", ins, self._attrs)
        return (out["Hidden"][0], out["ResetHiddenPrev"][0],
                out["Gate"][0])


class NCE(Layer):
    def __init__(self, name_scope=None, num_total_classes=None, dim=None,
                 sample_weight=None, param_attr=None, bias_attr=None,
                 num_neg_samples=None, sampler="uniform", custom_dist=None,
                 seed=0, is_sparse=False, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._attrs = {"num_total_classes": num_total_classes,
                       "num_neg_samples": num_neg_samples or 10,
                       "seed": seed}
        self.weight = self.create_parameter([num_total_classes, dim],
                                            dtype)
        self.bias = (None if bias_attr is False else
                     self.create_parameter([num_total_classes], dtype,
                                           is_bias=True))

    def forward(self, input, label, sample_weight=None):
        ins = {"Input": [input], "Label": [label],
               "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        return trace_op("nce", ins, self._attrs)["Cost"][0]


class BilinearTensorProduct(Layer):
    def __init__(self, name_scope=None, size=None, x_dim=None, y_dim=None,
                 name=None, act=None, param_attr=None, bias_attr=None,
                 dtype="float32"):
        super().__init__(name_scope, dtype)
        self._act = act
        self.weight = self.create_parameter([size, x_dim, y_dim], dtype)
        self.bias = (None if bias_attr is False else
                     self.create_parameter([1, size], dtype, is_bias=True))

    def forward(self, x, y):
        ins = {"X": [x], "Y": [y], "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        out = trace_op("bilinear_tensor_product", ins, {})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class SpectralNorm(Layer):
    def __init__(self, name_scope=None, weight_shape=None, dim=0,
                 power_iters=1, eps=1e-12, name=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._attrs = {"dim": dim, "power_iters": power_iters, "eps": eps}
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        self.weight_u = self.create_parameter(
            [h], dtype, initializer=Normal(0.0, 1.0))
        self.weight_v = self.create_parameter(
            [w], dtype, initializer=Normal(0.0, 1.0))

    def forward(self, weight):
        return trace_op("spectral_norm",
                        {"Weight": [weight], "U": [self.weight_u],
                         "V": [self.weight_v]},
                        self._attrs)["Out"][0]


class TreeConv(Layer):
    def __init__(self, name_scope=None, output_size=None, num_filters=1,
                 max_depth=8, act="tanh", param_attr=None, bias_attr=None,
                 name=None, dtype="float32"):
        super().__init__(name_scope, dtype)
        self._act = act
        self._feature_size = None
        self._output_size = output_size
        self._num_filters = num_filters
        self._max_depth = max_depth
        self.weight = None
        self.bias = None
        self._bias_attr = bias_attr

    def forward(self, nodes_vector, edge_set):
        if self.weight is None:
            feature = int(nodes_vector.shape[-1])
            self.weight = self.create_parameter(
                [feature, 3, self._output_size, self._num_filters],
                self._dtype)
            if self._bias_attr is not False:
                self.bias = self.create_parameter(
                    [self._num_filters], self._dtype, is_bias=True)
        out = trace_op("tree_conv",
                       {"NodesVector": [nodes_vector],
                        "EdgeSet": [edge_set], "Filter": [self.weight]},
                       {"max_depth": self._max_depth})["Out"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]},
                           {"axis": -1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out
