"""Graph-building layer functions (the subset the transformer and vision
models, their training losses and the GPT decode steps use)."""
from .control_flow import less_equal  # noqa: F401
from .io import data  # noqa: F401
from .math_ops import elementwise_add, elementwise_mul  # noqa: F401
from .metric_op import accuracy  # noqa: F401
from .nn import (add_position_encoding, batch_norm, conv2d,  # noqa: F401
                 cross_entropy, dropout, embedding, fc, flash_attention,
                 gather, gelu, image_resize, label_smooth, layer_norm,
                 matmul, mean, one_hot, pool2d, reduce_mean, relu, reshape,
                 resize_bilinear, resize_nearest, scale, slice, softmax,
                 softmax_with_cross_entropy, tanh, topk, transpose)
from .tensor import (assign, cast, concat, create_global_var,  # noqa: F401
                     fill_constant, range)
