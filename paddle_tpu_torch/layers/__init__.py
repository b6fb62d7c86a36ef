"""Graph-building layer functions (the subset the transformer and vision
models, their training losses, the GPT decode steps, the LR schedules,
the gradient clips and the regularizers use)."""
from .control_flow import equal, increment, less_equal  # noqa: F401
from .io import data  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    autoincreased_step_counter, cosine_decay, every_n_steps,
    exponential_decay, inverse_time_decay, linear_lr_warmup,
    natural_exp_decay, noam_decay, piecewise_decay, polynomial_decay)
from .math_ops import (elementwise_add, elementwise_div,  # noqa: F401
                       elementwise_floordiv, elementwise_max,
                       elementwise_min, elementwise_mod, elementwise_mul,
                       elementwise_pow, elementwise_sub)
from .metric_op import accuracy  # noqa: F401
from .nn import (add_position_encoding, batch_norm, clip,  # noqa: F401
                 clip_by_norm, conv2d, cross_entropy, dropout, embedding,
                 exp, fc, flash_attention, gather, gelu, image_resize,
                 label_smooth, layer_norm, matmul, mean, one_hot, pool2d,
                 pow, reduce_mean, relu, reshape, resize_bilinear,
                 resize_nearest, scale, sign, slice, softmax,
                 softmax_with_cross_entropy, sqrt, square, sums, tanh, topk,
                 transpose)
from .tensor import (assign, cast, concat, create_global_var,  # noqa: F401
                     fill_constant, range)
