"""Graph-building layer functions (the subset the transformer and vision
models, their training losses, the GPT decode steps, the LR schedules,
the gradient clips and the regularizers use, the in-program readers,
and the tensor creation and check layers)."""
from .control_flow import equal, increment, less_equal  # noqa: F401
from .io import (create_py_reader_by_data, data,  # noqa: F401
                 double_buffer, load, py_reader, read_file)
from .learning_rate_scheduler import (  # noqa: F401
    autoincreased_step_counter, cosine_decay, every_n_steps,
    exponential_decay, inverse_time_decay, linear_lr_warmup,
    natural_exp_decay, noam_decay, piecewise_decay, polynomial_decay)
from .math_ops import (elementwise_add, elementwise_div,  # noqa: F401
                       elementwise_floordiv, elementwise_max,
                       elementwise_min, elementwise_mod, elementwise_mul,
                       elementwise_pow, elementwise_sub)
from .metric_op import accuracy  # noqa: F401
from .nn import (adaptive_pool2d, add_position_encoding,  # noqa: F401
                 batch_norm, clip, clip_by_norm, conv2d, cross_entropy,
                 dropout, embedding, exp, fc, flash_attention, gather, gelu,
                 image_resize, label_smooth, layer_norm, matmul, mean,
                 one_hot, pool2d, pow, reduce_mean, relu, reshape,
                 resize_bilinear, resize_nearest, scale, sign, slice,
                 softmax, softmax_with_cross_entropy, sqrt, square, sums,
                 tanh, topk, transpose)
from .tensor import (argmax, argmin, assign, cast,  # noqa: F401
                     concat, create_global_var, create_parameter,
                     create_tensor, diag, eye, fill_constant,
                     fill_constant_batch_size_like, has_inf, has_nan,
                     isfinite, linspace, ones, ones_like, range, reverse,
                     zeros, zeros_like)
