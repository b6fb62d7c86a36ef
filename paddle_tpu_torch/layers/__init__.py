"""Graph-building layer functions (the encoder's, its training losses'
and the GPT decode steps' subset)."""
from .control_flow import less_equal  # noqa: F401
from .io import data  # noqa: F401
from .math_ops import elementwise_add, elementwise_mul  # noqa: F401
from .nn import (add_position_encoding, dropout, embedding, fc,  # noqa: F401
                 flash_attention, gather, gelu, layer_norm, matmul, mean,
                 one_hot, reduce_mean, reshape, scale, slice, softmax,
                 softmax_with_cross_entropy, transpose)
from .tensor import (assign, cast, create_global_var,  # noqa: F401
                     fill_constant, range)
