"""Graph-building layer functions (the encoder's and its training
losses' subset)."""
from .io import data  # noqa: F401
from .math_ops import elementwise_add  # noqa: F401
from .nn import (add_position_encoding, dropout, embedding, fc,  # noqa: F401
                 flash_attention, gather, gelu, layer_norm, mean, reshape,
                 softmax_with_cross_entropy, transpose)
from .tensor import cast, create_global_var  # noqa: F401
