"""Graph-building layer functions (the encoder's subset)."""
from .io import data  # noqa: F401
from .math_ops import elementwise_add  # noqa: F401
from .nn import (add_position_encoding, dropout, embedding, fc,  # noqa: F401
                 flash_attention, gelu, layer_norm, reshape, transpose)
