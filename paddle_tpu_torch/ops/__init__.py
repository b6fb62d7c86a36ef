"""Op library: importing this package registers every lowering."""
from ..core.registry import REGISTRY

from . import activations  # noqa: F401
from . import attention  # noqa: F401
from . import collective  # noqa: F401
from . import controlflow  # noqa: F401
from . import elementwise  # noqa: F401
from . import fused  # noqa: F401
from . import loss_extra  # noqa: F401
from . import loss_ops  # noqa: F401
from . import math  # noqa: F401
from . import metrics_ops  # noqa: F401
from . import misc_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import reduce  # noqa: F401
from . import rnn_ops  # noqa: F401
from . import sequence_extra  # noqa: F401
from . import sequence_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import vision_extra  # noqa: F401


def registered_types():
    return REGISTRY.types()
