from .decorator import decorate, OptimizerWithMixedPrecision  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
