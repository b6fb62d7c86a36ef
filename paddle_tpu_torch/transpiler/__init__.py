"""Program-rewrite-based distribution (reference python/paddle/fluid/
transpiler/): collective data parallelism. The parameter-server and
geo-SGD transpilers and memory_optimize wait for ROADMAP §A8e.
"""
from .collective import Collective, GradAllReduce, LocalSGD  # noqa: F401

__all__ = ["Collective", "GradAllReduce", "LocalSGD"]
