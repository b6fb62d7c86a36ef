"""Serving: dynamic batching over a bucket ladder, and the engine."""
from .batcher import (BucketLadder, DeadlineExceededError,  # noqa: F401
                      DynamicBatcher, EngineClosedError, QueueFullError,
                      ServingError)
from .engine import EngineConfig, ServingEngine  # noqa: F401
