"""Serving: dynamic batching over a bucket ladder, the engine, and the
paged KV-cache bookkeeping of the decode programs."""
from .batcher import (BucketLadder, DeadlineExceededError,  # noqa: F401
                      DynamicBatcher, EngineClosedError, QueueFullError,
                      ServingError)
from .engine import EngineConfig, ServingEngine  # noqa: F401
from .kv_blocks import (SCRATCH_BLOCK, BlockPool,  # noqa: F401
                        PrefixCache, blocks_for_tokens)
