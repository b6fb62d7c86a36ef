"""Serving: dynamic batching over a bucket ladder, the engine, the
continuous-batching generation engine with speculative decoding, the
paged KV-cache bookkeeping of the decode programs, and the HTTP front
end over both engines.

    from paddle_tpu_torch.serving import GenerationEngine
    eng = GenerationEngine(cfg, scope, max_slots=8, paged=True).start()
    out = eng.generate(prompt_ids, max_new_tokens=32)  # {"tokens", ...}
    eng.stop()
"""
from .batcher import (BucketLadder, DeadlineExceededError,  # noqa: F401
                      DynamicBatcher, EngineClosedError, OverloadedError,
                      QueueFullError, ServingError)
from .engine import EngineConfig, ServingEngine  # noqa: F401
from .generation import (GenerationEngine, GenerationRequest,  # noqa: F401
                         SlotManager)
from .http import ServingHTTPServer, serve  # noqa: F401
from .kv_blocks import (SCRATCH_BLOCK, BlockPool,  # noqa: F401
                        PrefixCache, blocks_for_tokens)
from .spec_decode import NgramDrafter, update_spec_k  # noqa: F401

__all__ = ["BucketLadder", "DynamicBatcher", "EngineConfig",
           "ServingEngine", "ServingError", "QueueFullError",
           "DeadlineExceededError", "EngineClosedError",
           "OverloadedError", "GenerationEngine", "GenerationRequest",
           "SlotManager", "ServingHTTPServer", "serve", "BlockPool",
           "PrefixCache", "SCRATCH_BLOCK", "blocks_for_tokens",
           "NgramDrafter", "update_spec_k"]
