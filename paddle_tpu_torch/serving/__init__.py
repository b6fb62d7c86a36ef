"""Serving: dynamic batching over a bucket ladder, the engine, the
continuous-batching generation engine with speculative decoding, the
paged KV-cache bookkeeping of the decode programs, the HTTP front end
over both engines, and the fleet: the multi-replica router, its HTTP
front end, and disaggregated prefill/decode over the KV wire format
(`python -m paddle_tpu_torch.serving.replica` runs one replica process).

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
from .disagg import (FleetPrefixStore, adopt_prefix,  # noqa: F401
                     export_prefix)
from .kv_wire import (KVShipment, pack_blocks,  # noqa: F401
                      unpack_blocks)
from .router import Replica, Router, RouterHTTP  # noqa: F401
from .spec_decode import NgramDrafter, update_spec_k  # noqa: F401

__all__ = ["BucketLadder", "DynamicBatcher", "EngineConfig",
           "ServingEngine", "ServingError", "QueueFullError",
           "DeadlineExceededError", "EngineClosedError",
           "OverloadedError", "GenerationEngine", "GenerationRequest",
           "SlotManager", "ServingHTTPServer", "serve", "BlockPool",
           "PrefixCache", "SCRATCH_BLOCK", "blocks_for_tokens",
           "NgramDrafter", "update_spec_k", "Replica", "Router",
           "RouterHTTP", "FleetPrefixStore", "export_prefix",
           "adopt_prefix", "KVShipment", "pack_blocks", "unpack_blocks"]
