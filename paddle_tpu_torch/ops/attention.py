"""The fused attention op: flash_attention.

Routing is the JAX package's (its ops/attention.py): ``block_q == 0``
and attention dropout outside ``is_test`` take the exact plain path;
everything else takes ``flash_attention()``, which launches the Hopper
kernel for CUDA tensors. ``paged_attention`` waits for the generation
slice.
"""
from __future__ import annotations

from ..core.registry import register_op
from .cuda.flash_attention import flash_attention, reference_attention

# use_flash="auto" crossover of models/transformer.py, the JAX package's
# value: below this max_seq_len the encoder writes block_q=0 and the op
# takes the plain path
FLASH_AUTO_MIN_SEQ = 4096


@register_op("flash_attention", stateful=True)
def _flash_attention_op(ctx, ins, attrs):
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    causal = attrs.get("causal", False)
    sm_scale = attrs.get("sm_scale", None)
    dropout = 0.0 if ctx.is_test else attrs.get("attn_dropout", 0.0)
    if attrs.get("block_q") == 0 or dropout:
        # explicit exact-path request, or attention dropout (the kernel
        # has no dropout path): the plain version, same mask and numerics
        out = reference_attention(
            q, k, v, causal=causal, sm_scale=sm_scale, dropout=dropout,
            generator=ctx.generator if dropout else None)
    else:
        out = flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                              block_q=attrs.get("block_q"),
                              block_k=attrs.get("block_k"))
    return {"Out": [out]}
