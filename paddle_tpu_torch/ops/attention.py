"""The fused attention ops: flash_attention and paged_attention.

Routing is the JAX package's (its ops/attention.py): ``block_q == 0``
and attention dropout outside ``is_test`` take the exact plain path;
everything else takes ``flash_attention()``, which launches the Hopper
kernel for CUDA tensors.

``paged_attention`` is the decode-side sibling: incremental attention
over a block-table paged KV pool. The JAX package builds it from XLA
scatter and gather, so here it is plain torch ops (indexing, two batched
products, softmax), with no hand kernel.
"""
from __future__ import annotations

import torch

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


@register_op("paged_attention", stateful=True,
             nondiff_inputs=("BlockTable", "StartPos", "NValid"))
def _paged_attention_op(ctx, ins, attrs):
    """Incremental attention over a block-table paged KV pool.

    One call both WRITES this step's new K/V into the physical pool and
    READS the row's whole logical history back out of it:

      Q/K/V        [B, H, T, hd]   T new tokens per row (decode: T=1,
                                   chunked prefill: T=block_size)
      CacheK/V     [nb, bs, H, hd] the physical pool
      BlockTable   [B, max_blocks] logical block j of row b lives in
                                   physical block BlockTable[b, j]
      StartPos     [B]             position of the row's first new token
      NValid       [B]             how many of the T tokens are real;
                                   0 mutes the row entirely

    Positions past NValid write to physical block 0, the scratch block
    that no table maps, so the op is total over its fixed shape. Several
    such rows write the same scratch row: which one lands there is left
    undefined (an index_put with duplicate indices), and nothing reads
    it. Reads gather each row's blocks in logical order, so key position
    j*bs+o carries the row's j-th block at offset o; the causal mask
    (key_pos <= query_pos) is the slab path's additive keep*1e30 - 1e30,
    so masked lanes are exact zeros after the softmax. The pools come
    out as new tensors (CacheKOut/CacheVOut); the inputs are not written.
    """
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    cache_k, cache_v = ins["CacheK"][0], ins["CacheV"][0]
    table = ins["BlockTable"][0].long()
    start = ins["StartPos"][0].long()
    nvalid = ins["NValid"][0].long()
    nb, bs, nh, hd = cache_k.shape
    B, H, T, _ = q.shape
    max_blocks = table.shape[1]
    max_t = max_blocks * bs
    sm_scale = attrs.get("sm_scale") or float(hd) ** -0.5

    steps = torch.arange(T, device=q.device)
    qpos = start[:, None] + steps[None, :]               # [B, T]
    valid = steps[None, :] < nvalid[:, None]             # [B, T]
    # positions past NValid may run past the table: clamp their (unused)
    # block index into range
    blk = torch.clamp(qpos // bs, 0, max_blocks - 1)
    phys = torch.take_along_dim(table, blk, dim=1)
    flat_idx = torch.where(valid, phys * bs + qpos % bs,
                           torch.zeros_like(qpos)).reshape(-1)

    def write(pool, new):                                # new [B,H,T,hd]
        flat = pool.reshape(nb * bs, nh, hd).clone()
        flat[flat_idx] = new.transpose(1, 2).reshape(B * T, nh, hd) \
            .to(flat.dtype)
        return flat.reshape(nb, bs, nh, hd)

    ck_new = write(cache_k, k)
    cv_new = write(cache_v, v)

    # each row's logical history: [B, max_blocks, bs, H, hd] ->
    # [B, H, max_t, hd]; entries past qpos are stale or scratch and die
    # under the mask below
    def history(pool):
        return pool[table].reshape(B, max_t, nh, hd).transpose(1, 2)

    keys, vals = history(ck_new), history(cv_new)
    scores = torch.matmul(q, keys.transpose(-1, -2)) * sm_scale
    kpos = torch.arange(max_t, device=q.device)
    keep = (kpos[None, None, :] <= qpos[:, :, None]).to(scores.dtype)
    scores = scores + (keep * 1e30 - 1e30)[:, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, vals)
    return {"Out": [out], "CacheKOut": [ck_new], "CacheVOut": [cv_new]}
