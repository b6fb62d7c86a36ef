"""Paged KV-cache bookkeeping: block pool, block tables, prefix cache.

The device side holds ONE physical pool per layer — `[num_blocks,
block_size, h, hd]` persistable tensors built by
`models/gpt.build_paged_decode_step` — and this module owns the
host-side metadata. It is the JAX package's `serving/kv_blocks.py`,
pure Python, kept as this package's own copy.

* `BlockPool` — free-list allocator over the physical block ids with
  per-block refcounts. Physical block 0 is reserved as the SCRATCH
  block: muted decode rows route their (gated-off) writes there, so the
  fixed-shape graph never needs a conditional write path. A block with
  refcount > 1 is SHARED; only *full, immutable* prompt blocks are ever
  shared (the prefix cache below), so a write never targets a shared
  block and no device-side copy op is required. A finished slot decrefs
  its table and only unreferenced blocks return to the free list.

* `PrefixCache` — content-addressed map from a *chain hash* of prompt
  token blocks to the physical block already holding that KV. The hash
  of block j covers (hash of block j-1, tokens of block j), so a lookup
  can only match a prefix chain, never an interior block. The cache
  holds its own ref on every cached block; LRU eviction (oldest entry
  whose block nobody else references) runs when the pool is short.

Everything here is owned by one thread (the scheduler's), so there is
no internal locking.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

__all__ = ["SCRATCH_BLOCK", "BlockPool", "PrefixCache",
           "blocks_for_tokens"]

# physical block 0: never allocated, never read — the write sink for
# muted rows in the fixed-shape paged graphs
SCRATCH_BLOCK = 0


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold `n_tokens` KV positions (ceil)."""
    if n_tokens <= 0:
        return 0
    return -(-int(n_tokens) // int(block_size))


class BlockPool:
    """Free-list + refcount allocator over `num_blocks` physical blocks.

    Ids run 1..num_blocks-1 (block 0 is `SCRATCH_BLOCK`). `alloc()`
    hands out the lowest free id first — deterministic, like
    `SlotManager` — with refcount 1; `incref`/`decref` manage sharing,
    and `decref` to zero returns the block to the free list.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError(
                f"BlockPool: need >= 2 blocks (1 scratch + 1 usable), "
                f"got {num_blocks}")
        if block_size < 1:
            raise ValueError(
                f"BlockPool: block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        # pop() returns the lowest id first
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref = [0] * self.num_blocks

    def capacity(self) -> int:
        """Allocatable blocks (scratch excluded)."""
        return self.num_blocks - 1

    def free_count(self) -> int:
        return len(self._free)

    def used_count(self) -> int:
        return self.capacity() - len(self._free)

    def refcount(self, block_id: int) -> int:
        return self._ref[block_id]

    def alloc(self) -> Optional[int]:
        """Lowest free block id with refcount 1, or None when empty."""
        if not self._free:
            return None
        bid = self._free.pop()
        self._ref[bid] = 1
        return bid

    def incref(self, block_id: int):
        if block_id == SCRATCH_BLOCK or self._ref[block_id] < 1:
            raise ValueError(
                f"BlockPool: incref of unallocated block {block_id}")
        self._ref[block_id] += 1

    def decref(self, block_id: int):
        if block_id == SCRATCH_BLOCK or self._ref[block_id] < 1:
            raise ValueError(
                f"BlockPool: decref of unallocated block {block_id}")
        self._ref[block_id] -= 1
        if self._ref[block_id] == 0:
            self._free.append(block_id)
            self._free.sort(reverse=True)


class PrefixCache:
    """Chain-hash -> physical-block map for shared-prefix reuse.

    The cache owns one refcount on every entry's block, so cached KV
    survives the slot that produced it; `evict_lru()` releases the
    oldest entry whose block only the cache still references.
    """

    def __init__(self, pool: BlockPool):
        self.pool = pool
        # chain_hash -> block_id, in LRU order (move_to_end on touch)
        self._entries: "OrderedDict[str, int]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def chunk_hashes(tokens: Sequence[int], block_size: int) -> List[str]:
        """One chain hash per FULL block of `tokens`: hash j covers
        (hash j-1, tokens of block j), so equal hashes imply equal
        whole prefixes. Partial tail blocks are not hashable — they are
        still mutable."""
        out: List[str] = []
        parent = b""
        n_full = len(tokens) // block_size
        for j in range(n_full):
            blk = tokens[j * block_size:(j + 1) * block_size]
            h = hashlib.sha1(
                parent + b"|" +
                b",".join(str(int(t)).encode() for t in blk)).hexdigest()
            out.append(h)
            parent = h.encode()
        return out

    def lookup(self, tokens: Sequence[int],
               max_tokens: Optional[int] = None) -> Tuple[int, List[int]]:
        """Longest cached prefix of `tokens` in full blocks.

        Returns (n_cached_tokens, block_ids); every returned block is
        incref'd FOR THE CALLER (a slot adopting them into its table
        releases them with `decref` like owned blocks). `max_tokens`
        caps the match (a prompt's last position must stay writable, so
        callers pass len(prompt) - 1).
        """
        bs = self.pool.block_size
        limit = len(tokens) if max_tokens is None else min(
            len(tokens), int(max_tokens))
        ids: List[int] = []
        for h in self.chunk_hashes(tokens[:limit], bs):
            bid = self._entries.get(h)
            if bid is None:
                break
            ids.append(bid)
            self._entries.move_to_end(h)
        for bid in ids:
            self.pool.incref(bid)
        return len(ids) * bs, ids

    def insert(self, chain_hash: str, block_id: int) -> bool:
        """Register a finished full prompt block. Returns False when the
        hash is already cached (first writer wins — the caller's block
        stays private to its slot)."""
        if chain_hash in self._entries:
            self._entries.move_to_end(chain_hash)
            return False
        self.pool.incref(block_id)
        self._entries[chain_hash] = block_id
        return True

    def evict_lru(self) -> Optional[int]:
        """Drop the oldest entry whose block only the cache holds
        (refcount == 1); returns the freed block id, or None when every
        cached block is still in use by a live slot."""
        for h, bid in self._entries.items():
            if self.pool.refcount(bid) == 1:
                del self._entries[h]
                self.pool.decref(bid)
                return bid
        return None

    def evictable_count(self) -> int:
        return sum(1 for bid in self._entries.values()
                   if self.pool.refcount(bid) == 1)
