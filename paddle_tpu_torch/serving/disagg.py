"""Disaggregated prefill/decode serving: cross-process KV transfer and
the fleet-level content-addressed prefix store.

The JAX package's `serving/disagg.py` over this package's engines, with
the same stat names:

- `export_prefix(engine, prompt)`: on a *prefill* worker, make sure a
  prompt's full blocks are resident in the local PrefixCache (running
  chunked prefill through the engine if they are not), then pack those
  pool rows into a `kv_wire` shipment.
- `adopt_prefix(engine, payload)`: on a *decode* worker, unpack a
  shipment into freshly allocated BlockPool blocks and register them in
  the local PrefixCache under their chain hashes — the normal
  refcount/incref path, so eviction and sharing work exactly as for
  locally prefilled blocks, and the next `submit` of a matching prompt
  takes the ordinary prefix-hit path with no new executor cache entry.
- `FleetPrefixStore`: the router-side registry mapping chain hashes to
  the replica names that hold them, so two-phase dispatch can skip the
  prefill hop when the target decode worker already owns the prefix, or
  fetch it from whichever peer does.

Determinism: same weights + same tokens + same absolute positions +
same program on the same device give bit-identical KV, so a decode
worker continuing on adopted blocks emits exactly the tokens the
unified engine would.

Engine access is serialized against the engine's worker thread via
`engine._kv_mutex` (held by the worker around admission and each paged
iteration), because BlockPool/PrefixCache are not thread-safe on their
own. The paged step returns new pool tensors each iteration (the JAX
package's donates them), so an export or adopt reads the tensor the
scope holds under the mutex, never one fetched before; adopt writes its
rows with `index_copy_` into those tensors on the pool's device.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Set

import torch

from ..core.flags import FLAGS
from ..monitor import STAT_ADD
from . import kv_wire
from .kv_blocks import PrefixCache

__all__ = ["export_prefix", "adopt_prefix", "resident_rows_digest",
           "FleetPrefixStore"]


def _require_paged(engine):
    if not getattr(engine, "paged", False):
        raise ValueError(
            "disaggregated KV transfer needs a paged engine "
            "(FLAGS_gen_paged_kv / paged=True)")


def _resident_depth(engine, prompt: Sequence[int]) -> int:
    """How many leading full blocks of `prompt` the local PrefixCache
    holds right now. Caller must hold engine._kv_mutex."""
    n_full = len(prompt) // engine.block_size
    if n_full == 0:
        return 0
    n_tok, ids = engine._prefix.lookup(
        list(prompt), max_tokens=n_full * engine.block_size)
    for bid in ids:
        engine._pool.decref(bid)
    return len(ids)


def export_prefix(engine, prompt: Sequence[int],
                  run_prefill: bool = True) -> dict:
    """Pack the full-block prefix of `prompt` into a kv_wire shipment.

    If the prefix is not resident and `run_prefill` is true, this runs
    one generation step through the engine (chunked prefill registers
    every full prompt block in the PrefixCache before the first token
    is returned) — the prefill worker's actual job.
    """
    _require_paged(engine)
    prompt = [int(t) for t in prompt]
    n_full = len(prompt) // engine.block_size
    if n_full == 0:
        with engine._kv_mutex:
            return kv_wire.pack_blocks(
                engine.scope, engine.step.cache_names, [], [],
                engine.block_size)
    with engine._kv_mutex:
        resident = _resident_depth(engine, prompt)
    if resident < n_full:
        if not run_prefill:
            raise ValueError(
                f"prefix not resident ({resident}/{n_full} blocks) and "
                "run_prefill=False")
        # One token is enough: _register_prefix runs at first-token
        # time, before generate() returns.
        engine.generate(prompt, 1)
    with engine._kv_mutex:
        n_tok, ids = engine._prefix.lookup(
            prompt, max_tokens=n_full * engine.block_size)
        try:
            hashes = PrefixCache.chunk_hashes(
                prompt[:len(ids) * engine.block_size], engine.block_size)
            payload = kv_wire.pack_blocks(
                engine.scope, engine.step.cache_names, ids, hashes,
                engine.block_size)
        finally:
            for bid in ids:
                engine._pool.decref(bid)
        engine._set_block_gauges()
    STAT_ADD("serving.kv_xfer_exports")
    return payload


def _row_spec(dtype, shape) -> str:
    return f"{kv_wire._NAMES.get(dtype, dtype)}{list(shape)}"


def adopt_prefix(engine, payload: dict) -> dict:
    """Unpack a shipment into the engine's BlockPool + PrefixCache.

    Blocks whose chain hash is already cached locally are skipped
    (duplicate); new blocks go through the normal alloc → insert
    (cache incref) path so they are owned by the cache at refcount 1
    and evictable under pressure like any other prefix.  Pool
    exhaustion stops adoption early — a leading sub-chain is still a
    valid prefix, the decode worker just re-prefills the tail.
    """
    _require_paged(engine)
    ship = payload if isinstance(payload, kv_wire.KVShipment) \
        else kv_wire.unpack_blocks(payload)
    if ship.block_size != engine.block_size:
        raise ValueError(
            f"shipment block_size {ship.block_size} != engine "
            f"block_size {engine.block_size}")
    names = engine.step.cache_names
    if 2 * len(ship.layers) != len(names):
        raise ValueError(
            f"shipment has {len(ship.layers)} layers, engine has "
            f"{len(names) // 2}")
    adopted = 0
    dup = 0
    with engine._kv_mutex:
        # the tensors the scope holds now: the last iteration replaced
        # the ones any earlier read saw
        pools = [engine.scope.get(n) for n in names]
        if ship.n_blocks and ship.layers:
            pool0 = pools[0]
            if ship.dtype != pool0.dtype or \
                    tuple(ship.shape[1:]) != tuple(pool0.shape[1:]):
                raise ValueError(
                    f"shipment rows "
                    f"{_row_spec(ship.dtype, ship.shape[1:])} "
                    f"!= pool rows {_row_spec(pool0.dtype, pool0.shape[1:])}")
        # block id -> the shipment row it takes; a block evicted and
        # reallocated within this adoption keeps its last row, as
        # sequential writes would leave it
        rows: Dict[int, int] = {}
        for j, h in enumerate(ship.chain_hashes):
            if h in engine._prefix._entries:
                dup += 1
                engine._prefix._entries.move_to_end(h)
                continue
            bid = engine._alloc_block()
            if bid is None:
                break  # pool exhausted; keep the leading sub-chain
            rows.pop(bid, None)
            rows[bid] = j
            engine._prefix.insert(h, bid)   # cache takes its ref (-> 2)
            engine._pool.decref(bid)        # drop ours (-> 1, cache-held)
            adopted += 1
        if rows:
            device = pools[0].device
            dst = torch.tensor(list(rows), dtype=torch.int64, device=device)
            src = torch.tensor(list(rows.values()), dtype=torch.int64)
            for li, pair in enumerate(ship.layers):
                for pool, arr in zip(pools[2 * li:2 * li + 2], pair):
                    pool.index_copy_(0, dst, arr.index_select(0, src)
                                     .to(device))
        resident = 0
        for h in ship.chain_hashes:
            if h in engine._prefix._entries:
                resident += 1
            else:
                break
        engine._set_block_gauges()
    STAT_ADD("serving.kv_xfer_adopted_blocks", adopted)
    if dup:
        STAT_ADD("serving.kv_xfer_dup_blocks", dup)
    return {"adopted": adopted, "duplicate": dup, "resident": resident,
            "blocks": ship.n_blocks, "n_tokens": ship.n_tokens,
            "block_size": ship.block_size}


def resident_rows_digest(engine, chain_hashes: Sequence[str]) -> dict:
    """sha256 of the pool rows the engine's PrefixCache holds for the
    leading resident `chain_hashes`, in wire order (`kv_wire.rows_digest`):
    equal to an adopted shipment's digest when the adopted rows are the
    shipped bytes. Returns {"blocks": resident count, "sha256": hex}."""
    with engine._kv_mutex:
        ids = []
        for h in chain_hashes:
            bid = engine._prefix._entries.get(h)
            if bid is None:
                break
            ids.append(bid)
        names = engine.step.cache_names
        pools = [engine.scope.get(n) for n in names]
        idx = torch.tensor(ids, dtype=torch.int64, device=pools[0].device)
        rows = torch.stack([p.index_select(0, idx) for p in pools]).cpu()
    layers = [(rows[i], rows[i + 1]) for i in range(0, len(names), 2)]
    return {"blocks": len(ids), "sha256": kv_wire.rows_digest(layers)}


class FleetPrefixStore:
    """Router-side content-addressed registry: chain hash -> replica
    names that hold the block. LRU-bounded; thread-safe."""

    def __init__(self, max_entries: Optional[int] = None):
        self._max = int(FLAGS.disagg_fleet_prefix_max
                        if max_entries is None else max_entries)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Set[str]]" = OrderedDict()
        self._block_size: Optional[int] = None

    @property
    def block_size(self) -> Optional[int]:
        return self._block_size

    def learn_block_size(self, block_size: int):
        if block_size and block_size > 0:
            self._block_size = int(block_size)

    def register(self, hashes: Iterable[str], owner: str):
        with self._lock:
            for h in hashes:
                owners = self._entries.get(h)
                if owners is None:
                    owners = set()
                    self._entries[h] = owners
                owners.add(owner)
                self._entries.move_to_end(h)
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)

    def owned_depth(self, hashes: Sequence[str], owner: str) -> int:
        """Leading count of `hashes` registered to `owner`."""
        with self._lock:
            depth = 0
            for h in hashes:
                owners = self._entries.get(h)
                if owners is None or owner not in owners:
                    break
                depth += 1
            return depth

    def chain_owner(self, hashes: Sequence[str],
                    exclude: Iterable[str] = ()) -> Optional[str]:
        """A replica (not in `exclude`) that owns the WHOLE leading
        chain, or None."""
        if not hashes:
            return None
        skip = set(exclude)
        with self._lock:
            candidates: Optional[Set[str]] = None
            for h in hashes:
                owners = self._entries.get(h)
                if not owners:
                    return None
                live = {o for o in owners if o not in skip}
                candidates = live if candidates is None \
                    else candidates & live
                if not candidates:
                    return None
            return sorted(candidates)[0] if candidates else None

    def drop_owner(self, owner: str):
        """Forget every block owned by `owner` (replica removed/died)."""
        with self._lock:
            dead = []
            for h, owners in self._entries.items():
                owners.discard(owner)
                if not owners:
                    dead.append(h)
            for h in dead:
                del self._entries[h]

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries),
                    "owners": len({o for owners in self._entries.values()
                                   for o in owners}),
                    "block_size": self._block_size or 0}
