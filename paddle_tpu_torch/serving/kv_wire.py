"""KV wire format: serialize filled block-table rows for cross-process
transfer.

The JAX package's `serving/kv_wire.py` over this package's torch pools,
with the same payload: for one request prefix, the per-layer paged-KV
pool rows that hold its already-prefilled tokens, the content chain
hashes (`PrefixCache.chunk_hashes`) that name them, and the metadata a
decode worker needs to resume. Payloads are base64 of the raw pool
bytes, so both packages write the same JSON for the same pool contents
and each adopts the other's shipments.

numpy has no bfloat16, so a bfloat16 pool travels as its 16-bit integer
view (``tensor.view(torch.int16)``) and comes back as
``torch.frombuffer(...).view(torch.bfloat16)``: the bytes, and the wire's
``"dtype": "bfloat16"``, are the JAX package's. A `KVShipment`'s rows
are CPU tensors for that reason.

The format rides the serving/http.py JSON protocol (one JSON object per
POST body); no new transport is introduced.
"""
from __future__ import annotations

import base64
import hashlib
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

WIRE_VERSION = 1

# wire dtype names <-> torch dtypes (numpy's names, as the JAX package
# writes them; bfloat16 as ml_dtypes names it)
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32,
           "int64": torch.int64}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _resolve_dtype(name: str) -> torch.dtype:
    """The torch dtype of a dtype name from the wire."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"shipment dtype {name!r} is not supported") \
            from None


def _to_bytes(rows: torch.Tensor) -> bytes:
    """Raw bytes of a CPU tensor, a bfloat16 one through its int16 view."""
    if rows.dtype == torch.bfloat16:
        rows = rows.view(torch.int16)
    return rows.contiguous().numpy().tobytes()


def _from_bytes(raw: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    """A CPU tensor of `shape` over a copy of `raw`."""
    if not raw:
        return torch.empty(shape, dtype=dtype)
    view = torch.int16 if dtype == torch.bfloat16 else dtype
    return torch.frombuffer(bytearray(raw), dtype=view).view(
        dtype).reshape(shape)


@dataclass
class KVShipment:
    """Decoded wire payload: per-layer (k, v) row stacks of shape
    [n_blocks, block_size, n_heads, head_dim], CPU tensors."""
    version: int
    block_size: int
    n_tokens: int
    dtype: torch.dtype
    shape: Tuple[int, int, int, int]
    chain_hashes: List[str]
    layers: List[Tuple[torch.Tensor, torch.Tensor]]

    @property
    def n_blocks(self) -> int:
        return self.shape[0]


def pack_blocks(scope, cache_names: Sequence[str],
                block_ids: Sequence[int],
                chain_hashes: Sequence[str],
                block_size: int) -> dict:
    """Serialize pool rows `block_ids` from every paged KV pool in
    `cache_names` (alternating k, v per layer) into a JSON-safe dict.

    `chain_hashes[i]` must be the content hash of the tokens stored in
    `block_ids[i]`; the adopting side keys its PrefixCache on them. The
    rows are read with one indexed gather a pool on the pools' device
    and copied to the host once.
    """
    if len(cache_names) % 2 != 0:
        raise ValueError(
            f"cache_names must alternate k/v pools, got {len(cache_names)}")
    if len(block_ids) != len(chain_hashes):
        raise ValueError(
            f"{len(block_ids)} block ids vs {len(chain_hashes)} hashes")
    ids = [int(b) for b in block_ids]
    layers = []
    shape = None
    dtype = torch.float32
    if cache_names:
        pools = [scope.get(name) for name in cache_names]
        idx = torch.tensor(ids, dtype=torch.int64, device=pools[0].device)
        rows = torch.stack([p.index_select(0, idx) for p in pools]).cpu()
        shape, dtype = tuple(rows.shape[1:]), rows.dtype
        layers = [base64.b64encode(_to_bytes(r)).decode("ascii")
                  for r in rows]
    else:
        shape = (len(ids), block_size, 0, 0)
    return {
        "kind": "kv_shipment",
        "version": WIRE_VERSION,
        "block_size": int(block_size),
        "n_blocks": len(ids),
        "n_tokens": len(ids) * int(block_size),
        "dtype": _NAMES[dtype],
        "shape": [int(d) for d in shape],
        "chain_hashes": list(chain_hashes),
        "layers": [{"k": layers[i], "v": layers[i + 1]}
                   for i in range(0, len(layers), 2)],
    }


def unpack_blocks(payload: dict) -> KVShipment:
    """Decode a `pack_blocks` dict back into CPU row stacks.

    Raises ValueError on malformed payloads (wrong kind/version,
    truncated buffers) so http.py can map it to a 400.
    """
    if payload.get("kind") != "kv_shipment":
        raise ValueError("not a kv_shipment payload")
    if payload.get("version") != WIRE_VERSION:
        raise ValueError(
            f"kv_shipment version {payload.get('version')!r}, "
            f"expected {WIRE_VERSION}")
    shape = tuple(int(d) for d in payload["shape"])
    if len(shape) != 4:
        raise ValueError(f"bad shipment shape {shape}")
    dtype = _resolve_dtype(str(payload["dtype"]))
    hashes = [str(h) for h in payload["chain_hashes"]]
    if len(hashes) != shape[0]:
        raise ValueError(
            f"{len(hashes)} chain hashes for {shape[0]} blocks")
    want = _numel(shape) * _itemsize(dtype)
    layers: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for layer in payload["layers"]:
        pair = []
        for key in ("k", "v"):
            raw = base64.b64decode(layer[key])
            if len(raw) != want:
                raise ValueError(
                    f"layer {key} buffer is {len(raw)} bytes, "
                    f"expected {want}")
            pair.append(_from_bytes(raw, dtype, shape))
        layers.append((pair[0], pair[1]))
    return KVShipment(
        version=WIRE_VERSION,
        block_size=int(payload["block_size"]),
        n_tokens=int(payload["n_tokens"]),
        dtype=dtype,
        shape=shape,  # type: ignore[arg-type]
        chain_hashes=hashes,
        layers=layers)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def payload_bytes(payload: dict) -> int:
    """Raw KV bytes carried by a packed shipment (excludes base64 and
    JSON overhead): n_layers * 2 pools * prod(shape) * itemsize."""
    shape = [int(d) for d in payload.get("shape", ())]
    if len(shape) != 4:
        return 0
    dtype = _resolve_dtype(str(payload.get("dtype", "float32")))
    per_pool = _numel(shape) * _itemsize(dtype)
    return per_pool * 2 * len(payload.get("layers", ()))


def rows_digest(layers) -> str:
    """sha256 over a shipment's rows in wire order (per layer k then v):
    the same hex for a payload's rows and for the pool rows they were
    adopted into when the bytes are equal. `layers` is a payload's
    "layers" list or [(k, v)] CPU tensors."""
    h = hashlib.sha256()
    for layer in layers:
        if isinstance(layer, dict):
            h.update(base64.b64decode(layer["k"]))
            h.update(base64.b64decode(layer["v"]))
        else:
            for rows in layer:
                h.update(_to_bytes(rows))
    return h.hexdigest()
