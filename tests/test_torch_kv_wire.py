"""The port's KV wire format (paddle_tpu_torch/serving/kv_wire.py)
against the JAX package's (paddle_tpu/serving/kv_wire.py).

The same pool contents, as numpy arrays in a JAX-side scope and as CPU
tensors in a port Scope, go through both packages' `pack_blocks`: the
JSON must be byte-equal, in float32 and in bfloat16 (the JAX side's
bfloat16 from ml_dtypes, which comes with jax; the port's from the same
bits through torch's int16 view). A shipment packed by either package
is unpacked by the other with every row byte-exact. The malformed and
empty shipments of tests/test_disagg.py raise the same errors and give
the same payload_bytes in both.
"""
import json

import numpy as np
import pytest
import torch

from paddle_tpu.serving import kv_wire as jw
from paddle_tpu_torch.convert import tensor_from_numpy
from paddle_tpu_torch.core.scope import Scope
from paddle_tpu_torch.serving import kv_wire as tw

BLOCK = 4
NAMES = ["k0", "v0", "k1", "v1"]


class _FakeScope:
    def __init__(self, pools):
        self._pools = pools

    def get(self, name):
        return self._pools[name]


def _np_dtype(name):
    if name == "bfloat16":
        import ml_dtypes
        return ml_dtypes.bfloat16
    return np.float32


def _pools(dtype, n_blocks=6, h=2, hd=3):
    """(JAX-side fake scope, port Scope) over the same pool contents."""
    rng = np.random.RandomState(0)
    arrays = {n: rng.randn(n_blocks, BLOCK, h, hd).astype(_np_dtype(dtype))
              for n in NAMES}
    port = Scope()
    for n, a in arrays.items():
        port.set(n, tensor_from_numpy(a, torch.device("cpu")))
    return _FakeScope(arrays), port, arrays


def _bytes(rows):
    """Raw bytes of a numpy or torch row stack."""
    if isinstance(rows, torch.Tensor):
        if rows.dtype == torch.bfloat16:
            rows = rows.view(torch.int16)
        return rows.contiguous().numpy().tobytes()
    return np.ascontiguousarray(rows).tobytes()


CASES = [("float32", [2, 4], ["aa", "bb"]),
         ("float32", [], []),
         ("bfloat16", [1, 3, 5], ["a", "b", "c"]),
         ("bfloat16", [0], ["z"])]


@pytest.mark.parametrize("dtype,ids,hashes", CASES)
def test_pack_is_byte_equal_json(dtype, ids, hashes):
    js, ts, _ = _pools(dtype)
    pj = jw.pack_blocks(js, NAMES, ids, hashes, BLOCK)
    pt = tw.pack_blocks(ts, NAMES, ids, hashes, BLOCK)
    assert json.dumps(pt) == json.dumps(pj)
    assert pt["dtype"] == dtype
    assert tw.payload_bytes(pt) == jw.payload_bytes(pj) == \
        2 * 2 * len(ids) * BLOCK * 2 * 3 * (2 if dtype == "bfloat16" else 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packer", ["jax", "torch"])
def test_unpack_across_packages_byte_exact(dtype, packer):
    """A shipment packed by one package, unpacked by the other (and by
    itself): every row equals the pool's, byte for byte."""
    js, ts, arrays = _pools(dtype)
    ids, hashes = [5, 0, 3], ["x", "y", "z"]
    payload = (jw.pack_blocks(js, NAMES, ids, hashes, BLOCK)
               if packer == "jax"
               else tw.pack_blocks(ts, NAMES, ids, hashes, BLOCK))
    sj, st = jw.unpack_blocks(payload), tw.unpack_blocks(payload)
    assert st.chain_hashes == sj.chain_hashes == hashes
    assert st.shape == sj.shape == (3, BLOCK, 2, 3)
    assert st.dtype == (torch.bfloat16 if dtype == "bfloat16"
                        else torch.float32)
    assert (st.n_blocks, st.n_tokens, st.block_size) == \
        (sj.n_blocks, sj.n_tokens, sj.block_size) == (3, 3 * BLOCK, BLOCK)
    for li, (kn, vn) in enumerate((("k0", "v0"), ("k1", "v1"))):
        for side in (0, 1):
            want = arrays[(kn, vn)[side]][ids].tobytes()
            assert _bytes(st.layers[li][side]) == want
            assert _bytes(sj.layers[li][side]) == want
            assert st.layers[li][side].device.type == "cpu"
    assert tw.rows_digest(payload["layers"]) == tw.rows_digest(st.layers)


def _malformed(good):
    bad_layer = {**good,
                 "layers": [{"k": good["layers"][0]["k"][:8],
                             "v": good["layers"][0]["v"]},
                            good["layers"][1]]}
    return [{**good, "kind": "nope"}, {**good, "version": 99},
            {**good, "chain_hashes": ["a", "b"]}, bad_layer,
            {**good, "shape": [1, 2, 3]}]


@pytest.mark.parametrize("case", range(5))
def test_unpack_rejects_malformed_like_jax(case):
    js, ts, _ = _pools("float32")
    good = tw.pack_blocks(ts, NAMES, [1], ["a"], BLOCK)
    bad = _malformed(good)[case]
    with pytest.raises(ValueError) as ej:
        jw.unpack_blocks(bad)
    with pytest.raises(ValueError) as et:
        tw.unpack_blocks(bad)
    assert str(et.value) == str(ej.value)


def test_pack_rejects_malformed_like_jax():
    js, ts, _ = _pools("float32")
    for scope, pack in ((js, jw.pack_blocks), (ts, tw.pack_blocks)):
        with pytest.raises(ValueError, match="alternate k/v"):
            pack(scope, NAMES[:3], [1], ["a"], BLOCK)   # odd pools
        with pytest.raises(ValueError, match="block ids vs"):
            pack(scope, NAMES, [1, 2], ["a"], BLOCK)    # id/hash skew


def test_empty_shipment():
    js, ts, _ = _pools("float32")
    pt = tw.pack_blocks(ts, NAMES, [], [], BLOCK)
    ship = tw.unpack_blocks(pt)
    assert ship.n_blocks == 0 and ship.n_tokens == 0
    assert tuple(ship.layers[0][0].shape) == (0, BLOCK, 2, 3)
    assert tw.payload_bytes(pt) == 0
    # no pools at all: the JAX package's placeholder shape and dtype
    none_t = tw.pack_blocks(ts, [], [], [], BLOCK)
    assert json.dumps(none_t) == json.dumps(
        jw.pack_blocks(js, [], [], [], BLOCK))
    assert none_t["shape"] == [0, BLOCK, 0, 0] and none_t["layers"] == []
