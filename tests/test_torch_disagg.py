"""The port's disaggregated prefill/decode (paddle_tpu_torch/serving/
disagg.py) against the JAX package's (paddle_tpu/serving/disagg.py).

A tiny GPT (d 32, 4 heads, 2 layers, vocab 16, max_seq 12) is trained
by the JAX package on the cyclic-successor task, as in
tests/test_disagg.py, and carried into the port with
`convert.scope_from_numpy`: any decode that continues on shipped KV
blocks it should not shows as a wrong token, never a tolerance. Each
engine gets a scope of its own (a replica process's stand-in), block 4.

- The port's export adopted by the port, a JAX export adopted by the
  port and a port export adopted by the JAX package: each adopting
  engine decodes the JAX serial stream, with the prefix counted as
  cached, no new executor cache entry, cache-held refcounts and pool
  rows byte-equal to the shipment; re-adoption is a pure duplicate.
- The same under eviction: a pool of 8 blocks where the adopted prefix
  must compete with live decode state.
- `FleetPrefixStore` gives the JAX store's answers on one script.
- The stat names of a disaggregated router run, and of its fallback,
  equal the JAX package's.
- The deliberate difference: the port's worker admits requests under
  `_kv_mutex`, which an adopt holds while it fills the pool.
"""
import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu import monitor as jmon
from paddle_tpu.models import gpt as gj
from paddle_tpu.serving import FleetPrefixStore as JStore
from paddle_tpu.serving import GenerationEngine as JEngine
from paddle_tpu.serving import PrefixCache
from paddle_tpu.serving import Replica as JReplica
from paddle_tpu.serving import Router as JRouter
from paddle_tpu.serving import disagg as jd
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.models import gpt as gt
from paddle_tpu_torch.serving import FleetPrefixStore as TStore
from paddle_tpu_torch.serving import GenerationEngine as TEngine
from paddle_tpu_torch.serving import Replica as TReplica
from paddle_tpu_torch.serving import Router as TRouter
from paddle_tpu_torch.serving import disagg as td
from paddle_tpu_torch.serving import kv_wire as tw

from test_torch_observability import reset_globals

VOCAB, SEQ, BLOCK = 16, 12, 4
DEADLINE_MS = 120000.0


def _cfg(g):
    return g.gpt_small(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2,
                       d_ff=64, max_seq_len=SEQ, dropout=0.0,
                       use_flash=False)


@pytest.fixture(scope="module")
def trained():
    """The trained JAX parameters {name: array}: greedy continuation of
    [.., c] is [(c+1) % VOCAB, (c+2) % VOCAB, ...]."""
    main, startup = fj.Program(), fj.Program()
    startup.random_seed = 11
    scope = fj.Scope()
    with fj.program_guard(main, startup), fj.scope_guard(scope):
        loss, _, _ = gj.build_train(_cfg(gj), batch=8, seq_len=SEQ,
                                    lr=5e-3)
        exe = fj.Executor(fj.CPUPlace())
        exe.run(startup)
        base = np.arange(SEQ) % VOCAB
        toks = np.stack([(base + i) % VOCAB for i in range(8)]) \
            .astype(np.int64)
        for _ in range(40):
            exe.run(main, feed={"tokens": toks}, fetch_list=[loss])
    return {n: np.array(np.asarray(scope.get(n))) for n in scope.names()
            if scope.find_var(n) is not None}


@pytest.fixture(autouse=True)
def _hygiene():
    reset_globals()
    yield
    reset_globals()


def _jengine(params, **kw):
    scope = fj.Scope()
    for n, a in params.items():
        scope.var(n)
        scope.set(n, np.array(a))
    return JEngine(_cfg(gj), scope, exe=fj.Executor(fj.CPUPlace()),
                   max_slots=2, max_seq=SEQ, block_size=BLOCK, paged=True,
                   default_timeout_ms=DEADLINE_MS, **kw)


def _tengine(params, **kw):
    return TEngine(_cfg(gt), scope_from_numpy(params, ft.Scope(),
                                              ft.CPUPlace()),
                   exe=ft.Executor(ft.CPUPlace()), max_slots=2,
                   max_seq=SEQ, block_size=BLOCK, paged=True,
                   default_timeout_ms=DEADLINE_MS, **kw)


_SERIAL = {}


def _serial(params, prompt, n):
    """The JAX package's serial slab kv_generate stream (one decode
    program and scope for the module: the step resets its state in the
    graph)."""
    if not _SERIAL:
        scope = fj.Scope()
        for name, a in params.items():
            scope.var(name)
            scope.set(name, np.array(a))
        main, startup = fj.Program(), fj.Program()
        with fj.program_guard(main, startup):
            step = gj.build_decode_step(_cfg(gj), batch=1, max_seq=SEQ)
        _SERIAL.update(exe=fj.Executor(fj.CPUPlace()), scope=scope,
                       main=main, step=step)
    c = _SERIAL
    return gj.kv_generate(c["exe"], c["scope"], c["main"],
                          c["step"].token_var, c["step"].logits_var,
                          c["step"].cache_names, prompt=prompt,
                          max_new_tokens=n)


@pytest.fixture(scope="module")
def fleet(trained):
    """Started engines: JAX "jp" (exports) and "jd" (adopts), port "tp"
    (exports) and "td" (adopts); stopped after the module. The tests
    use prompts of their own, so the engines' prefix caches do not
    meet."""
    engines = {"jp": _jengine(trained), "jd": _jengine(trained),
               "tp": _tengine(trained), "td": _tengine(trained)}
    for e in engines.values():
        e.start()
    yield engines
    for e in engines.values():
        e.stop()


def _pool_rows(eng, name, bid):
    """Bytes of one pool row of either package's engine."""
    v = eng.scope.get(name)
    return (v[bid].contiguous().numpy() if hasattr(v, "contiguous")
            else np.asarray(v)[bid]).tobytes()


# exporter, adopter: the port's own hop, and both directions across the
# packages
HOPS = [("tp", "td"), ("jp", "td"), ("tp", "jd")]


@pytest.mark.parametrize("src,dst", HOPS, ids=["-".join(h) for h in HOPS])
def test_export_adopt_decodes_the_serial_stream(trained, fleet, src, dst):
    start = HOPS.index((src, dst)) + 1
    prompt = [(start + i) % VOCAB for i in range(2 * BLOCK + 1)]
    want = _serial(trained, prompt, 3)
    exporter, adopter = fleet[src], fleet[dst]
    export = td.export_prefix if src[0] == "t" else jd.export_prefix
    adopt = td.adopt_prefix if dst[0] == "t" else jd.adopt_prefix
    payload = export(exporter, prompt)
    assert payload["n_blocks"] == 2 and payload["dtype"] == "float32"
    assert payload["chain_hashes"] == PrefixCache.chunk_hashes(
        prompt[:2 * BLOCK], BLOCK)
    res = adopt(adopter, payload)
    assert res == {"adopted": 2, "duplicate": 0, "resident": 2,
                   "blocks": 2, "n_tokens": 2 * BLOCK, "block_size": BLOCK}
    ship = tw.unpack_blocks(payload)
    names = adopter.step.cache_names
    for j, h in enumerate(ship.chain_hashes):
        bid = adopter._prefix._entries[h]
        assert adopter._pool.refcount(bid) == 1
        for li, (k, v) in enumerate(ship.layers):
            assert _pool_rows(adopter, names[2 * li], bid) == \
                k[j].numpy().tobytes()
            assert _pool_rows(adopter, names[2 * li + 1], bid) == \
                v[j].numpy().tobytes()
    again = adopt(adopter, payload)
    assert again["adopted"] == 0 and again["duplicate"] == 2
    out = adopter.generate(prompt, 3)
    assert out["tokens"] == want
    assert out["cached_tokens"] == 2 * BLOCK
    assert exporter.post_warmup_compiles() == 0
    assert adopter.post_warmup_compiles() == 0
    if dst == "td":
        digest = td.resident_rows_digest(adopter, ship.chain_hashes)
        assert digest == {"blocks": 2,
                          "sha256": tw.rows_digest(payload["layers"])}


def test_export_without_prefill_and_short_prompts(fleet):
    eng = fleet["tp"]
    with pytest.raises(ValueError, match="not resident"):
        td.export_prefix(eng, [7] * (2 * BLOCK), run_prefill=False)
    short = td.export_prefix(eng, [1, 2, 3])
    assert short["n_blocks"] == 0 and short["layers"][0]["k"] == ""


def test_adopt_validation_matches_jax(fleet):
    """Shipments the engine cannot take raise the JAX package's
    ValueErrors, word for word."""
    from paddle_tpu_torch.core.scope import Scope

    rng = np.random.RandomState(0)
    pools = {n: rng.randn(6, BLOCK, 2, 3).astype(np.float32)
             for n in ("k0", "v0", "k1", "v1")}
    scope = Scope()
    for n, a in pools.items():
        scope.set(n, ft.convert.tensor_from_numpy(a, "cpu"))
    names = list(pools)
    cases = [tw.pack_blocks(scope, names, [1], ["a"], BLOCK + 1),
             tw.pack_blocks(scope, names[:2], [1], ["a"], BLOCK),
             tw.pack_blocks(scope, names, [1], ["a"], BLOCK)]
    for payload in cases:
        with pytest.raises(ValueError) as ej:
            jd.adopt_prefix(fleet["jd"], payload)
        with pytest.raises(ValueError) as et:
            td.adopt_prefix(fleet["td"], payload)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("src", ["tp", "jp"])
def test_adopted_decode_under_eviction(trained, fleet, src):
    """8 blocks, block 0 reserved: 2 slots x 3 blocks of live decode
    state and the 2 adopted blocks fit only through eviction."""
    first = 10 if src == "tp" else 12
    prefix = [(first + i) % VOCAB for i in range(2 * BLOCK)]
    export = td.export_prefix if src == "tp" else jd.export_prefix
    payload = export(fleet[src], prefix + [3])
    prompts = [prefix + [3], prefix + [4], [5, 6, 7]]
    want = [_serial(trained, p, 3) for p in prompts]
    eng = _tengine(trained, kv_pool_blocks=8)
    eng.start()
    try:
        assert td.adopt_prefix(eng, payload)["adopted"] == 2
        outs = [eng.generate(p, 3) for p in prompts]
        assert [o["tokens"] for o in outs] == want
        assert outs[0]["cached_tokens"] == 2 * BLOCK
        assert eng.post_warmup_compiles() == 0
    finally:
        eng.stop()


def test_fleet_prefix_store_like_jax():
    """One script through both stores: depth, owner, exclusion,
    drop_owner and the LRU bound answer alike."""
    def script(store):
        seen = [store.block_size, len(store)]
        store.learn_block_size(8)
        store.learn_block_size(0)
        seen.append(store.block_size)
        store.register(["h1", "h2"], "d0")
        seen += [store.owned_depth(["h1", "h2"], "d0"),
                 store.owned_depth(["h1", "h2", "h3"], "d0"),
                 store.owned_depth(["h1", "h2"], "d1"),
                 store.chain_owner(["h1", "h2"]),
                 store.chain_owner(["h1", "h2", "h3"]),
                 store.chain_owner(["h1"], exclude=("d0",)),
                 store.chain_owner([])]
        store.register(["h1"], "d1")
        seen.append(store.chain_owner(["h1"], exclude=("d0",)))
        store.drop_owner("d0")
        seen += [store.owned_depth(["h1"], "d1"),
                 store.owned_depth(["h2"], "d0"), len(store)]
        store.register(["a", "b", "c"], "d0")   # h1 falls off (4 > 3)
        store.register(["a"], "d2")             # refreshes "a"
        store.register(["d"], "d0")             # "b" falls off
        seen += [store.owned_depth(["h1"], "d1"), len(store),
                 store.chain_owner(["a"]), store.owned_depth(["b"], "d0"),
                 store.stats()]
        return seen

    got = script(TStore(max_entries=3))
    assert got == script(JStore(max_entries=3))
    assert got[:5] == [None, 0, 8, 2, 2] and got[-1] == {
        "entries": 3, "owners": 2, "block_size": 8}


def _router_run(pkg, fleet, prompts, with_prefill=True):
    """Counters of a disaggregated router run of `pkg` ("jax" | "torch")
    over the fleet's engines of that package, and the streams."""
    p = pkg[0]
    Replica, Router, mon, set_flags = (
        (JReplica, JRouter, jmon, fj.set_flags) if pkg == "jax"
        else (TReplica, TRouter, tmon, ft.set_flags))
    set_flags({"FLAGS_enable_monitor": True})
    mon.reset_stats()
    reps = [Replica("d0", gen_engine=fleet[p + "d"], role="decode")]
    if with_prefill:
        reps.append(Replica("p0", gen_engine=fleet[p + "p"],
                            role="prefill"))
    router = Router(reps, start_probe=False, disagg=True)
    try:
        streams = [router.generate({"prompt": q, "max_new_tokens": 3})
                   ["tokens"] for q in prompts]
        counters = mon.get_stats_snapshot()["counters"]
        depth = router.prefix_store.owned_depth(
            PrefixCache.chunk_hashes(prompts[0][:2 * BLOCK], BLOCK), "d0")
    finally:
        router.close()
    return streams, counters, depth


def test_router_disagg_stats_match_jax(trained, fleet):
    """Two prompts that share two full blocks through a prefill and a
    decode replica: the second reuses the prefix the first shipped.
    Then a fleet without a prefill replica falls back to a local
    prefill. Both packages count the same names with the same values,
    and decode the serial streams."""
    prefix = [(5 + i) % VOCAB for i in range(2 * BLOCK)]
    prompts = [prefix + [13], prefix + [14]]
    want = [_serial(trained, q, 3) for q in prompts]
    got = {pkg: _router_run(pkg, fleet, prompts)
           for pkg in ("jax", "torch")}
    for streams, counters, depth in got.values():
        assert streams == want and depth == 2
    (_, cj, _), (_, ct, _) = got["jax"], got["torch"]
    fleet_stats = ("serving.kv_xfer", "serving.disagg", "serving.router")
    assert {k: v for k, v in ct.items() if k.startswith(fleet_stats)} == \
        {k: v for k, v in cj.items() if k.startswith(fleet_stats)}
    assert ct["serving.disagg_requests"] == 2
    assert ct["serving.disagg_prefix_reuse"] == 1
    assert ct["serving.kv_xfer_exports"] == 1
    assert ct["serving.kv_xfer_blocks"] == 2
    assert ct["serving.kv_xfer_adopted_blocks"] == 2
    other = [(7 + i) % VOCAB for i in range(2 * BLOCK + 1)]
    fb = {pkg: _router_run(pkg, fleet, [other], with_prefill=False)
          for pkg in ("jax", "torch")}
    for streams, counters, _ in fb.values():
        assert streams == [_serial(trained, other, 3)]
        assert counters.get("serving.disagg_fallbacks") == 1


def test_admission_waits_for_the_kv_mutex(trained):
    """The port's worker admits a queued request under _kv_mutex (the
    JAX package's admits without it), so admission never interleaves
    with an adopt filling the same BlockPool and PrefixCache."""
    eng = _tengine(trained)
    held = []
    admit = eng._admit_locked

    def checked():
        held.append(eng._kv_mutex.locked())
        return admit()

    eng._admit_locked = checked
    eng.start()
    try:
        assert eng.generate([1, 2, 3], 2)["tokens"] == [4, 5]
    finally:
        eng.stop()
    assert held and all(held)


def test_replica_records_stay_one_a_line_across_threads(capsys):
    """The replica's kv hook prints from the HTTP server's request
    threads: records printed at once by many threads still come out one
    JSON object a line (a plain print writes the text and its newline
    apart)."""
    import json
    import sys
    import threading
    from paddle_tpu_torch.serving import replica

    def emit(i):
        for j in range(1000):
            replica._emit({"kind": "kv_export", "thread": i, "n": j,
                           "sha256": "0" * 64})
    threads = [threading.Thread(target=emit, args=(i,)) for i in range(8)]
    # switch threads as often as the interpreter can: a print's two
    # writes then part often
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 8 * 1000
    recs = [json.loads(ln) for ln in lines]
    assert sorted((r["thread"], r["n"]) for r in recs) == \
        [(i, j) for i in range(8) for j in range(1000)]
