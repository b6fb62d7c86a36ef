"""GPT generation on the CPU against the JAX package: the decode
programs, paged_attention, the KV-cache decode loops, full-context
greedy and beam decoding, host sampling and the block bookkeeping.

The model is test_torch_gpt.py's tiny GPT (2 layers, d 64, 2 heads, d_ff
128, vocab 100), trained by the JAX package for a few AdamW steps and
carried over with convert.scope_from_numpy.

- The slab decode, paged decode, chunked-prefill and spec-verify
  programs and their startups serialize byte-identically.
- paged_attention matches the JAX lowering within 1e-6 (Out at every
  valid position, and every pool block a table maps), with a muted row
  and a partly valid prefill chunk; whatever the scratch block 0 holds
  changes neither.
- Greedy kv_generate gives equal streams in both packages and per-step
  logits within 1e-5; the paged decode step with chunked prefill, driven
  by a paged GenerationEngine seen through chip_smoke.engine_generate,
  gives the slab path's streams and logits
  within 1e-5; greedy_generate (greedy and with temperature) and
  beam_generate agree between packages; sample_token and accept_draft
  draw the same tokens from the same RandomState.
- BlockPool and PrefixCache give the same allocations, refcounts and
  chain hashes as the JAX classes over one operation sequence.
"""
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.core import lowering as jlow
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.models import gpt as gj
from paddle_tpu.models import sampling as sj
from paddle_tpu.serving import kv_blocks as kj
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.core import lowering as tlow
from paddle_tpu_torch.core.registry import REGISTRY as TREG
from paddle_tpu_torch.models import gpt as gt
from paddle_tpu_torch.models import sampling as st
from paddle_tpu_torch.serving import kv_blocks as kt

V, SEQ, MAX_SEQ, BLOCK = 100, 130, 64, 4
LOGIT_ATOL = 1e-5


def _chip_smoke():
    """chip_smoke.py at the repository's root (its paged decode loop),
    imported from its path."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_cfg(g):
    return g.gpt_small(vocab_size=V, d_model=64, n_heads=2, n_layers=2,
                       d_ff=128, max_seq_len=SEQ, use_flash=True,
                       dropout=0.0, attn_dropout=0.0)


def _programs(f, g, build, *args, **kw):
    main, startup = f.Program(), f.Program()
    startup.random_seed = 5
    with f.program_guard(main, startup), f.unique_name.guard():
        step = build(tiny_cfg(g), *args, **kw)
    return main, startup, step


DECODE_PROGRAMS = {
    "slab": ("build_decode_step", (2, MAX_SEQ), {}),
    "paged": ("build_paged_decode_step", (3, MAX_SEQ, BLOCK, 49), {}),
    "prefill": ("build_paged_decode_step", (3, MAX_SEQ, BLOCK, 49),
                {"seq_tokens": BLOCK, "with_logits": False}),
    "spec_verify": ("build_spec_verify_step", (3, MAX_SEQ, BLOCK, 49),
                    {"k": 3}),
}


@pytest.mark.parametrize("kind", list(DECODE_PROGRAMS))
def test_decode_programs_identical(kind):
    name, args, kw = DECODE_PROGRAMS[kind]
    mj, sj_, _ = _programs(fj, gj, getattr(gj, name), *args, **kw)
    mt, st_, step = _programs(ft, gt, getattr(gt, name), *args, **kw)
    assert mt.to_json() == mj.to_json()
    assert st_.to_json() == sj_.to_json()
    assert mt.fingerprint() == mj.fingerprint()
    types_ = {op.type for op in mt.global_block().ops}
    assert ("paged_attention" in types_) == (kind != "slab")
    assert ("flash_attention" not in types_)
    if kind == "slab":
        assert {"one_hot", "range", "less_equal", "softmax", "matmul",
                "assign", "lookup_table"} <= types_
    if kind == "prefill":
        assert "reduce_mean" in types_ and "lookup_table_v2" in types_


# --- paged_attention --------------------------------------------------------

def _op(attrs):
    return types.SimpleNamespace(attrs=dict(attrs), id=7, block=None,
                                 type="paged_attention")


def _paged_jax(ins, attrs):
    ctx = jlow._OpCtx(jlow.LowerCtx(jax.random.PRNGKey(0)), _op(attrs))
    outs = JREG.get("paged_attention").lower(
        ctx, {s: [jnp.asarray(a) for a in vs] for s, vs in ins.items()},
        attrs)
    return {s: np.asarray(v[0]) for s, v in outs.items()}


def _paged_torch(ins, attrs):
    ctx = tlow._OpCtx(tlow.LowerCtx("cpu"), _op(attrs))
    outs = TREG.get("paged_attention").lower(
        ctx, {s: [torch.from_numpy(np.array(a))] for s, (a,) in
              ins.items()}, attrs)
    return {s: v[0].numpy() for s, v in outs.items()}


def _paged_inputs(seed, scratch_scale=0.0):
    """Four rows of a prefill chunk (T = BLOCK) over a pool of 12 blocks:
    row 0 muted (n_valid 0), row 1 a partly valid chunk (2 of 4) at
    position 5, row 2 a full chunk at position 8, row 3 a partly valid
    chunk at position 0. Tables map disjoint blocks; their unused
    entries are 0, the scratch block, which holds
    scratch_scale * randn."""
    rng = np.random.RandomState(seed)
    nb, h, hd, b, t = 12, 2, 8, 4, BLOCK
    ck = rng.randn(nb, BLOCK, h, hd).astype(np.float32)
    cv = rng.randn(nb, BLOCK, h, hd).astype(np.float32)
    ck[0] = scratch_scale * rng.randn(BLOCK, h, hd)
    cv[0] = scratch_scale * rng.randn(BLOCK, h, hd)
    table = np.array([[0, 0, 0, 0], [3, 7, 0, 0], [1, 4, 9, 0],
                      [11, 0, 0, 0]], np.int64)
    ins = {"Q": [rng.randn(b, h, t, hd).astype(np.float32)],
           "K": [rng.randn(b, h, t, hd).astype(np.float32)],
           "V": [rng.randn(b, h, t, hd).astype(np.float32)],
           "CacheK": [ck], "CacheV": [cv], "BlockTable": [table],
           "StartPos": [np.array([0, 5, 8, 0], np.int64)],
           "NValid": [np.array([0, 2, 4, 3], np.int64)]}
    return ins, {"sm_scale": float(hd) ** -0.5}


def _valid_out(out, nvalid):
    return [out[b, :, :n] for b, n in enumerate(nvalid)]


def test_paged_attention_matches_jax():
    ins, attrs = _paged_inputs(0)
    oj, ot = _paged_jax(ins, attrs), _paged_torch(ins, attrs)
    nvalid = ins["NValid"][0]
    for a, b in zip(_valid_out(oj["Out"], nvalid),
                    _valid_out(ot["Out"], nvalid)):
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
    mapped = sorted(set(ins["BlockTable"][0].reshape(-1)) - {0})
    for slot in ("CacheKOut", "CacheVOut"):
        assert ot[slot].shape == oj[slot].shape
        np.testing.assert_allclose(ot[slot][mapped], oj[slot][mapped],
                                   atol=1e-6, rtol=0)
    # the valid tokens landed where the tables say: row 2 writes
    # positions 8..11, logical block 2 = physical 9
    np.testing.assert_array_equal(
        ot["CacheKOut"][9], ins["K"][0][2].transpose(1, 0, 2))
    # the muted row and the invalid positions touched no mapped block
    # beyond the valid writes: row 1's block 7 keeps offsets 3
    np.testing.assert_array_equal(ot["CacheKOut"][7][3],
                                  ins["CacheK"][0][7][3])


def test_paged_attention_never_reads_the_scratch_block():
    """Several muted and invalid positions write block 0 (an index_put
    with duplicate indices: which write lands is undefined), so nothing
    may depend on it: whatever block 0 holds, the valid outputs and the
    mapped blocks are bit-identical."""
    ins0, attrs = _paged_inputs(1, scratch_scale=0.0)
    ins1, _ = _paged_inputs(1, scratch_scale=1e3)
    o0, o1 = _paged_torch(ins0, attrs), _paged_torch(ins1, attrs)
    nvalid = ins0["NValid"][0]
    for a, b in zip(_valid_out(o0["Out"], nvalid),
                    _valid_out(o1["Out"], nvalid)):
        np.testing.assert_array_equal(a, b)
    mapped = sorted(set(ins0["BlockTable"][0].reshape(-1)) - {0})
    np.testing.assert_array_equal(o0["CacheKOut"][mapped],
                                  o1["CacheKOut"][mapped])
    np.testing.assert_array_equal(o0["CacheVOut"][mapped],
                                  o1["CacheVOut"][mapped])


# --- generation from a JAX-trained scope -------------------------------------

@pytest.fixture(scope="module")
def trained():
    """The tiny GPT's training program, trained by the JAX package for 8
    AdamW steps (lr 1e-2) on a strided token cycle: (the JAX scope, the
    same parameters in a port scope on the CPU, the JAX program pieces,
    the port's)."""
    def build(f, g):
        main, startup = f.Program(), f.Program()
        startup.random_seed = 3
        with f.program_guard(main, startup), f.unique_name.guard():
            loss, logits, tokens = g.build_train(tiny_cfg(g), 2, SEQ,
                                                 lr=1e-2)
        return main, startup, loss, logits, tokens

    pj, pt = build(fj, gj), build(ft, gt)
    scope_j = fj.Scope()
    toks = ((np.arange(SEQ)[None, :] * 7 + np.array([[0], [3]])) % V) \
        .astype(np.int64)
    with fj.scope_guard(scope_j):
        exe_j = fj.Executor(fj.CPUPlace())
        exe_j.run(pj[1])
        for _ in range(8):
            exe_j.run(pj[0], feed={"tokens": toks}, fetch_list=[pj[2]])
    params = {n: np.asarray(scope_j.get(n)) for n in scope_j.names()
              if scope_j.find_var(n) is not None}
    scope_t = scope_from_numpy(params, ft.Scope(), ft.CPUPlace())
    return scope_j, scope_t, pj, pt


PROMPTS = ([5], [3, 10, 17, 24, 31], list(range(2, 95, 4)))


def test_kv_generate_matches_jax(trained):
    scope_j, scope_t, _, _ = trained
    smoke = _chip_smoke()
    dj, _, step_j = _programs(fj, gj, gj.build_decode_step, 1, MAX_SEQ)
    dt, _, step_t = _programs(ft, gt, gt.build_decode_step, 1, MAX_SEQ)
    exe_j = fj.Executor(fj.CPUPlace())
    exe_t = ft.Executor(ft.CPUPlace())
    for prompt in PROMPTS:
        rec_j, rec_t = smoke._Recorder(exe_j), smoke._Recorder(exe_t)
        with fj.scope_guard(scope_j):
            out_j = gj.kv_generate(rec_j, scope_j, dj, *step_j, prompt, 12)
        out_t = gt.kv_generate(rec_t, scope_t, dt, *step_t, prompt, 12)
        assert out_t == out_j
        assert len(rec_t.logits) == len(prompt) + 11
        np.testing.assert_allclose(np.stack(rec_t.logits),
                                   np.stack(rec_j.logits),
                                   atol=LOGIT_ATOL, rtol=0)
    # decode state: int64 position, float32 caches, on the executor's place
    pos = scope_t.get("decode_pos")
    assert pos.dtype == torch.int64 and pos.device.type == "cpu"
    assert int(pos[0]) == len(PROMPTS[-1]) + 11
    assert scope_t.get("layer_0.cache_k").shape == (1, 2, MAX_SEQ, 32)


def test_paged_decode_with_chunked_prefill_matches_slab(trained):
    """The paged GenerationEngine (one slot a prompt, chunked prefill),
    its steps seen through by chip_smoke.engine_generate, gives the slab
    path's streams and, at each new token, its logits."""
    from paddle_tpu_torch.serving import GenerationEngine
    _, scope_t, _, _ = trained
    smoke = _chip_smoke()
    n = len(PROMPTS)
    dt, _, slab = _programs(ft, gt, gt.build_decode_step, 1, MAX_SEQ)
    exe = ft.Executor(ft.CPUPlace())
    serial, serial_logits = [], []
    for prompt in PROMPTS:
        rec = smoke._Recorder(exe)
        serial.append(gt.kv_generate(rec, scope_t, dt, *slab, prompt, 10))
        serial_logits.append(rec.logits[-10:])
    engine = GenerationEngine(tiny_cfg(gt), scope_t, exe=exe, max_slots=n,
                              max_seq=MAX_SEQ, paged=True, block_size=BLOCK,
                              state_prefix="gen_check.",
                              default_timeout_ms=120000)
    engine.start()
    try:
        streams, logits, times = smoke.engine_generate(
            engine, [list(p) for p in PROMPTS], 10)
        recompiles = engine.post_warmup_compiles()
    finally:
        engine.stop()
    assert streams == serial
    for a, b in zip(logits, serial_logits):
        np.testing.assert_allclose(np.stack(a), np.stack(b),
                                   atol=LOGIT_ATOL, rtol=0)
    # prompt[:-1] prefills in chunks of BLOCK: 0, 4 and 23 tokens take
    # 0, 1 and 6 chunk steps
    assert times["chunks"] == [0, 1, 6]
    assert len(times["prefill"]) >= 6
    assert len(times["decode"]) >= 10
    # no recompile while generating: the slab step and the engine's
    # warmed decode and prefill steps are the executor's only entries
    assert recompiles == 0
    assert exe.cache_stats()["misses"] == 3


def test_spec_verify_step_scores_like_serial_decode(trained):
    """One spec-verify step over a slot's committed token plus 3 draft
    tokens gives the logits of 4 serial decode steps."""
    _, scope_t, _, _ = trained
    n_blocks = 2 * (MAX_SEQ // BLOCK) + 1
    vp, _, ver = _programs(ft, gt, gt.build_spec_verify_step, 2, MAX_SEQ,
                           BLOCK, n_blocks, k=3)
    dp, _, dec = _programs(ft, gt, gt.build_paged_decode_step, 2, MAX_SEQ,
                           BLOCK, n_blocks)
    exe = ft.Executor(ft.CPUPlace())
    seq = [4, 8, 15, 16, 23, 42]

    def run(prog, step, tokens, start, nvalid):
        gt._ensure_decode_state(scope_t, prog.global_block(),
                                step.cache_names, exe.place)
        table = np.zeros((2, MAX_SEQ // BLOCK), np.int64)
        table[0, :2] = [1, 2]
        return exe.run(prog, feed={
            step.token_var.name: np.asarray(tokens, np.int64),
            step.table_var.name: table,
            step.start_var.name: np.array([start, 0], np.int64),
            step.nvalid_var.name: np.array([nvalid, 0], np.int64)},
            fetch_list=[step.logits_var], scope=scope_t)[0]

    serial = [run(dp, dec, [[t], [0]], i, 1)[0, 0]
              for i, t in enumerate(seq)]
    verify = run(vp, ver, [seq[2:], [0] * 4], 2, 4)[0]
    np.testing.assert_allclose(verify, np.stack(serial[2:]),
                               atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_greedy_generate_matches_jax(trained, temperature):
    scope_j, scope_t, pj, pt = trained
    test_j, test_t = pj[0].clone(for_test=True), pt[0].clone(for_test=True)
    prompt = [3, 10, 17, 24, 31]
    with fj.scope_guard(scope_j):
        out_j = gj.greedy_generate(fj.Executor(fj.CPUPlace()), test_j,
                                   pj[4], pj[3], prompt, 4, SEQ,
                                   temperature=temperature, seed=7)
    with ft.scope_guard(scope_t):
        out_t = gt.greedy_generate(ft.Executor(ft.CPUPlace()), test_t,
                                   pt[4], pt[3], prompt, 4, SEQ,
                                   temperature=temperature, seed=7)
    assert out_t == out_j and len(out_t) == 4


def test_beam_generate_matches_jax(trained):
    scope_j, scope_t, pj, pt = trained
    test_j, test_t = pj[0].clone(for_test=True), pt[0].clone(for_test=True)
    prompt = [3, 10, 17]
    with fj.scope_guard(scope_j):
        out_j = gj.beam_generate(fj.Executor(fj.CPUPlace()), test_j, pj[4],
                                 pj[3], prompt, 3, SEQ, beam_size=2)
    with ft.scope_guard(scope_t):
        out_t = gt.beam_generate(ft.Executor(ft.CPUPlace()), test_t, pt[4],
                                 pt[3], prompt, 3, SEQ, beam_size=2)
    assert out_t == out_j and len(out_t) == 3


# --- host sampling and block bookkeeping -------------------------------------

@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.0, 5),
                                               (0.8, 0), (1.3, 5)])
def test_sample_token_draws_match_jax(temperature, top_k):
    rows = np.random.RandomState(11).randn(40, V).astype(np.float32)
    rng_j, rng_t = np.random.RandomState(3), np.random.RandomState(3)
    got_j = [sj.sample_token(r, temperature, top_k, rng_j) for r in rows]
    got_t = [st.sample_token(r, temperature, top_k, rng_t) for r in rows]
    assert got_t == got_j
    if temperature:
        assert len(set(got_t)) > 1


def test_accept_draft_matches_jax():
    rows = np.random.RandomState(12).randn(5, V).astype(np.float32)
    draft = [int(rows[0].argmax()), int(rows[1].argmax()), 7, 9]
    assert st.accept_draft(rows, draft) == sj.accept_draft(rows, draft)
    assert st.accept_draft(rows, draft)[1] == 2
    rng_j, rng_t = np.random.RandomState(4), np.random.RandomState(4)
    assert st.accept_draft(rows, draft, 0.9, 3, rng_t) == \
        sj.accept_draft(rows, draft, 0.9, 3, rng_j)


def _pool_trace(mod):
    """One sequence of BlockPool / PrefixCache operations: what each
    returns, and the refcounts and free counts after it."""
    pool = mod.BlockPool(9, 4)
    cache = mod.PrefixCache(pool)
    log = [mod.SCRATCH_BLOCK, mod.blocks_for_tokens(0, 4),
           mod.blocks_for_tokens(9, 4), pool.capacity()]
    a = [pool.alloc() for _ in range(3)]
    prompt = list(range(10, 23))
    hashes = mod.PrefixCache.chunk_hashes(prompt, 4)
    log += [a, hashes, [cache.insert(h, b) for h, b in zip(hashes, a)],
            cache.insert(hashes[0], a[1])]
    hits = [cache.lookup(prompt, max_tokens=len(prompt) - 1),
            cache.lookup(prompt[:5] + [99] * 8)]
    log += [hits, [pool.refcount(b) for b in range(9)]]
    # the slots that adopted the hits, and the one that made the blocks,
    # release them: only the cache's refs remain
    for b in [x for _, ids in hits for x in ids] + a:
        pool.decref(b)
    log.append([pool.refcount(b) for b in range(9)])
    log += [cache.evictable_count(), cache.evict_lru()]
    b = [pool.alloc() for _ in range(8)]
    log += [b, pool.free_count(), pool.used_count(), len(cache)]
    for x in b:
        if x is not None:
            pool.decref(x)
    while cache.evict_lru() is not None:
        pass
    log += [[pool.refcount(x) for x in range(9)], pool.free_count(),
            pool.alloc()]
    return log


def test_block_pool_and_prefix_cache_match_jax():
    assert _pool_trace(kt) == _pool_trace(kj)
    with pytest.raises(ValueError):
        kt.BlockPool(1, 4)
    with pytest.raises(ValueError):
        kt.BlockPool(4, 4).decref(kt.SCRATCH_BLOCK)
