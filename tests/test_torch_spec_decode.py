"""Speculative decoding in the port against the JAX package on the CPU.

- NgramDrafter and update_spec_k give the JAX package's answers on the
  same inputs.
- The port's spec-decode engine (paged, the [max_slots, k+1] verify
  step) gives the spec-off engine's streams, greedy and sampled
  (temperature 0.8, fixed seeds), and the JAX spec engine's; the verify
  step is reached and drafts are accepted.
- Adaptive k shrinks per slot under a drafter that is always wrong,
  without changing a token; a request may opt out; slab engines resolve
  spec_decode to off.

The model is test_spec_decode.py's: the cyclic-successor tiny GPT (vocab
16, d 32, 4 heads, 2 layers) at max_seq 32, trained by the JAX package
and carried over with convert.scope_from_numpy, so contexts wrap the
cycle and the drafter has repeats to find.
"""
import itertools

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu import monitor as jmon
from paddle_tpu.models import gpt as gj
from paddle_tpu.serving import GenerationEngine as JEngine
from paddle_tpu.serving import GenerationRequest as JRequest
from paddle_tpu.serving import spec_decode as jspec
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.models import gpt as gt
from paddle_tpu_torch.serving import GenerationEngine as TEngine
from paddle_tpu_torch.serving import GenerationRequest as TRequest
from paddle_tpu_torch.serving import spec_decode as tspec

from test_torch_observability import reset_globals


VOCAB, SEQ = 16, 32


def _cfg(g):
    return g.gpt_small(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=2,
                       d_ff=64, max_seq_len=SEQ, dropout=0.0,
                       use_flash=False)


@pytest.fixture(scope="module")
def scopes():
    """(JAX scope, port scope) of the cyclic-successor model, trained
    for 40 AdamW steps at seq_len 12."""
    main, startup = fj.Program(), fj.Program()
    startup.random_seed = 11
    sj = fj.Scope()
    with fj.program_guard(main, startup), fj.scope_guard(sj):
        loss, _, _ = gj.build_train(_cfg(gj), batch=8, seq_len=12, lr=5e-3)
        exe = fj.Executor(fj.CPUPlace())
        exe.run(startup)
        base = np.arange(12) % VOCAB
        toks = np.stack([(base + i) % VOCAB for i in range(8)]) \
            .astype(np.int64)
        for _ in range(40):
            exe.run(main, feed={"tokens": toks}, fetch_list=[loss])
    params = {n: np.asarray(sj.get(n)) for n in sj.names()
              if sj.find_var(n) is not None}
    return sj, scope_from_numpy(params, ft.Scope(), ft.CPUPlace())


@pytest.fixture(autouse=True)
def _hygiene():
    reset_globals()
    yield
    reset_globals()


# --- the drafter and the controller -----------------------------------------

CONTEXTS = [[1, 2, 3, 9, 1, 2, 3], [1, 2, 3, 4, 1, 2, 3, 4, 1, 2],
            [5, 6, 7, 5, 6, 7, 5], [4, 4, 4, 4], [1, 2, 3, 4, 5],
            [7], [], [3, 1, 3, 2, 3, 1, 3], list(range(10)) * 3]


@pytest.mark.parametrize("ctx,k,n", list(itertools.product(
    CONTEXTS, (0, 1, 3), (1, 3))))
def test_drafter_matches_jax(ctx, k, n):
    assert tspec.NgramDrafter(max_ngram=n, k=4).draft(ctx, k) == \
        jspec.NgramDrafter(max_ngram=n, k=4).draft(ctx, k)


def test_drafter_cases():
    d = tspec.NgramDrafter(max_ngram=3, k=4)
    assert d.draft([1, 2, 3, 9, 1, 2, 3]) == [9, 1, 2, 3]
    assert d.draft([1, 2, 3, 9, 1, 2, 3], 2) == [9, 1]
    assert d.draft([1, 2, 3, 4, 5]) == []
    assert tspec.NgramDrafter(max_ngram=0).draft([1, 1, 1]) == []


GRID = list(itertools.product((1, 2, 4), (None, 0.0, 0.5, 0.9),
                              (0.0, 0.25, 1.0, 7.5), (4,)))


@pytest.mark.parametrize("cur,ewma,rate,k_max", GRID)
def test_update_spec_k_matches_jax(cur, ewma, rate, k_max):
    assert tspec.update_spec_k(cur, ewma, rate, k_max) == \
        jspec.update_spec_k(cur, ewma, rate, k_max)


# --- the engine -------------------------------------------------------------

PROMPTS = [([0, 1, 2], 24), ([5, 6], 20), ([1, 2, 3, 4], 22), ([7], 18),
           ([3, 4, 5], 16)]


def _engine(scopes, pkg, **kw):
    """A 2-slot paged engine of `pkg`; requests get a 120 s deadline (the
    1000 ms default would make the outcome depend on the machine's
    load)."""
    sj, st = scopes
    kw.update(max_slots=2, max_seq=SEQ, block_size=4,
              default_timeout_ms=120000.0)
    if pkg == "jax":
        return JEngine(_cfg(gj), sj, exe=fj.Executor(fj.CPUPlace()), **kw)
    return TEngine(_cfg(gt), st, exe=ft.Executor(ft.CPUPlace()), **kw)


def _streams(eng, Request, cases):
    eng.start()
    try:
        resps = [eng.submit(Request(p, n, **kw)) for p, n, kw in cases]
        out = [r.result(timeout=120.0)["tokens"] for r in resps]
        assert eng.post_warmup_compiles() == 0, eng.cache_stats()
    finally:
        eng.stop()
    return out


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_spec_on_equals_spec_off_and_jax(scopes, temperature):
    cases = [(p, n, {"temperature": temperature, "top_k": 5, "seed": i})
             for i, (p, n) in enumerate(PROMPTS)]
    off = _streams(_engine(scopes, "torch", spec_decode=False), TRequest,
                   cases)
    ft.set_flags({"FLAGS_enable_monitor": True})
    eng = _engine(scopes, "torch", spec_decode=True, spec_k=4)
    assert eng.paged and eng.spec_decode and eng.spec_k == 4
    on = _streams(eng, TRequest, cases)
    assert on == off
    c = tmon.get_stats_snapshot()["counters"]
    assert c["serving.gen_spec_steps"] > 0
    proposed = c["serving.gen_spec_draft_proposed"]
    assert proposed > 0 and 0 < c["serving.gen_spec_draft_accepted"] \
        <= proposed
    fj.set_flags({"FLAGS_enable_monitor": True})
    want = _streams(_engine(scopes, "jax", spec_decode=True, spec_k=4),
                    JRequest, cases)
    assert on == want
    snap_j = jmon.get_stats_snapshot()
    for name in ("serving.gen_spec_steps", "serving.gen_spec_draft_proposed",
                 "serving.gen_spec_draft_accepted", "serving.gen_tokens"):
        assert c[name] == snap_j["counters"][name], name
    # chip_smoke.py's [gen_serve] gate lists only what the JAX engine
    # records
    from test_torch_generate import _chip_smoke
    for kind, want in _chip_smoke().GEN_SPEC_STATS.items():
        assert set(want) <= set(snap_j[kind]), kind


class _BadDrafter:
    """Always proposes a wrong successor: every draft is rejected."""

    def draft(self, ctx, k=None):
        return [(int(ctx[-1]) + 3) % VOCAB] * int(k or 1)


@pytest.mark.parametrize("adaptive", [True, False])
def test_adaptive_k_under_a_bad_drafter(scopes, adaptive):
    want = _streams(_engine(scopes, "torch", spec_decode=False), TRequest,
                    [([0, 1, 2], 24, {})])
    ft.set_flags({"FLAGS_enable_monitor": True})
    eng = _engine(scopes, "torch", spec_decode=True, spec_k=4,
                  spec_adaptive=adaptive)
    eng._drafter = _BadDrafter()
    assert _streams(eng, TRequest, [([0, 1, 2], 24, {})]) == want
    snap = tmon.get_stats_snapshot()
    c = snap["counters"]
    if adaptive:
        assert c["serving.gen_spec_k_shrinks"] >= 3      # 4 -> 1
        assert "serving.gen_spec_k_grows" not in c
        assert snap["gauges"]["serving.gen_spec_k_effective"] == 1
    else:
        assert "serving.gen_spec_k_shrinks" not in c


def test_per_request_opt_out_and_flag_default(scopes):
    want = _streams(_engine(scopes, "torch", spec_decode=False), TRequest,
                    [([0, 1, 2], 20, {})])[0]
    ft.set_flags({"FLAGS_gen_spec_decode": True,
                  "FLAGS_enable_monitor": True})
    eng = _engine(scopes, "torch")
    assert eng.spec_decode
    got = _streams(eng, TRequest, [([0, 1, 2], 20, {"spec_decode": False}),
                                   ([0, 1, 2], 20, {})])
    assert got == [want, want]


def test_spec_requires_a_paged_engine(scopes):
    eng = _engine(scopes, "torch", spec_decode=True, paged=False)
    assert not eng.spec_decode and eng.spec_step is None
