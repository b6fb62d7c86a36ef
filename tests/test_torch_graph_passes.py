"""The port's graph passes, CompiledProgram and registry flags against
the JAX package's, both on the CPU.

- For every op type both packages register, `stateful`, `inplace`,
  `version` and the nondiff slots agree: the passes and PTV002 read them.
- The crafted programs of tests/test_graph_passes.py, and the tiny
  training builds of BERT, GPT, ResNet-50, the Transformer, DeepLab and
  SE-ResNeXt, optimize to byte-equal Program JSON at levels 1 and 2,
  with equal pass reports (but their seconds). Folded values are exact
  for IEEE ops; the transcendental ops of FOLDABLE_OPS (exp, log, tanh,
  sigmoid, rsqrt, pow) are held within 2 ulp of the JAX package's
  values, and the rest of the JSON exactly.
- In the port, the optimized programs give bit-equal results: each
  crafted program against its level-0 run, and each build's losses and
  final parameters over two steps at levels 0, 1 and 2 (BERT and GPT
  with flash attention on its plain version, as on any CPU tensor). At
  level 2 the builds run fused_elementwise ops whose sub-ops have grad
  ops: their autograd records are kept under the sub-ops' own ids.
- CSE merging two differentiated forward ops: the JAX package's program,
  and the survivor's autograd record read by both grad ops.
- Level 0 returns the program untouched; the gate memoizes; a broken
  rewrite is discarded.
- CompiledProgram(...).with_data_parallel runs equal the plain
  program's; a mesh of more ranks than the process group, or with a
  model axis, is refused (the two-rank runs are
  tests/test_torch_parallel.py's).
"""
import math
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.analysis.passes import optimize_program as joptimize
from paddle_tpu_torch.analysis.passes import (FOLDABLE_OPS, FUSABLE_OPS,
                                              Pass, PassManager,
                                              optimize_gate,
                                              optimize_program, reset_memo)
from torch_analysis_helpers import (BUILDS, built, feed_for, flag_guard,
                                    raw_program)


def test_registry_flags_agree_with_jax():
    from paddle_tpu.core.registry import REGISTRY as JREG
    from paddle_tpu_torch.core.registry import REGISTRY as TREG
    both = sorted(set(JREG._ops) & set(TREG._ops))
    assert len(both) == len(TREG._ops)  # no op type of the port's own
    bad = []
    for t in both:
        a, b = JREG._ops[t], TREG._ops[t]
        for field in ("stateful", "inplace", "version"):
            if getattr(a, field) != getattr(b, field):
                bad.append((t, field))
        for field in ("nondiff_inputs", "nondiff_outputs"):
            if set(getattr(a, field)) != set(getattr(b, field)):
                bad.append((t, field))
    assert not bad


def test_pass_catalogs_are_the_jax_catalogs():
    from paddle_tpu.analysis import graph_utils as jg
    from paddle_tpu.analysis import shape_infer as js
    from paddle_tpu.analysis.passes import FOLDABLE_OPS as JF
    from paddle_tpu.analysis.passes import FUSABLE_OPS as JU
    from paddle_tpu_torch.analysis import graph_utils as tg
    from paddle_tpu_torch.analysis import shape_infer as ts
    assert FOLDABLE_OPS == JF and FUSABLE_OPS == JU
    assert ts.OPAQUE_OPS == js.OPAQUE_OPS
    assert tg.SIDE_EFFECT_OPS == jg.SIDE_EFFECT_OPS
    assert tg.MERGE_OPS == jg.MERGE_OPS
    for banned in ("reduce_sum", "reduce_mean", "matmul", "mul",
                   "softmax", "mean", "sum"):
        assert banned not in FOLDABLE_OPS


# ---------------------------------------------------------------------------
# crafted programs: (program, feed, fetch names, level) from a package
# ---------------------------------------------------------------------------

_F4 = dict(shape=[4], dtype="float32")


def _fold_chain(f):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data(name="x", shape=[4], dtype="float32")
        c = f.layers.fill_constant(shape=[4], dtype="float32", value=2.0)
        y = f.layers.elementwise_add(x, f.layers.scale(c, scale=3.0))
        f.layers.scale(y, scale=9.0)  # dead
    return main, ["x"], [y.name], 1, startup


def _fold_int_chain(f):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data(name="x", shape=[4], dtype="int64")
        c = f.layers.fill_constant(shape=[4], dtype="int64", value=3)
        y = f.layers.elementwise_add(x, c)
    return main, ["x"], [y.name], 1, startup


def _fold_double_write(f):
    prog = raw_program(f, [("c", dict(_F4)), ("u", dict(_F4)),
                           ("v", dict(_F4))], [
        ("fill_constant", {}, {"Out": ["c"]},
         {"shape": [4], "dtype": "float32", "value": 1.0}),
        ("scale", {"X": ["c"]}, {"Out": ["u"]}, {"scale": 2.0}),
        ("fill_constant", {}, {"Out": ["c"]},
         {"shape": [4], "dtype": "float32", "value": 5.0}),
        ("scale", {"X": ["c"]}, {"Out": ["v"]}, {"scale": 2.0})])
    return prog, [], ["u", "v", "c"], 1, None


def _cse_pure(f):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data(name="x", shape=[4], dtype="float32")
        z = f.layers.elementwise_add(f.layers.relu(x), f.layers.relu(x))
    return main, ["x"], [z.name], 1, startup


def _cse_stateful(f):
    attrs = {"shape": [4], "dtype": "float32", "min": 0.0, "max": 1.0}
    prog = raw_program(f, [("a", dict(_F4)), ("b", dict(_F4)),
                           ("z", dict(_F4))], [
        ("uniform_random", {}, {"Out": ["a"]}, attrs),
        ("uniform_random", {}, {"Out": ["b"]}, attrs),
        ("elementwise_add", {"X": ["a"], "Y": ["b"]}, {"Out": ["z"]}, {})])
    return prog, [], ["z"], 1, None


def _cse_redefinition(f):
    prog = raw_program(f, [("x", dict(is_data=True, **_F4)),
                           ("a", dict(_F4)), ("b", dict(_F4))], [
        ("relu", {"X": ["x"]}, {"Out": ["a"]}, {}),
        ("relu", {"X": ["x"]}, {"Out": ["b"]}, {}),
        ("tanh", {"X": ["x"]}, {"Out": ["a"]}, {})])
    return prog, ["x"], ["a", "b"], 1, None


def _no_fetch(f):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data(name="x", shape=[4], dtype="float32")
        f.layers.relu(x)
    return main, ["x"], [], 1, startup


def _chain(f, level=2):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data(name="x", shape=[4], dtype="float32")
        v = f.layers.relu(f.layers.scale(x, scale=2.0))
        loss = f.layers.reduce_sum(f.layers.elementwise_add(v, v))
    return main, ["x"], [loss.name], level, startup


def _fusion_fallback(f):
    prog = raw_program(f, [("x", dict(is_data=True, **_F4)),
                           ("a", dict(_F4)), ("b", dict(_F4))], [
        ("scale", {"X": ["x"]}, {"Out": ["a"]},
         {"scale": np.float32(2.0), "bias": 0.0,
          "bias_after_scale": True}),
        ("relu", {"X": ["a"]}, {"Out": ["b"]}, {})])
    return prog, ["x"], ["b"], 2, None


def _sgd(f, level=2):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data(name="x", shape=[4], dtype="float32")
        h = f.layers.fc(x, size=8, act="tanh")
        loss = f.layers.reduce_mean(f.layers.fc(h, size=1))
        f.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, ["x"], [loss.name], level, startup


def _cse_differentiated(f):
    """Two identical relus of one fc output, both differentiated: CSE
    merges the second into the first."""
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data(name="x", shape=[4], dtype="float32")
        h = f.layers.fc(x, size=8)
        a = f.layers.relu(h)
        b = f.layers.relu(h)
        loss = f.layers.reduce_mean(
            f.layers.elementwise_add(a, f.layers.scale(b, scale=3.0)))
        f.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, ["x"], [loss.name], 1, startup


# name -> fn(package) -> (program, feed names, fetch names, level,
# startup program or None)
CRAFTED = {
    "fold_chain": _fold_chain,
    "fold_int_chain": _fold_int_chain,
    "fold_double_write": _fold_double_write,
    "cse_pure": _cse_pure,
    "cse_stateful": _cse_stateful,
    "cse_redefinition": _cse_redefinition,
    "cse_differentiated": _cse_differentiated,
    "dce_no_fetch": _no_fetch,
    "fusion_chain": _chain,
    "fusion_fallback": _fusion_fallback,
    "sgd_level1": lambda f: _sgd(f, 1),
    "sgd_level2": _sgd,
}


def _report_counts(report):
    return {**{k: v for k, v in report.items() if k != "passes"},
            "passes": [{k: v for k, v in p.items() if k != "seconds"}
                       for p in report["passes"]]}


def _crafted_feed(prog, feed_names):
    rng = np.random.RandomState(3)
    blk = prog.global_block()
    out = {}
    for n in feed_names:
        v = blk.var(n)
        shape = [2 if d == -1 else d for d in v.shape]
        out[n] = rng.randint(-3, 4, shape).astype(v.dtype) \
            if "int" in v.dtype else rng.randn(*shape).astype(np.float32)
    return out


def _run_port(prog, feed, fetch, level, startup=None, steps=1):
    """Fetches of `steps` runs of `prog` at `level` on the CPU, from a
    fresh scope (its startup run first)."""
    prev = flag_guard(ft, graph_opt_level=level)
    try:
        scope = ft.Scope()
        exe = ft.Executor(ft.CPUPlace())
        if startup is not None:
            exe.run(startup, scope=scope)
        return [exe.run(prog, feed=feed, fetch_list=fetch, scope=scope)
                for _ in range(steps)], scope
    finally:
        ft.set_flags(prev)


@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_crafted_programs_optimize_like_jax_and_run_bit_equal(name):
    pj, feeds, fetch, level, _ = CRAFTED[name](fj)
    pt, _, _, _, st = CRAFTED[name](ft)
    assert pj.to_json() == pt.to_json()
    oj, rj = joptimize(pj, feed_names=feeds, fetch_names=fetch,
                       level=level)
    ot, rt = optimize_program(pt, feed_names=feeds, fetch_names=fetch,
                              level=level)
    assert ot.to_json() == oj.to_json()
    assert _report_counts(rt) == _report_counts(rj)
    assert [getattr(op, "_fusion_group", None)
            for op in ot.global_block().ops] == \
        [getattr(op, "_fusion_group", None) for op in oj.global_block().ops]
    assert getattr(ot, "_donation_plan", None) == \
        getattr(oj, "_donation_plan", None)
    if fetch:
        feed = _crafted_feed(pt, feeds)
        (base,), _ = _run_port(pt, feed, fetch, 0, startup=st)
        (got,), _ = _run_port(pt, feed, fetch, level, startup=st)
        if name != "cse_stateful":
            for a, b in zip(base, got):
                assert np.array_equal(a, b)


def test_constant_fold_values_and_the_int_ir_dtype():
    pt, feeds, fetch, _, _ = _fold_chain(ft)
    opt, report = optimize_program(pt, feeds, fetch, level=1)
    fold = next(p for p in report["passes"] if p["name"] == "constant_fold")
    assert fold["folded"] == 2 and fold["materialized"] == 1
    av, = [op for op in opt.global_block().ops if op.type == "assign_value"]
    np.testing.assert_array_equal(av.attrs["values"],
                                  np.full((4,), 6.0, np.float32))
    # an int64 constant folds to the IR's int32, as in the JAX package
    pt, feeds, fetch, _, _ = _fold_int_chain(ft)
    opt, _ = optimize_program(pt, feeds, fetch, level=1)
    av, = [op for op in opt.global_block().ops if op.type == "assign_value"]
    assert av.attrs["dtype"] == "int32"
    np.testing.assert_array_equal(av.attrs["values"], np.full(4, 3))


def _transcendental(f):
    """fill_constant -> scale -> each transcendental op of FOLDABLE_OPS,
    every result fetched."""
    f8 = dict(shape=[8], dtype="float32")
    unary = ("exp", "log", "tanh", "sigmoid", "rsqrt")
    ops = [("fill_constant", {}, {"Out": ["c"]},
            {"shape": [8], "dtype": "float32", "value": 0.7}),
           ("scale", {"X": ["c"]}, {"Out": ["d"]},
            {"scale": 1.3, "bias": 0.11})]
    ops += [(t, {"X": ["d"]}, {"Out": [t]}, {}) for t in unary]
    ops.append(("pow", {"X": ["d"]}, {"Out": ["pow"]}, {"factor": 1.7}))
    names = list(unary) + ["pow"]
    prog = raw_program(f, [(n, dict(f8)) for n in ["c", "d"] + names],
                       ops)
    return prog, names


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


def test_folded_transcendental_values_within_two_ulp_of_jax():
    import json
    pj, fetch = _transcendental(fj)
    pt, _ = _transcendental(ft)
    oj, _ = joptimize(pj, fetch_names=fetch, level=1)
    ot, _ = optimize_program(pt, fetch_names=fetch, level=1)
    def folded(opt):
        return {op.outputs["Out"][0]: op.attrs["values"]
                for op in opt.global_block().ops
                if op.type == "assign_value"}

    vj, vt = folded(oj), folded(ot)
    assert vt.keys() == vj.keys() and {"exp", "log", "tanh", "sigmoid",
                                       "rsqrt"} <= vt.keys()
    for name, a in vt.items():
        b = vj[name]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _ulps(a, b) <= 2, (name, a, b)
    # the rest of the program is the JAX package's to the byte
    dj, dt = json.loads(oj.to_json()), json.loads(ot.to_json())
    for d in (dj, dt):
        for op in d["blocks"][0]["ops"]:
            op["attrs"].pop("values", None)
    assert dt == dj
    # and the port's folded values are what its own lowerings compute
    (base,), _ = _run_port(pt, {}, fetch, 0)
    for name, b in zip(fetch, base):
        if name in vt:
            assert np.array_equal(vt[name], b), name


def test_cse_over_differentiated_ops_reads_one_record_twice():
    pt, feeds, fetch, _, start = _cse_differentiated(ft)
    opt, report = optimize_program(pt, feeds, fetch, level=1)
    cse = next(p for p in report["passes"] if p["name"] == "cse")
    assert cse["deduped"] == 1
    relus = [op for op in opt.global_block().ops if op.type == "relu"]
    grads = [op for op in opt.global_block().ops
             if op.type == "grad::generic" and op.attrs["fwd_type"] == "relu"]
    assert len(relus) == 1 and len(grads) == 2
    dropped = {g.attrs["fwd_id"] for g in grads} - {relus[0].id}
    assert opt._record_alias == {dropped.pop(): relus[0].id}
    exe = ft.Executor(ft.CPUPlace())
    step = exe._prepare(opt, opt.global_block(), ft.Scope(), fetch)
    assert step.record_readers == {relus[0].id: 2}
    # two steps of losses, gradients and updated weights, bit for bit
    main = pt
    feed = _crafted_feed(pt, feeds)
    w = "fc_0.w_0"
    runs = {}
    for level in (0, 1):
        outs, scope = _run_port(main, feed, fetch + [w + "@GRAD"], level,
                                startup=start, steps=2)
        runs[level] = (outs, scope.get_numpy(w))
    for (a, wa), (b, wb) in [(runs[0], runs[1])]:
        for x, y in zip(a, b):
            for u, v in zip(x, y):
                assert np.array_equal(u, v)
        assert np.array_equal(wa, wb)


def test_level0_untouched_level1_untagged_and_the_memo():
    pt, feeds, fetch, _, _ = _chain(ft)
    opt, report = optimize_program(pt, feeds, fetch, level=0)
    assert opt is pt and report["passes"] == []
    opt, report = optimize_program(pt, feeds, fetch, level=1)
    assert {p["name"] for p in report["passes"]} == \
        {"dead_op_elim", "constant_fold", "cse"}
    assert not any(getattr(op, "_fusion_group", None)
                   for op in opt.global_block().ops)
    assert getattr(opt, "_donation_plan", None) is None
    fp = pt.fingerprint()
    opt, report = optimize_program(pt, feeds, fetch, level=2)
    assert pt.fingerprint() == fp and opt is not pt
    assert "ewfuse" not in opt.to_json()
    prev = flag_guard(ft, graph_opt_level=1)
    reset_memo()
    try:
        p1, r1 = optimize_gate(pt, feeds, fetch)
        p2, r2 = optimize_gate(pt, feeds, fetch)
        assert p1 is p2 and r1 is r2
        ft.set_flags({"FLAGS_graph_opt_level": 0})
        p0, r0 = optimize_gate(pt, feeds, fetch)
        assert p0 is pt and r0 is None
    finally:
        ft.set_flags(prev)
        reset_memo()


class _BreakingPass(Pass):
    name = "break_dataflow"
    min_level = 1

    def run(self, program, ctx):
        blk = program.global_block()
        blk.ops.append(ft.framework.Operator(
            blk, "relu", {"X": ["__ghost__"]},
            {"Out": [blk.ops[0].outputs["Out"][0]]}))
        program._fp_cache = None
        return {}


def test_reverify_discards_a_broken_rewrite():
    pt, feeds, fetch, _, _ = _chain(ft)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out, report = PassManager([_BreakingPass()]).run(
            pt, feeds, fetch, level=1)
    assert out is pt and report["rejected"] is True
    assert any("re-verification" in str(w.message) for w in caught)


def test_fused_op_scope_names_its_group():
    from paddle_tpu_torch.profiler import extract_op_scope
    assert extract_op_scope("ewfuse3/fused_elementwise:0/12") == \
        ("fused_elementwise", 0, 12)
    pt, feeds, fetch, _, _ = _chain(ft)
    prev = flag_guard(ft, graph_opt_level=2, op_trace_scopes=True)
    try:
        exe = ft.Executor(ft.CPUPlace())
        feed = _crafted_feed(pt, feeds)
        with torch.profiler.profile() as prof:
            exe.run(pt, feed=feed, fetch_list=fetch, scope=ft.Scope())
        names = {e.name for e in prof.events()}
        assert "ewfuse0/fused_elementwise:0/0" in names, sorted(names)[:20]
    finally:
        ft.set_flags(prev)


# ---------------------------------------------------------------------------
# the tiny training builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("model", sorted(BUILDS))
def test_builds_optimize_to_the_jax_programs(model, level):
    mj, mt, _, loss = built(model)
    feeds = sorted(feed_for(mt))
    oj, rj = joptimize(mj, feed_names=feeds, fetch_names=[loss],
                       level=level)
    ot, rt = optimize_program(mt, feed_names=feeds, fetch_names=[loss],
                              level=level)
    assert not rt.get("rejected")
    assert ot.to_json() == oj.to_json()
    assert _report_counts(rt) == _report_counts(rj)


@pytest.mark.parametrize("model", sorted(BUILDS))
def test_builds_train_bit_equal_at_levels_0_1_2(model):
    """Run on one CPU thread, every level alike: the convolution models
    take 3-8 s alone, and many times that when several test workers'
    thread pools share the cores."""
    _, mt, st, loss = built(model)
    feed = feed_for(mt)
    runs = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for level in (0, 1, 2):
            outs, scope = _run_port(mt, feed, [loss], level, startup=st,
                                    steps=2)
            runs[level] = ([o[0] for o in outs],
                           {n: scope.get_numpy(n) for n in scope.names()})
    finally:
        torch.set_num_threads(threads)
    for level in (1, 2):
        for a, b in zip(runs[0][0], runs[level][0]):
            assert np.array_equal(a, b), (model, level)
        assert runs[level][1].keys() == runs[0][1].keys()
        for n, v in runs[0][1].items():
            assert np.array_equal(v, runs[level][1][n]), (model, level, n)
    assert all(math.isfinite(float(x)) for x in runs[0][0])
    # level 2 runs fused ops whose sub-ops a grad op differentiates
    opt, _ = optimize_program(mt, sorted(feed), [loss], level=2)
    ops = opt.global_block().ops
    fwd = {op.attrs["fwd_id"] for op in ops if op.type == "grad::generic"}
    subs = {s["id"] for op in ops if op.type == "fused_elementwise"
            for s in op.attrs["sub_ops"]}
    assert subs and subs & fwd


# ---------------------------------------------------------------------------
# CompiledProgram
# ---------------------------------------------------------------------------

def test_compiled_program_runs_equal_the_plain_program():
    main, feeds, fetch, _, start = _sgd(ft)
    feed = _crafted_feed(main, feeds)
    plain, s1 = _run_port(main, feed, fetch, 1, startup=start, steps=3)
    compiled = ft.CompiledProgram(main).with_data_parallel(
        loss_name=fetch[0], build_strategy=ft.BuildStrategy(),
        exec_strategy=ft.ExecutionStrategy())
    got, s2 = _run_port(compiled, feed, fetch, 1, startup=start, steps=3)
    for a, b in zip(plain, got):
        assert np.array_equal(a[0], b[0])
    for n in s1.names():
        assert np.array_equal(s1.get_numpy(n), s2.get_numpy(n))
    assert ft.compiler.CompiledProgram is ft.CompiledProgram
    strategy = ft.BuildStrategy()
    strategy.reduce_strategy = ft.BuildStrategy.ReduceStrategy.Reduce
    strategy.fuse_all_reduce_ops = False
    assert ft.CompiledProgram(main, strategy).build_strategy is strategy


def test_compiled_program_refuses_more_than_one_rank(monkeypatch):
    """One process without a process group is one rank: a mesh of more
    ranks is refused at the first run, a model (tp) axis's mesh too.
    `places` is accepted (a process drives its card)."""
    from paddle_tpu_torch.parallel.layout import mesh_from_spec
    main, feeds, fetch, _, start = _sgd(ft)
    feed = _crafted_feed(main, feeds)
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(start, scope=scope)
    two = ft.CompiledProgram(main).with_data_parallel(
        loss_name=fetch[0], places=[ft.CPUPlace(), ft.CPUPlace()])
    exe.run(two, feed=feed, fetch_list=fetch, scope=scope)
    with pytest.raises(ValueError, match="2 ranks"):
        exe.run(ft.CompiledProgram(main).with_distributed(
            mesh_from_spec("1,2")), feed=feed, fetch_list=fetch,
            scope=scope)
    with pytest.raises(ValueError, match="4 ranks"):
        exe.run(ft.CompiledProgram(main).with_distributed(
            mesh_from_spec("4")), feed=feed, fetch_list=fetch, scope=scope)
