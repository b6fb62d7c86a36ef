"""The port's static analysis against the JAX package's, both on the CPU.

- Every crafted malformed program of tests/test_analysis.py gives the
  same findings in both packages: rule IDs, severities, provenance
  ("{op_type}:{block}/{op_idx}") and vars, in the same order. PTV022 is
  held on a lowering that fails (a product of mismatched shapes) rather
  than on a swapped-in abstract_eval rule.
- The tiny training builds of BERT (plain and MLM under AMP), GPT,
  ResNet-50, the Transformer, DeepLab and SE-ResNeXt verify to the same
  findings, and their memory plans at the same feed shapes are equal:
  peak, timeline, intervals and findings. So do the one-op programs
  (with gradients) of the 109 op types of chip_smoke's dense-op table.
- The port infers shapes once per (program fingerprint, feed signature):
  a verify gate, a memory gate and a second memory gate of one program
  run the lowerings on meta tensors twice, not three times.
- The gates in the port's Executor.run and ServingEngine.warmup: error
  mode refuses before the executor's cache records a miss; warn mode
  warns once and memoizes; off skips; a bad flag value raises; the
  memory gate refuses an over-budget program (PTV050) and an oversized
  serving ladder, and the warmup records the JAX engine's analysis.*
  stat names.
"""
import warnings

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.analysis import verify_program as jverify
from paddle_tpu_torch.analysis import (Diagnostic, ProgramVerificationError,
                                       RULES, analyze_program_memory,
                                       verify_program)
from paddle_tpu_torch.analysis import memory as tmemory
from paddle_tpu_torch.analysis import shape_infer as tshape
from paddle_tpu_torch.analysis import verifier as tverifier
from torch_analysis_helpers import (BUILDS, built, feed_for, feed_shapes,
                                    finding_keys, flag_guard, raw_program)
from torch_dense_helpers import chip_smoke

_F32_23 = dict(shape=[2, 3], dtype="float32")

# name -> (var specs, op specs, verify kwargs, the rule the port must
# report, or None for a clean program); after tests/test_analysis.py
FIXTURES = {
    "ptv001_unregistered": (
        [("a", dict(is_data=True, **_F32_23)), ("b", dict(**_F32_23))],
        [("reluu", {"X": ["a"]}, {"Out": ["b"]}, {})],
        dict(check_shapes=False), "PTV001"),
    "ptv002_version": (
        [("a", dict(is_data=True, **_F32_23)), ("b", dict(**_F32_23))],
        [("relu", {"X": ["a"]}, {"Out": ["b"]}, {})],
        dict(op_versions={"relu": 999}, check_shapes=False), "PTV002"),
    "ptv010_undefined": (
        [("b", dict(**_F32_23))],
        [("relu", {"X": ["ghost"]}, {"Out": ["b"]}, {})],
        dict(check_shapes=False), "PTV010"),
    "ptv011_use_before_def": (
        [("b", dict(**_F32_23)), ("c", dict(**_F32_23))],
        [("relu", {"X": ["b"]}, {"Out": ["c"]}, {})],
        dict(check_shapes=False), "PTV011"),
    "ptv012_dead_op": (
        [("a", dict(is_data=True, **_F32_23)), ("b", dict(**_F32_23)),
         ("dead", dict(**_F32_23))],
        [("relu", {"X": ["a"]}, {"Out": ["b"]}, {}),
         ("tanh", {"X": ["a"]}, {"Out": ["dead"]}, {})],
        dict(fetch_names=["b"], check_shapes=False), "PTV012"),
    "ptv013_unused_output": (
        [("a", dict(is_data=True, **_F32_23)), ("b", dict(**_F32_23)),
         ("mask", dict(**_F32_23))],
        [("dropout", {"X": ["a"]}, {"Out": ["b"], "Mask": ["mask"]},
          {"dropout_prob": 0.5})],
        dict(fetch_names=["b"], check_shapes=False), "PTV013"),
    "ptv014_write_after_write": (
        [("a", dict(is_data=True, **_F32_23)), ("c", dict(**_F32_23))],
        [("relu", {"X": ["a"]}, {"Out": ["c"]}, {}),
         ("tanh", {"X": ["a"]}, {"Out": ["c"]}, {})],
        dict(fetch_names=["c"], check_shapes=False), "PTV014"),
    "ptv014_read_between": (
        [("a", dict(is_data=True, **_F32_23)), ("c", dict(**_F32_23)),
         ("d", dict(**_F32_23))],
        [("relu", {"X": ["a"]}, {"Out": ["c"]}, {}),
         ("tanh", {"X": ["c"]}, {"Out": ["d"]}, {}),
         ("relu", {"X": ["a"]}, {"Out": ["c"]}, {})],
        dict(check_shapes=False), None),
    "ptv015_inplace_alias": (
        [("w", dict(persistable=True, **_F32_23)),
         ("g", dict(is_data=True, **_F32_23)),
         ("lr", dict(is_data=True, shape=[1], dtype="float32")),
         ("r", dict(**_F32_23))],
        [("sgd", {"Param": ["w"], "Grad": ["g"], "LearningRate": ["lr"]},
          {"ParamOut": ["w"]}, {}),
         ("relu", {"X": ["w"]}, {"Out": ["r"]}, {})],
        dict(check_shapes=False), "PTV015"),
    "ptv020_shape": (
        [("a", dict(is_data=True, **_F32_23)),
         ("c", dict(shape=[9, 9], dtype="float32"))],
        [("relu", {"X": ["a"]}, {"Out": ["c"]}, {})], {}, "PTV020"),
    "ptv021_dtype": (
        [("a", dict(is_data=True, **_F32_23)),
         ("c", dict(shape=[2, 3], dtype="int32"))],
        [("relu", {"X": ["a"]}, {"Out": ["c"]}, {})], {}, "PTV021"),
    "ptv021_int64_reads_int32": (
        [("a", dict(is_data=True, shape=[2, 3], dtype="int64")),
         ("c", dict(shape=[2, 3], dtype="int64"))],
        [("elementwise_add", {"X": ["a"], "Y": ["a"]}, {"Out": ["c"]},
          {})], {}, None),
    "ptv022_lowering_fails": (
        [("a", dict(is_data=True, **_F32_23)),
         ("w", dict(is_data=True, shape=[5, 4], dtype="float32")),
         ("c", dict(shape=[2, 4], dtype="float32"))],
        [("matmul", {"X": ["a"], "Y": ["w"]}, {"Out": ["c"]}, {})], {},
        "PTV022"),
    "ptv030_feed": (
        [("a", dict(is_data=True, **_F32_23))], [],
        dict(feed_names=["nope"], check_shapes=False), "PTV030"),
    "ptv031_undeclared_fetch": (
        [("a", dict(is_data=True, **_F32_23)),
         ("limbo", dict(**_F32_23))], [],
        dict(fetch_names=["never_declared"], check_shapes=False),
        "PTV031"),
    "ptv031_never_produced": (
        [("a", dict(is_data=True, **_F32_23)),
         ("limbo", dict(**_F32_23))], [],
        dict(fetch_names=["limbo"], check_shapes=False), "PTV031"),
    "ptv031_data_var_is_fine": (
        [("a", dict(is_data=True, **_F32_23)),
         ("limbo", dict(**_F32_23))], [],
        dict(fetch_names=["a"], check_shapes=False), None),
    "ptv040_sub_block": (
        [("a", dict(is_data=True, **_F32_23)), ("b", dict(**_F32_23))],
        [("while", {"X": ["a"]}, {"Out": ["b"]},
          {"sub_block": 7, "output_vars": ["b"], "carried_vars": ["a"],
           "condition": "cond"})],
        dict(check_shapes=False), "PTV040"),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_crafted_programs_give_the_jax_findings(name):
    """Equal findings, `while` included (its shape rule is registered in
    both packages)."""
    var_specs, op_specs, kw, rule = FIXTURES[name]
    rj = jverify(raw_program(fj, var_specs, op_specs), **kw)
    rt = verify_program(raw_program(ft, var_specs, op_specs), **kw)
    assert finding_keys(rt) == finding_keys(rj)
    rules = {d.rule for d in rt.findings}
    if rule is None:
        assert not rt.errors(), rt.summary()
    else:
        assert rule in rules, rt.summary()
        assert all(d.severity == RULES[d.rule][0] for d in rt.findings)


def test_unregistered_op_hint_and_provenance():
    var_specs, op_specs, kw, _ = FIXTURES["ptv001_unregistered"]
    res = verify_program(raw_program(ft, var_specs, op_specs), **kw)
    hit = res.by_rule("PTV001")[0]
    assert hit.where == "reluu:0/0" and "did you mean" in hit.message
    d = Diagnostic(rule="PTV020", message="m", op_type="relu", block=1,
                   op_idx=4, var="x")
    assert d.where == "relu:1/4"
    assert d.to_dict()["severity"] == RULES["PTV020"][0]
    assert Diagnostic(rule="PTV030", message="m").where == "program"
    with pytest.raises(ProgramVerificationError, match="PTV001"):
        res.raise_if_errors()


def test_rule_catalog_is_the_jax_catalog():
    from paddle_tpu.analysis import RULES as JRULES
    assert RULES == JRULES


@pytest.mark.parametrize("model", sorted(BUILDS))
def test_builds_verify_to_the_jax_findings(model):
    mj, mt, _, loss = built(model)
    feed = sorted(feed_for(mt))
    rj = jverify(mj, feed_names=feed, fetch_names=[loss])
    rt = verify_program(mt, feed_names=feed, fetch_names=[loss])
    assert finding_keys(rt) == finding_keys(rj)
    assert not rt.errors(), rt.summary()


@pytest.mark.parametrize("op_type", sorted(chip_smoke.DENSE_OP_TYPES))
def test_one_op_programs_verify_to_the_jax_findings(op_type):
    """Every op type of chip_smoke's dense-op table as a one-op program
    with its gradients: a lowering that failed on meta tensors would
    give PTV022 here where the JAX package gives none."""
    case = chip_smoke.dense_op_cases()[op_type]
    mj, _, feed, fetch = chip_smoke.dense_op_program(fj, op_type, *case)
    mt, _, _, _ = chip_smoke.dense_op_program(ft, op_type, *case)
    assert mt.to_json() == mj.to_json()
    rt = verify_program(mt, feed_names=list(feed), fetch_names=fetch)
    assert finding_keys(rt) == finding_keys(
        jverify(mj, feed_names=list(feed), fetch_names=fetch))
    assert not rt.errors(), rt.summary()


@pytest.mark.parametrize("model", sorted(BUILDS))
def test_memory_plans_equal_the_jax_plans(model):
    from paddle_tpu.analysis import analyze_program_memory as jplan
    mj, mt, _, loss = built(model)
    feed = feed_for(mt)
    shapes = feed_shapes(feed)
    pj = jplan(mj, feed_names=list(feed), fetch_names=[loss],
               feed_shapes=shapes)
    pt = analyze_program_memory(mt, feed_names=list(feed),
                                fetch_names=[loss], feed_shapes=shapes)
    assert pt.to_record() == pj.to_record()
    assert pt.timeline == pj.timeline
    assert {n: iv.to_dict() for n, iv in pt.intervals.items()} == \
        {n: iv.to_dict() for n, iv in pj.intervals.items()}
    assert pt.peak_bytes > 0 and not pt.dynamic
    # the budget findings too, at half the peak
    half = dict(budget_bytes=pt.peak_bytes // 2)
    pj2 = jplan(mj, feed_names=list(feed), fetch_names=[loss],
                feed_shapes=shapes, **half)
    pt2 = analyze_program_memory(mt, feed_names=list(feed),
                                 fetch_names=[loss], feed_shapes=shapes,
                                 **half)
    assert finding_keys(pt2.findings()) == finding_keys(pj2.findings())
    assert "PTV050" in {d.rule for d in pt2.findings().findings}


def test_dynamic_dims_and_spec_units():
    Spec = tshape.Spec
    assert Spec((2, 3), "float32").nbytes() == (24, False)
    assert Spec((2, 3), "bfloat16").nbytes() == (12, False)
    assert Spec((-1, 3), "int64").nbytes() == (24, True)
    main, startup = ft.Program(), ft.Program()
    with ft.program_guard(main, startup):
        x = ft.layers.data(name="x", shape=[8], dtype="float32")
        y = ft.layers.relu(ft.layers.scale(x, scale=2.0))
    plan = analyze_program_memory(main, ["x"], [y.name])
    assert plan.dynamic
    plan = analyze_program_memory(main, ["x"], [y.name],
                                  feed_shapes={"x": ((4, 8), "float32")})
    assert not plan.dynamic
    assert plan.intervals[y.name].nbytes == 4 * 8 * 4


def test_specs_are_inferred_once_per_program_and_feed_signature(
        monkeypatch):
    _, mt, _, loss = built("bert")
    prog = ft.Program.from_json(mt.to_json())  # a fingerprint of its own
    feed = feed_for(prog)
    shapes = feed_shapes(feed)
    calls = []
    real = tshape.infer_program_specs
    monkeypatch.setattr(tshape, "infer_program_specs",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tverifier.reset_memo()
    tmemory.reset_memo()
    try:
        tverifier.verify_gate(prog, list(feed), [loss])
        tmemory.memory_gate(prog, shapes, [loss])
        tmemory.memory_gate(prog, shapes, [])  # other fetches
        verify_program(prog, list(feed), [])   # other fetches
        assert len(calls) == 2
        tverifier.verify_gate(prog, list(feed), [loss])
        assert len(calls) == 2
    finally:
        tverifier.reset_memo()
        tmemory.reset_memo()


# ---------------------------------------------------------------------------
# the gates in Executor.run
# ---------------------------------------------------------------------------

def _bad_program():
    """A fc program whose relu reads a var that nothing declares."""
    main, startup = ft.Program(), ft.Program()
    with ft.program_guard(main, startup):
        x = ft.layers.data(name="x", shape=[4], dtype="float32")
        y = ft.layers.fc(x, size=3)
    bad = main.clone()
    blk = bad.global_block()
    out = blk.create_var(name="bad_out", shape=[-1, 3], dtype="float32")
    blk.ops.append(ft.framework.Operator(
        blk, "relu", {"X": ["undeclared"]}, {"Out": [out.name]}))
    return bad, startup, y, out


def test_error_mode_refuses_before_a_cache_miss():
    bad, startup, _, out = _bad_program()
    prev = flag_guard(ft, program_verify="error")
    try:
        scope = ft.Scope()
        exe = ft.Executor(ft.CPUPlace())
        exe.run(startup, scope=scope)
        misses = exe.cache_stats()["misses"]
        with pytest.raises(ProgramVerificationError, match="PTV010"):
            exe.run(bad, feed={"x": np.ones((2, 4), np.float32)},
                    fetch_list=[out], scope=scope)
        assert exe.cache_stats()["misses"] == misses
    finally:
        ft.set_flags(prev)
        tverifier.reset_memo()


def test_warn_mode_warns_once_then_memoizes():
    main, startup = ft.Program(), ft.Program()
    with ft.program_guard(main, startup):
        x = ft.layers.data(name="x", shape=[4], dtype="float32")
        y = ft.layers.fc(x, size=3)
        ft.layers.tanh(x)  # dead: PTV012
    prev = flag_guard(ft, program_verify="warn")
    tverifier.reset_memo()
    try:
        scope = ft.Scope()
        exe = ft.Executor(ft.CPUPlace())
        exe.run(startup, scope=scope)
        feed = {"x": np.ones((2, 4), np.float32)}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            exe.run(main, feed=feed, fetch_list=[y], scope=scope)
            exe.run(main, feed=feed, fetch_list=[y], scope=scope)
        hits = [w for w in caught if "PTV012" in str(w.message)]
        assert len(hits) == 1 and "[executor]" in str(hits[0].message)
        first = tverifier.verify_gate(main, ["x"], [y.name])
        assert tverifier.verify_gate(main, ["x"], [y.name]) is first
    finally:
        ft.set_flags(prev)
        tverifier.reset_memo()


def test_off_mode_skips_and_bad_values_raise():
    bad, startup, _, out = _bad_program()
    prev = flag_guard(ft, program_verify="off", memory_gate="off",
                      graph_opt_level=0)
    try:
        assert tverifier.verify_gate(bad, ["x"], [out.name]) is None
        assert tmemory.memory_gate(bad, {}, [out.name]) is None
        ft.set_flags({"FLAGS_program_verify": "loud"})
        with pytest.raises(ValueError, match="program_verify"):
            tverifier.verify_gate(bad, ["x"], [out.name])
        ft.set_flags({"FLAGS_memory_gate": "loud"})
        with pytest.raises(ValueError, match="memory_gate"):
            tmemory.memory_gate(bad, {}, [out.name])
    finally:
        ft.set_flags(prev)


def test_flags_have_the_jax_names_and_defaults():
    names = ["FLAGS_program_verify", "FLAGS_graph_opt_level",
             "FLAGS_memory_budget_bytes", "FLAGS_memory_gate",
             "FLAGS_buffer_reuse"]
    from paddle_tpu_torch.core import flags as tflags
    from paddle_tpu.core import flags as jflags
    assert {n: tflags._REGISTRY[n[6:]].default for n in names} == \
        {n: jflags._REGISTRY[n[6:]].default for n in names} == {
            "FLAGS_program_verify": "warn", "FLAGS_graph_opt_level": 1,
            "FLAGS_memory_budget_bytes": 0, "FLAGS_memory_gate": "error",
            "FLAGS_buffer_reuse": True}


def test_memory_gate_refuses_an_over_budget_program():
    from paddle_tpu_torch.core.memory import (device_memory_stats,
                                              scope_memory_stats)
    main, startup = ft.Program(), ft.Program()
    with ft.program_guard(main, startup):
        x = ft.layers.data(name="x", shape=[256], dtype="float32")
        y = ft.layers.fc(x, size=256)
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    # the CPU reports no memory: no budget, the gate cannot fire
    assert device_memory_stats("cpu") == {}
    assert tmemory.resolve_budget_bytes() == 0 or \
        device_memory_stats() != {}
    assert scope_memory_stats(scope)["host_bytes"] == (256 * 256 + 256) * 4
    prev = flag_guard(ft, memory_budget_bytes=4096)
    tmemory.reset_memo()
    try:
        misses = exe.cache_stats()["misses"]
        with pytest.raises(ProgramVerificationError, match="PTV050"):
            exe.run(main, feed={"x": np.ones((8, 256), np.float32)},
                    fetch_list=[y], scope=scope)
        assert exe.cache_stats()["misses"] == misses
        ft.set_flags({"FLAGS_memory_gate": "warn"})
        tmemory.reset_memo()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            exe.run(main, feed={"x": np.ones((8, 256), np.float32)},
                    fetch_list=[y], scope=scope)
        assert any("PTV050" in str(w.message) for w in caught)
        assert exe.cache_stats()["misses"] == misses + 1
    finally:
        ft.set_flags(prev)
        ft.set_flags({"FLAGS_memory_gate": "error"})
        tmemory.reset_memo()


# ---------------------------------------------------------------------------
# the gates in ServingEngine.warmup
# ---------------------------------------------------------------------------

def _save_model(f, path, corrupt=False):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data(name="x", shape=[16], dtype="float32")
        out = f.layers.softmax(f.layers.fc(x, size=3))
    exe = f.Executor(f.CPUPlace())
    scope = f.Scope()
    with f.scope_guard(scope):
        exe.run(startup)
        f.io.save_inference_model(str(path), ["x"], [out], exe,
                                  main_program=main)
    if corrupt:
        import json
        import os
        model = os.path.join(str(path), "__model__.json")
        d = json.load(open(model))
        prog = d["program"] if "program" in d else d
        prog["blocks"][0]["ops"][0]["inputs"]["X"] = ["undeclared"]
        json.dump(d, open(model, "w"))


def _engine(sv, path, **kw):
    """An engine over a CPU predictor of the model at `path`."""
    from importlib import import_module
    inf = import_module(sv.__name__.rsplit(".", 1)[0] + ".inference")
    config = inf.AnalysisConfig(str(path))
    config.disable_gpu()
    cfg = sv.EngineConfig(max_batch_size=4, warmup=False, **kw)
    return sv.ServingEngine(cfg, predictor=inf.create_paddle_predictor(
        config))


def test_warmup_refuses_a_corrupt_model_before_any_cell(tmp_path):
    from paddle_tpu_torch import serving
    _save_model(ft, tmp_path, corrupt=True)
    prev = flag_guard(ft, program_verify="error")
    tverifier.reset_memo()
    try:
        eng = _engine(serving, tmp_path)
        exe = eng.predictor._exe
        with pytest.raises(ProgramVerificationError, match="PTV010"):
            eng.warmup()
        assert exe.cache_stats()["misses"] == 0
        assert eng._warmed_shapes == []
    finally:
        ft.set_flags(prev)
        tverifier.reset_memo()


def test_warmup_refuses_an_oversized_ladder_before_any_cell(tmp_path):
    from paddle_tpu_torch import serving
    _save_model(ft, tmp_path)
    eng = _engine(serving, tmp_path)
    prev = flag_guard(ft, memory_budget_bytes=512)
    tmemory.reset_memo()
    try:
        with pytest.raises(ProgramVerificationError, match="PTV050"):
            eng.warmup()
        assert eng.predictor._exe.cache_stats()["misses"] == 0
    finally:
        ft.set_flags(prev)
        tmemory.reset_memo()


def _warm_stats(f, sv, path):
    from importlib import import_module
    mon = import_module(f"{f.__name__}.monitor")
    f.set_flags({"FLAGS_enable_monitor": True})
    mon.STAT_RESET()
    import_module(f"{f.__name__}.analysis.verifier").reset_memo()
    import_module(f"{f.__name__}.analysis.memory").reset_memo()
    base = import_module(f"{f.__name__}.analysis.passes.base")
    base.reset_memo()
    try:
        eng = _engine(sv, path)
        n = eng.warmup()
        memo = len(base._OPT_MEMO)
        snap = mon.get_stats_snapshot()
        names = set(snap["counters"]) | set(snap["gauges"])
        return n, memo, {k for k in names if k.startswith("analysis.")}
    finally:
        f.set_flags({"FLAGS_enable_monitor": False})
        mon.STAT_RESET()


def test_warmup_primes_the_gates_and_records_the_jax_stat_names(tmp_path):
    import paddle_tpu.serving as jserving
    from paddle_tpu_torch import serving
    _save_model(fj, tmp_path / "j")
    _save_model(ft, tmp_path / "t")
    nj, memo_j, stats_j = _warm_stats(fj, jserving, tmp_path / "j")
    nt, memo_t, stats_t = _warm_stats(ft, serving, tmp_path / "t")
    assert nt == nj and memo_t == memo_j == 1
    assert stats_t == stats_j
    assert {"analysis.programs_verified", "analysis.mem_plans",
            "analysis.mem_peak_bytes"} <= stats_t
