"""The port's sharding analyzer, SpecLayout and sharding gate against the
JAX package's (analysis/sharding.py, parallel/layout.py).

The same programs are built by both packages: the crafted ones of
tests/test_sharding_analysis.py (a PTV060 conflict, a non-divisible
hint, one- and two-sided matmul contractions, a reduction over a
sharded dim) and small BERT, GPT and MLP training programs. Over the
same rank-free meshes (MeshDims (8,), (4, 2), (2, 2, 2)) the layout
tables are equal spec for spec, and the reports' findings, priced
collectives and collective_bytes_per_step are equal. The gate's modes,
its memo, and its refusals in Executor.run and ServingEngine.warmup
behave as the JAX package's (before the cache records a miss).
"""
import contextlib
import warnings

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.analysis import analyze_program_sharding as j_analyze
from paddle_tpu.parallel import layout as jlayout
from paddle_tpu_torch.analysis import (ProgramVerificationError,
                                       analyze_program_sharding)
from paddle_tpu_torch.analysis.sharding import (_remap_reshape, reset_memo,
                                                sharding_gate)
from paddle_tpu_torch.parallel import layout as tlayout
from paddle_tpu_torch.parallel.layout import (DATA_AXIS, FSDP_AXIS,
                                              MODEL_AXIS, MeshDims,
                                              PartitionSpec as P,
                                              SpecLayout, mesh_from_spec)

MESHES = ((8,), (4, 2), (2, 2, 2))


@contextlib.contextmanager
def _gate_flags(mode, mesh):
    prev = ft.get_flags(["FLAGS_sharding_verify", "FLAGS_sharded_mesh"])
    ft.set_flags({"FLAGS_sharding_verify": mode,
                  "FLAGS_sharded_mesh": mesh})
    reset_memo()
    try:
        yield
    finally:
        ft.set_flags(prev)
        reset_memo()


def _conflict(f):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data("x", shape=[-1, 8, 8], dtype="float32",
                          append_batch_size=False)
        a = f.layers.shard_hint(x, [None, "dp", None])
        b = f.layers.shard_hint(x, [None, None, "dp"])
        out = f.layers.elementwise_add(a, b)
    return main, startup, out


def _nondivisible(f):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data("x", shape=[6, 16], dtype="float32",
                          append_batch_size=False)
        out = f.layers.shard_hint(x, ["dp", None])
    return main, startup, out


def _contractions(f):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data("x", shape=[8, 16], dtype="float32",
                          append_batch_size=False)
        y = f.layers.data("y", shape=[16, 4], dtype="float32",
                          append_batch_size=False)
        a = f.layers.shard_hint(x, [None, "tp"])
        b = f.layers.shard_hint(y, ["tp", None])
        f.layers.matmul(a, b)
        f.layers.matmul(a, y)
        out = f.layers.reduce_sum(a, dim=1)
    return main, startup, out


def _mlp(f):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data("x", shape=[16], dtype="float32")
        y = f.layers.data("y", shape=[1], dtype="float32")
        h = f.layers.fc(x, size=32, act="relu")
        loss = f.layers.mean(f.layers.square_error_cost(
            f.layers.fc(h, size=1), y))
        f.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _bert(f):
    from importlib import import_module
    transformer = import_module(f"{f.__name__}.models.transformer")
    cfg = transformer.bert_base(n_layers=2, d_model=64, n_heads=4,
                                d_ff=128, vocab_size=120, max_seq_len=32,
                                dropout=0.0, attn_dropout=0.0,
                                use_flash=False)
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        loss, _ = transformer.build_train(cfg, 8, 32, lr=1e-4)
    return main, startup, loss


def _gpt(f):
    from importlib import import_module
    gpt = import_module(f"{f.__name__}.models.gpt")
    cfg = gpt.gpt_small(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                        d_ff=64, max_seq_len=16, dropout=0.0,
                        attn_dropout=0.0, use_flash=False)
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        loss, _, _ = gpt.build_train(cfg, 8, 16, lr=1e-3)
    return main, startup, loss


BUILDERS = {"conflict": _conflict, "nondivisible": _nondivisible,
            "contractions": _contractions, "mlp": _mlp, "bert": _bert,
            "gpt": _gpt}


def _findings(res):
    return sorted(str((d.rule, d.severity, d.op_type, d.op_idx, d.var,
                       d.message)) for d in res.findings)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_reports_equal_the_jax_package(name):
    """Layout tables, findings, priced collectives and the per-step
    collective bytes equal the JAX package's on every mesh."""
    mj = BUILDERS[name](fj)[0]
    mt = BUILDERS[name](ft)[0]
    assert mt.to_json() == mj.to_json()
    for dims in MESHES:
        lj = jlayout.SpecLayout(jlayout.MeshDims(dims)).add_program(mj)
        lt = SpecLayout(MeshDims(dims)).add_program(mt)
        assert lt._table.keys() == lj._table.keys()
        for n in lj._table:
            assert tuple(lt._table[n]) == tuple(lj._table[n]), (dims, n)
            assert lt.shard_count(n) == lj.shard_count(n)
        rj, rt = j_analyze(mj, lj), analyze_program_sharding(mt, lt)
        assert _findings(rt.result) == _findings(rj.result), dims
        assert rt.collective_bytes_per_step == \
            rj.collective_bytes_per_step, dims
        assert [c.to_dict() for c in rt.costs] == \
            [c.to_dict() for c in rj.costs], dims
        assert rt.rows == rj.rows and rt.uncovered == rj.uncovered
        assert lt.fallbacks == lj.fallbacks
        assert lt.gradient_sync_bytes(mt) == lj.gradient_sync_bytes(mj)
        assert lt.collective_bytes_estimate(mt) == \
            rt.collective_bytes_per_step


def test_remap_reshape_rules():
    sizes = {"dp": 4, "tp": 2}

    def size(p):
        n = 1
        for a in (p if isinstance(p, (tuple, list)) else (p,)):
            n *= sizes.get(str(a), 1)
        return n
    from paddle_tpu.analysis.sharding import _remap_reshape as j_remap
    for args in (((8, 16), ("dp", None), (8, 16)),
                 ((8, 16), ("dp", None), (128,)),
                 ((8, 16), (None, "dp"), (128,)),
                 ((128,), ("dp",), (8, 16)),
                 ((6,), ("dp",), (2, 3))):
        assert _remap_reshape(*args, size) == j_remap(*args, size)


def test_mesh_from_spec_and_layout_rules():
    """The port's mesh of ranks parses as the JAX package's mesh of
    devices; the divisibility fallbacks and the state_spec_fn contract
    are the JAX package's."""
    m = mesh_from_spec("2")
    assert m.axis_names == (DATA_AXIS,) and m.shape[DATA_AXIS] == 2
    assert m.size == 2 and list(m.devices) == [0, 1]
    m2 = mesh_from_spec("4x2")
    assert m2.axis_names == (DATA_AXIS, MODEL_AXIS)
    assert (m2.shape[DATA_AXIS], m2.shape[MODEL_AXIS]) == (4, 2)
    m3 = mesh_from_spec("2,2,2")
    assert m3.axis_names == (DATA_AXIS, MODEL_AXIS, FSDP_AXIS)
    assert m3.coords(5) == (1, 0, 1)
    for bad in ("0", "", "-4,2", "2,2,2,2"):
        with pytest.raises(ValueError):
            mesh_from_spec(bad)
    lay = SpecLayout(MeshDims((8,)))
    assert lay.feed_spec("x", (12, 16)) == P()
    assert lay.feed_spec("x", (16, 4)) == P(DATA_AXIS)
    assert lay.zero_spec("w_moment1_0", (12, 4)) == P()
    assert lay.zero_spec("w_moment1_0", (16, 4)) == P(DATA_AXIS, None)
    lay2 = SpecLayout(MeshDims((4, 3)))
    assert lay2.param_spec("w", (8, 10)) == P()
    assert lay2.param_spec("w", (8, 9)) == P(None, MODEL_AXIS)
    assert lay2.spec_for("fc_0.w_0_moment1_0", (8, 9)) == \
        P(DATA_AXIS, MODEL_AXIS)
    assert lay2.spec_for("learning_rate_0", (1,)) == P()
    assert lay2.spec_for("fc_0.b_0", (64,)) == P()
    assert str(P(DATA_AXIS, None)) == \
        str(jlayout.PartitionSpec(DATA_AXIS, None))
    lay._table["w_moment1_0"] = lay.zero_spec("w_moment1_0", (16, 4))
    lay._table["b_0"] = P()
    assert lay("w_moment1_0") == P(DATA_AXIS, None)
    assert lay("b_0") is None and lay("never_seen") is None
    assert tlayout.mesh_axes_for(2) == jlayout.mesh_axes_for(2)


def test_gate_modes_warn_once_and_memoize():
    main, _, out = _nondivisible(ft)
    with _gate_flags("off", "8"):
        assert sharding_gate(main) is None
    with _gate_flags("warn", ""):
        assert sharding_gate(main) is None
    with _gate_flags("bogus", "8"):
        with pytest.raises(ValueError):
            sharding_gate(main)
    shapes = {"x": ((6, 16), "float32")}
    with _gate_flags("warn", "8"):
        with pytest.warns(UserWarning, match="sharding analysis"):
            rep1 = sharding_gate(main, feed_shapes=shapes,
                                 fetch_names=[out.name], where="t")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rep2 = sharding_gate(main, feed_shapes=shapes,
                                 fetch_names=[out.name], where="t")
        assert rep2 is rep1
        assert not [w for w in caught
                    if "sharding analysis" in str(w.message)]


def test_executor_and_warmup_gates_refuse_before_a_miss(tmp_path):
    """error mode: the PTV060 program raises in Executor.run before the
    cache records a miss, every call; the saved model raises in
    ServingEngine.warmup before any cell runs."""
    from paddle_tpu_torch import inference, serving
    main, startup, out = _conflict(ft)
    feed = {"x": np.zeros((2, 8, 8), np.float32)}
    d = str(tmp_path / "model")
    exe = ft.Executor(ft.CPUPlace())
    scope = ft.Scope()
    with ft.scope_guard(scope):
        exe.run(startup)
        ft.io.save_inference_model(d, ["x"], [out], exe,
                                   main_program=main)
    with _gate_flags("error", "8"):
        for _ in range(2):
            with pytest.raises(ProgramVerificationError, match="PTV060"):
                exe.run(main, feed=feed, fetch_list=[out], scope=scope)
        assert exe.cache_stats()["misses"] == 1  # the startup's
        config = inference.AnalysisConfig(d)
        config.disable_gpu()
        eng = serving.ServingEngine(
            serving.EngineConfig(max_batch_size=2, warmup=False),
            predictor=inference.create_paddle_predictor(config))
        with pytest.raises(ProgramVerificationError, match="PTV060"):
            eng.warmup()
        assert eng.cache_stats()["misses"] == 0
