"""The port's profiler (paddle_tpu_torch/profiler.py, on torch.profiler)
on the CPU.

- extract_op_scope equals the JAX package's on op_name paths of the
  kinds its profiles carry (nested jit scopes, grad::generic, several
  scopes in one path, none).
- Op scopes: under a profiler, every Program op of a LeNet training
  step runs under its '{op.type}:{block}/{op_idx}' scope; without one,
  core/lowering.run_op enters no scope at all (record_function is never
  called); with FLAGS_op_trace_scopes off, none under a profiler
  either.
- summarize_profile: the classes add up to total_us, the convolutions
  land in conv, by_framework_op names conv2d:0/<idx> scopes and holds
  every scope of the step; stop_profiler writes a chrome trace that
  holds the scopes; record_event feeds host_phase_stats, which
  reset_profiler clears, and export_chrome_tracing writes the monitor's
  events.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ft
from paddle_tpu import profiler as jprof
from paddle_tpu_torch import profiler
from paddle_tpu_torch.models import lenet

from test_torch_observability import reset_globals


@pytest.fixture(autouse=True)
def _hygiene():
    reset_globals()
    yield
    reset_globals()
    profiler.reset_profiler()


@pytest.mark.parametrize("path", [
    "conv2d:0/3",
    "jit(step)/jit(main)/conv2d:0/3/conv_general_dilated",
    "jit(step)/grad::generic:0/41/transpose(jvp(mul))",
    "while:0/7/body/elementwise_add:1/2/add",
    "fused_elementwise:0/12",
    "copy_p/parameter.3",
    "",
])
def test_extract_op_scope_matches_jax(path):
    assert profiler.extract_op_scope(path) == jprof.extract_op_scope(path)


@pytest.fixture(scope="module")
def lenet_step():
    """A LeNet training step on the CPU, run once to warm the cache:
    (program, executor, scope, feed, loss)."""
    main, startup = ft.Program(), ft.Program()
    startup.random_seed = 5
    with ft.program_guard(main, startup), ft.unique_name.guard():
        img = ft.layers.data("img", shape=[1, 28, 28], dtype="float32")
        label = ft.layers.data("label", shape=[1], dtype="int64")
        loss, _ = lenet.convolutional_neural_network(img, label)
        ft.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    exe, scope = ft.Executor(ft.CPUPlace()), ft.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(4, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return main, exe, scope, feed, loss


def _step(lenet_step):
    main, exe, scope, feed, loss = lenet_step
    return exe.run(main, feed=feed, fetch_list=[loss], scope=scope)


def test_scopes_only_under_a_profiler(lenet_step, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        calls.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _step(lenet_step)
    assert calls == []
    ops = lenet_step[0].global_block().ops
    with torch.profiler.profile():
        _step(lenet_step)
    assert calls == [f"{op.type}:0/{i}" for i, op in enumerate(ops)]
    calls.clear()
    ft.set_flags({"FLAGS_op_trace_scopes": False})
    with torch.profiler.profile():
        _step(lenet_step)
    assert calls == []


def test_summary_by_class_and_framework_op(lenet_step, tmp_path):
    with profiler.profiler(profile_path=str(tmp_path)):
        with profiler.record_event("train_step"):
            _step(lenet_step)
    s = profiler.summarize_profile()
    assert s["total_us"] > 0
    assert sum(s["by_category"].values()) == pytest.approx(s["total_us"])
    assert set(s["by_category"]) <= {"conv", "norm", "matmul", "other",
                                     "unlinked"}
    assert s["by_category"]["conv"] > 0
    fw = s["by_framework_op"]
    ops = lenet_step[0].global_block().ops
    scopes = {f"{op.type}:0/{i}" for i, op in enumerate(ops)}
    convs = [k for k in fw if k.startswith("conv2d:0/")]
    assert len(convs) == 2 and set(fw) - {"(unattributed)"} <= scopes
    row = fw[convs[0]]
    assert row["op_type"] == "conv2d" and row["block"] == 0
    assert row["host_us"] > 0 and row["calls"] > 0
    assert row["total_us"] == row["device_us"] + row["host_us"]
    assert sum(r["host_us"] for r in fw.values()) == \
        pytest.approx(s["total_us"])
    # the chrome trace of the run holds the op scopes
    trace = json.loads(open(profiler.last_trace_path()).read())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert set(convs) <= names and "train_step" in names
    # record_event's host phase, then the monitor's event export
    assert profiler.host_phase_stats()["train_step"]["count"] == 1
    out = tmp_path / "phases.json"
    assert profiler.export_chrome_tracing(str(out)) and out.exists()
    profiler.reset_profiler()
    assert profiler.host_phase_stats() == {}


def test_cuda_profiler_records_like_profiler(lenet_step, tmp_path):
    """cuda_profiler, kept for source compatibility, is profiler() into
    FLAGS_profiler_trace_dir."""
    ft.set_flags({"FLAGS_profiler_trace_dir": str(tmp_path)})
    with profiler.cuda_profiler():
        _step(lenet_step)
    assert profiler.last_trace_path().startswith(str(tmp_path))
    assert profiler.summarize_profile()["total_us"] > 0


def _chip_smoke():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("total,outside,step,step_outside,ok", [
    # the feed's copies on a slow host: 27.8 ms outside the scopes
    # against 2 x 2.75 in the training step's profile. The op scopes
    # agree (105.4 against 103.1 ms), so the gate passes where totals
    # compared as a whole (133.2 against 108.6) would not
    (133.2, 27.8, 54.3, 2.75, True),
    # the same totals, but the op scopes 12% apart: the gate fails
    (133.2, 10.0, 54.3, 2.75, False),
    (2 * 50.0 * 1.099 + 7.0, 7.0, 50.0 + 3.0, 3.0, True),
    (2 * 50.0 * 1.101 + 7.0, 7.0, 50.0 + 3.0, 3.0, False),
    (2 * 50.0 * 0.899 + 1.0, 1.0, 50.0 + 9.0, 9.0, False),
])
def test_profiler_gate_compares_op_scopes(total, outside, step, step_outside,
                                          ok):
    scoped, want, agree = _chip_smoke().profiler_gate(total, outside, step,
                                                      step_outside)
    assert scoped == pytest.approx(total - outside)
    assert want == pytest.approx(2 * (step - step_outside))
    assert agree is ok
