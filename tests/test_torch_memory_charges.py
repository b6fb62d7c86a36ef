"""The memory planner's device charges (analysis/memory.py).

`peak_bytes` stays the JAX package's plan (tests/test_torch_analysis.py
holds it equal); `device_peak_bytes` adds what torch holds on the card,
and is what the gate prices, so the gate only grows stricter. Each charge
is pinned on a crafted program: the allocator's rounding, the GEMM
workspaces, the autograd records (a forward op's inputs and outputs held
to its grad op, and the log-softmax and dropout mask its lowering
saves), an unrolled `recurrent` loop's steps at the batch, and the
per-rank plan under a SpecLayout (ZeRO-sharded moments).
"""
import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.analysis import analyze_program_memory as j_plan
from paddle_tpu_torch.analysis import memory
from paddle_tpu_torch.analysis import analyze_program_memory as plan_of

MIB = 1 << 20


def test_alloc_bytes_rounds_blocks_and_segments():
    assert memory.alloc_bytes(0) == 0
    assert memory.alloc_bytes(1) == 512
    assert memory.alloc_bytes(1000) == 1024
    assert memory.alloc_bytes(MIB) == MIB
    assert memory.alloc_bytes(MIB + 1) == 2 * MIB
    assert memory.alloc_bytes(5 * MIB) == 6 * MIB


def test_workspace_bytes_reads_the_cublas_config(monkeypatch):
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    assert memory.workspace_bytes() == 2 * 32 * MIB
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:2:16:8")
    assert memory.workspace_bytes() == 2 * (4096 * 1024 * 2 + 16 * 1024 * 8)


def _elementwise(f):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data("x", shape=[250], dtype="float32")
        y = f.layers.relu(f.layers.scale(x, scale=2.0))
    return main, y


def test_rounding_and_no_workspace_without_a_gemm():
    """Two transients of 1000 B each at batch 1 (x 250 float32): each is
    charged 1024 B; no GEMM, no workspace; no grad op, no records."""
    main, y = _elementwise(ft)
    p = plan_of(main, ["x"], [y.name], {"x": ((1, 250), "float32")})
    c = p.device_charges
    assert c["workspaces"] == 0 and c["autograd_records"] == 0
    assert c["loop_steps"] == 0
    assert c["alloc_rounding"] == 3 * 24  # x, the scale and y, pinned
    assert p.device_peak_bytes == p.peak_bytes + 72


def test_gemm_charges_the_workspaces_and_records_hold_inputs():
    """fc + softmax_with_cross_entropy + dropout under backward: the
    workspaces once; the log-softmax (the logits' bytes) and the keep
    mask (a byte an element) held from the forward op to its grad op."""
    main, startup = ft.Program(), ft.Program()
    with ft.program_guard(main, startup), ft.unique_name.guard():
        x = ft.layers.data("x", shape=[64], dtype="float32")
        lbl = ft.layers.data("y", shape=[1], dtype="int64")
        h = ft.layers.dropout(ft.layers.fc(x, size=256), 0.1)
        logits = ft.layers.fc(h, size=1000)
        loss = ft.layers.mean(ft.layers.softmax_with_cross_entropy(
            logits, lbl))
        ft.optimizer.SGD(0.1).minimize(loss)
    shapes = {"x": ((32, 64), "float32"), "y": ((32, 1), "int64")}
    p = plan_of(main, ["x", "y"], [loss.name], shapes)
    c = p.device_charges
    assert c["workspaces"] == memory.workspace_bytes()
    logp, mask = 32 * 1000 * 4, 32 * 256
    assert c["autograd_records"] >= logp + mask - 32 * 256 * 4
    assert p.device_peak_bytes == p.peak_bytes + sum(c.values())


def test_recurrent_steps_count_once_a_step_at_the_batch():
    """An unrolled GRU over T 6 at batch 4: its sub-block's vars (sized
    at batch 1 in the plan) count 6 times at batch 4 until its grad."""
    from paddle_tpu_torch.models import seq2seq
    main, startup = ft.Program(), ft.Program()
    with ft.program_guard(main, startup), ft.unique_name.guard():
        loss = seq2seq.build_train(src_vocab=50, trg_vocab=50, src_len=6,
                                   trg_len=6, hidden=16, emb_dim=8)[0]
    shapes = {n: ((4, 6), "int64") for n in ("src_ids", "trg_in",
                                             "trg_next")}
    p = plan_of(main, list(shapes), [loss.name], shapes)
    one = {k: iv for k, iv in p.intervals.items() if k.endswith("@b1")}
    assert one and all(iv.dynamic for iv in one.values())
    per_step = sum(memory.Spec(iv.shape, iv.dtype).nbytes(4)[0]
                   for iv in one.values())
    assert p.device_charges["loop_steps"] >= 6 * per_step - sum(
        iv.nbytes for iv in one.values())


def test_gate_is_stricter_than_the_jax_plan():
    """A budget between the JAX plan's peak and the device peak: the
    JAX package's plan fits, the port's gate refuses (PTV050 naming the
    charges)."""
    from paddle_tpu_torch.analysis import ProgramVerificationError
    main_t, y_t = _elementwise(ft)
    main_j, y_j = _elementwise(fj)
    shapes = {"x": ((3, 250), "float32")}
    pt = plan_of(main_t, ["x"], [y_t.name], shapes)
    pj = j_plan(main_j, ["x"], [y_j.name], shapes)
    assert pt.peak_bytes == pj.peak_bytes < pt.device_peak_bytes
    budget = (pt.peak_bytes + pt.device_peak_bytes) // 2
    assert not pj.__class__(main_j, pj.intervals, pj.timeline,
                            pj.pinned_bytes, 0,
                            budget_bytes=budget).findings().errors()
    prev = ft.get_flags(["FLAGS_memory_budget_bytes"])
    ft.set_flags({"FLAGS_memory_budget_bytes": budget})
    memory.reset_memo()
    try:
        with pytest.raises(ProgramVerificationError, match="device peak"):
            memory.memory_gate(main_t, feed_shapes=shapes,
                               fetch_names=[y_t.name])
    finally:
        ft.set_flags(prev)
        memory.reset_memo()


def test_per_rank_plan_divides_zero_sharded_moments():
    """Under SpecLayout(MeshDims((2,))) AdamW's moments of even dim 0
    are held half a rank: the pinned bytes drop by half of theirs."""
    from paddle_tpu_torch.parallel.layout import MeshDims, SpecLayout
    main, startup = ft.Program(), ft.Program()
    with ft.program_guard(main, startup), ft.unique_name.guard():
        x = ft.layers.data("x", shape=[16], dtype="float32")
        loss = ft.layers.mean(ft.layers.fc(x, size=32))
        ft.optimizer.Adam(0.01).minimize(loss)
    shapes = {"x": ((8, 16), "float32")}
    whole = plan_of(main, ["x"], [loss.name], shapes)
    layout = SpecLayout(MeshDims((2,))).add_program(main)
    rank = plan_of(main, ["x"], [loss.name], shapes, layout=layout)
    moments = sum(iv.nbytes for n, iv in whole.intervals.items()
                  if "_moment" in n and iv.shape[0] % 2 == 0)
    assert moments > 0
    assert whole.pinned_bytes - rank.pinned_bytes == moments // 2
    assert np.isclose(rank.device_peak_bytes,
                      whole.device_peak_bytes - moments // 2, rtol=0.01)


def test_retry_frees_what_a_failed_attempt_held_without_gc():
    """A retried transient fault leaves no reference cycle: what the
    attempt's closure held (an executor step's state tensors) is freed
    when RetryPolicy.call returns, not at the next cyclic garbage
    collection (a generation run's card memory grew by a KV pool pair
    until one ran)."""
    import gc
    import weakref
    from paddle_tpu_torch.resilience.faults import TransientFault
    from paddle_tpu_torch.resilience.retry import RetryPolicy

    class State:
        pass

    def run():
        state, calls = State(), [0]

        def attempt():
            calls[0] += 1
            if calls[0] == 1 and state is not None:
                raise TransientFault("injected")
            return calls[0]
        policy = RetryPolicy(is_retryable=lambda e: isinstance(
            e, TransientFault))
        assert policy.call(attempt) == 2
        return weakref.ref(state)
    gc.disable()
    try:
        assert run()() is None
    finally:
        gc.enable()
