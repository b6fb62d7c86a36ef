"""The port's TrainerGuard (paddle_tpu_torch/resilience/trainer_guard.py)
on the CPU, against the JAX package's.

A tiny classifier (fc 3 -> 3, softmax cross entropy, SGD lr 0.1) with
the same startup values in both packages:

- NaN rollback: a batch with a NaN is skipped (step() returns None) and
  the state equals the snapshot before it, whether the NaN shows in the
  fetches or FLAGS_check_nan_inf raises FloatingPointError mid-step;
  max_nan_skips ends the run with NanStepError. The guard's counters
  and losses equal the JAX guard's on the non-finite fetch (losses
  within rtol 1e-6: one small float32 product).
- Preemption: the fault injector's preempt_at delivers a real SIGTERM
  to the guard's chained handler; the in-flight step completes, the
  guard writes its checkpoint (guard_state.json last) and raises
  PreemptedError; a fresh guard's resume() returns the consumed count,
  and the resumed run's losses and final parameters equal an
  uninterrupted run's bit for bit, as in the JAX package's test.
- Watchdog: a step made slow on an injected clock (the guard's `time`
  is patched; the step advances it past the timeout and waits for the
  watchdog) dumps the flight recorder exactly once for that step.
"""
import contextlib
import json
import os
import threading

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.resilience import TrainerGuard as JGuard
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch.resilience import (NanStepError, PreemptedError,
                                         TrainerGuard, reset_injector)
from paddle_tpu_torch.resilience import trainer_guard as tguard

from test_torch_observability import reset_globals


@pytest.fixture(autouse=True)
def _hygiene():
    reset_globals()
    yield
    reset_globals()


def _build(f):
    main, startup = f.Program(), f.Program()
    startup.random_seed = 3
    with f.program_guard(main, startup), f.unique_name.guard("tg_"):
        x = f.layers.data("x", shape=[-1, 3], dtype="float32",
                          append_batch_size=False)
        y = f.layers.data("y", shape=[-1, 1], dtype="int64",
                          append_batch_size=False)
        logits = f.layers.fc(x, size=3)
        loss = f.layers.mean(f.layers.softmax_with_cross_entropy(logits, y))
        f.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _batches(n, nan_at=()):
    rng = np.random.RandomState(7)
    out = []
    for i in range(n):
        b = {"x": rng.randn(4, 3).astype(np.float32),
             "y": rng.randint(0, 3, (4, 1)).astype(np.int64)}
        if i in nan_at:
            b["x"][0, 0] = np.nan
        out.append(b)
    return out


def _persist(main, scope):
    return {v.name: scope.get_numpy(v.name).copy()
            for v in main.list_vars()
            if v.persistable and not v.is_data and scope.has(v.name)}


def _port(init=None):
    """(main, loss, scope, exe) of the port on the CPU, with `init`'s
    values when given."""
    main, startup, loss = _build(ft)
    scope, exe = ft.Scope(), ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    for n, a in (init or {}).items():
        scope.set(n, ft.convert.tensor_from_numpy(a, exe.device))
    return main, loss, scope, exe


@contextlib.contextmanager
def _flags(pkg, **kv):
    prev = {k: getattr(pkg.FLAGS, k) for k in kv}
    pkg.set_flags({f"FLAGS_{k}": v for k, v in kv.items()})
    try:
        yield
    finally:
        pkg.set_flags({f"FLAGS_{k}": v for k, v in prev.items()})


def _run(guard, batches):
    return [None if out is None else float(out[0])
            for out in (guard.step(b) for b in batches)]


@pytest.mark.parametrize("check_nan_inf", [False, True],
                         ids=["nonfinite_fetch", "check_nan_inf"])
def test_nan_step_rolls_back_like_jax(check_nan_inf):
    batches = _batches(5, nan_at=(2,))
    main, loss, scope, exe = _port()
    init = _persist(main, scope)
    got = {}
    with _flags(ft, check_nan_inf=check_nan_inf):
        guard = TrainerGuard(exe, main, scope=scope, fetch_list=[loss],
                             install_sigterm=False)
        try:
            losses = _run(guard, batches[:2])
            before = _persist(main, scope)
            losses += _run(guard, batches[2:3])
            # the poisoned step's update never happened
            after = _persist(main, scope)
            assert all(np.array_equal(after[n], before[n]) for n in before)
            losses += _run(guard, batches[3:])
            got["torch"] = (losses, guard.global_step, guard.nan_skips)
        finally:
            guard.close()
    mj, sj, lj = _build(fj)
    scope_j = fj.Scope()
    for n, a in init.items():
        scope_j.set(n, a)
    # the JAX guard on its non-finite fetch: with FLAGS_check_nan_inf its
    # CPU executor surfaces the op's FloatingPointError as a
    # JaxRuntimeError from the host callback, which its guard does not
    # take (ROADMAP §C); the port's run_op raises FloatingPointError
    with fj.scope_guard(scope_j):
        guard = JGuard(fj.Executor(fj.CPUPlace()), mj, scope=scope_j,
                       fetch_list=[lj], install_sigterm=False)
        try:
            got["jax"] = (_run(guard, batches), guard.global_step,
                          guard.nan_skips)
        finally:
            guard.close()
    (lt, gt, nt), (lj_, gj, nj) = got["torch"], got["jax"]
    assert (gt, nt) == (gj, nj) == (5, 1)
    assert [x is None for x in lt] == [x is None for x in lj_] == \
        [False, False, True, False, False]
    np.testing.assert_allclose([x for x in lt if x is not None],
                               [x for x in lj_ if x is not None], rtol=1e-6)


def test_max_nan_skips_raises():
    main, loss, scope, exe = _port()
    guard = TrainerGuard(exe, main, scope=scope, fetch_list=[loss],
                         max_nan_skips=2, install_sigterm=False)
    try:
        nan = _batches(3, nan_at=(0, 1, 2))
        assert guard.step(nan[0]) is None and guard.step(nan[1]) is None
        with pytest.raises(NanStepError):
            guard.step(nan[2])
    finally:
        guard.close()


def test_preempt_checkpoint_resume_bit_identical(tmp_path):
    nb, nan_at, preempt_step = 8, 2, 4
    batches = _batches(nb, nan_at=(nan_at,))
    main0, _, scope0, _ = _port()
    init = _persist(main0, scope0)

    main_a, loss_a, scope_a, exe_a = _port(init)
    guard = TrainerGuard(exe_a, main_a, scope=scope_a, fetch_list=[loss_a],
                         install_sigterm=False)
    try:
        losses_a = _run(guard, batches)
    finally:
        guard.close()
    assert losses_a[nan_at] is None

    ck = str(tmp_path / "ck")
    main_b, loss_b, scope_b, exe_b = _port(init)
    guard = TrainerGuard(exe_b, main_b, scope=scope_b, fetch_list=[loss_b],
                         checkpoint_dir=ck)
    try:
        with _flags(ft, fault_spec=f"preempt_at:step={preempt_step}"
                                   ":site=executor"), \
                pytest.raises(PreemptedError) as ei:
            reset_injector()
            _run(guard, batches)
    finally:
        guard.close()
        reset_injector()
    consumed = ei.value.global_step
    # the executor's counter is 0-based: step 4 fires during the 5th
    # batch, which completes before the checkpoint
    assert consumed == preempt_step + 1
    assert ei.value.checkpoint_dir == ck and TrainerGuard.has_checkpoint(ck)
    state = json.loads(open(os.path.join(ck, "guard_state.json")).read())
    assert state["global_step"] == consumed and state["nan_skips"] == 1

    main_c, loss_c, scope_c, exe_c = _port()
    guard = TrainerGuard(exe_c, main_c, scope=scope_c, fetch_list=[loss_c],
                         checkpoint_dir=ck, install_sigterm=False)
    try:
        skip = guard.resume(ck)
        assert skip == consumed
        losses_c = _run(guard, batches[skip:])
    finally:
        guard.close()
    assert losses_c == losses_a[consumed:]
    final_a, final_c = _persist(main_a, scope_a), _persist(main_c, scope_c)
    for n in final_a:
        np.testing.assert_array_equal(final_c[n], final_a[n])


class _SlowClock:
    """The guard's `time`: monotonic() and perf_counter() read `now`,
    which only the test moves."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    perf_counter = monotonic


def test_watchdog_dumps_the_flight_recorder_once_per_stuck_step(
        tmp_path, monkeypatch):
    clock = _SlowClock()
    monkeypatch.setattr(tguard, "time", clock)
    fr = str(tmp_path / "fr.jsonl")
    main, loss, scope, exe = _port()
    fired = threading.Event()
    real_dump = tguard.dump_flight_recorder

    def dump(*a, **kw):
        out = real_dump(*a, **kw)
        fired.set()
        return out

    monkeypatch.setattr(tguard, "dump_flight_recorder", dump)

    class SlowExecutor:
        """Runs the step, then holds it past the timeout on the guard's
        clock until the watchdog has dumped."""
        device = exe.device

        def run(self, *a, **kw):
            out = exe.run(*a, **kw)
            clock.now += 5.0
            assert fired.wait(60.0), "the watchdog never fired"
            return out

    with _flags(ft, enable_monitor=True, flight_recorder_path=fr):
        guard = TrainerGuard(SlowExecutor(), main, scope=scope,
                             fetch_list=[loss], watchdog_timeout_s=0.2,
                             install_sigterm=False)
        try:
            assert guard.step(_batches(1)[0]) is not None
        finally:
            guard.close()
        fires = tmon.get_stats_snapshot()["counters"].get(
            "resilience.watchdog_fires")
    assert fires == 1
    head = json.loads(open(fr).readline())
    assert head["kind"] == "flight_dump"
    assert head["reason"] == "watchdog_stuck_step"
