"""The LR schedules on the CPU, the port against the JAX package: each
schedule's value at every step of a run that crosses its boundaries
within 1e-6 relative (cosine_decay's values near 0 also within 1e-12
absolute), the programs byte-identical. The step counter is carried
into the port's scope before the first step, as a resumed run does.

Cases include piecewise_decay and linear_lr_warmup at a step exactly on
a boundary, where both packages' sign masks read 0.5 and the rate is the
mean of the two sides, and polynomial_decay with cycle. The closed forms
that chip_smoke.py holds the card's recipe steps to (`recipe_lr`) are
checked here against the JAX package at the same steps.
"""
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu_torch.convert import scope_from_numpy

RTOL, ATOL = 1e-6, 1e-12


@pytest.fixture(autouse=True)
def _no_clip_leak():
    yield
    fj.clip.set_gradient_clip(None)
    ft.clip.set_gradient_clip(None)


def _warm_poly(L, lr, decay, end, power, warm):
    return L.linear_lr_warmup(
        L.polynomial_decay(lr, decay_steps=decay, end_learning_rate=end,
                           power=power), warmup_steps=warm, start_lr=0.0,
        end_lr=lr)


# name: (builder over a layers module, first step read, steps)
SCHEDULES = {
    "exponential": (lambda L: L.exponential_decay(0.1, 5, 0.5), 1, 12),
    "exponential_staircase": (
        lambda L: L.exponential_decay(0.1, 5, 0.5, staircase=True), 1, 12),
    "natural_exp": (lambda L: L.natural_exp_decay(0.1, 5, 0.5), 1, 12),
    "natural_exp_staircase": (
        lambda L: L.natural_exp_decay(0.1, 5, 0.5, staircase=True), 1, 12),
    "inverse_time": (lambda L: L.inverse_time_decay(0.1, 5, 0.5), 1, 12),
    "inverse_time_staircase": (
        lambda L: L.inverse_time_decay(0.1, 5, 0.5, staircase=True), 1, 12),
    "polynomial": (lambda L: L.polynomial_decay(0.1, 8, 0.001, power=2.0),
                   1, 12),
    "polynomial_cycle": (lambda L: L.polynomial_decay(
        0.1, 4, 0.001, power=1.0, cycle=True), 1, 14),
    "piecewise": (lambda L: L.piecewise_decay([3, 6], [0.1, 0.01, 0.001]),
                  1, 9),
    "noam": (lambda L: L.noam_decay(64, 4), 1, 10),
    "cosine": (lambda L: L.cosine_decay(0.1, 3, 5), 1, 16),
    "warmup_constant": (lambda L: L.linear_lr_warmup(0.1, 4, 0.0, 0.1),
                        1, 8),
    "warmup_piecewise": (lambda L: L.linear_lr_warmup(
        L.piecewise_decay([6], [0.1, 0.05]), 4, 0.01, 0.1), 1, 9),
    "bert_recipe": (lambda L: _warm_poly(L, 1e-4, 1_000_000, 0.0, 1.0,
                                         10_000), 9995, 13),
    "lamb_recipe": (lambda L: _warm_poly(L, 6e-3, 7038, 0.0, 0.5, 2000),
                    1995, 13),
    "resnet_recipe": (lambda L: L.piecewise_decay(
        [150150, 300300, 450450], [0.1, 0.01, 0.001, 0.0001]), 150146, 8),
}


def _build(f, name):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        lr = SCHEDULES[name][0](f.layers)
    return main, startup, lr


def _run_jax(main, startup, lr, first, steps):
    scope = fj.Scope()
    with fj.scope_guard(scope):
        exe = fj.Executor(fj.CPUPlace())
        exe.run(startup)
        scope.set("@STEP_COUNTER@",
                  np.array([first - 1], np.int64).astype(np.int32))
        values = {n: np.asarray(scope.get(n)) for n in scope.names()
                  if scope.find_var(n) is not None}
        out = [float(np.asarray(exe.run(main, fetch_list=[lr])[0])[0])
               for _ in range(steps)]
    return out, values


def _run_port(main, lr, values, steps):
    scope = scope_from_numpy(values, ft.Scope(), ft.CPUPlace(),
                             program=main)
    exe = ft.Executor(ft.CPUPlace())
    out = [float(exe.run(main, fetch_list=[lr.name], scope=scope)[0][0])
           for _ in range(steps)]
    assert exe.cache_stats()["misses"] == 1
    return out, scope


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    mj, sj, lr_j = _build(fj, name)
    mt, st, lr_t = _build(ft, name)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    _, first, steps = SCHEDULES[name]
    want, values = _run_jax(mj, sj, lr_j, first, steps)
    got, scope = _run_port(mt, lr_t, values, steps)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)
    assert len(set(got)) > 1
    counter = scope.get("@STEP_COUNTER@")
    assert str(counter.dtype) == "torch.int64"
    assert int(counter) == first + steps - 1


def test_boundary_reads_the_mean_of_both_sides():
    """At a step exactly on a boundary the masks read 0.5: piecewise
    [3, 6] reads (0.1 + 0.01) / 2 at step 3, and the BERT recipe's
    warmup end reads (1e-4 + 0.99e-4) / 2 = 0.995e-4 at step 10000."""
    for name, step, want in (("piecewise", 3, 0.055),
                             ("bert_recipe", 10_000, 0.995e-4),
                             ("resnet_recipe", 150150, 0.055)):
        mt, st, lr = _build(ft, name)
        scope = ft.Scope()
        exe = ft.Executor(ft.CPUPlace())
        exe.run(st, scope=scope)
        scope.set("@STEP_COUNTER@", scope.get("@STEP_COUNTER@") + step - 1)
        got = float(exe.run(mt, fetch_list=[lr.name], scope=scope)[0][0])
        assert got == pytest.approx(want, rel=RTOL), name


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_lr", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["bert_recipe", "lamb_recipe",
                                  "resnet_recipe"])
def test_chip_smoke_closed_form_matches_jax(name):
    """chip_smoke.recipe_lr, the numpy closed form the card's recipe
    phases are held to, against the JAX package at the phases' steps
    (the profiled step after them included)."""
    smoke = _chip_smoke()
    recipe = smoke.RECIPES[name.split("_")[0]]
    mj, sj, lr_j = _build(fj, name)
    _, first, steps = SCHEDULES[name]
    assert first == recipe["first_step"]
    want, _ = _run_jax(mj, sj, lr_j, first, steps + 1)
    got = [smoke.recipe_lr(recipe, first + i) for i in range(steps + 1)]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_every_n_steps_matches_jax():
    """every_n_steps(3): true at steps 3, 6 and 9 of 9 in both packages,
    through the int64 counter, elementwise_mod and equal."""
    def build(f):
        main, startup = f.Program(), f.Program()
        with f.program_guard(main, startup), f.unique_name.guard():
            cond = f.layers.every_n_steps(3)
        return main, startup, cond
    mj, sj, cj = build(fj)
    mt, st, ct = build(ft)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    scope = fj.Scope()
    with fj.scope_guard(scope):
        exe = fj.Executor(fj.CPUPlace())
        exe.run(sj)
        want = [bool(np.asarray(exe.run(mj, fetch_list=[cj])[0])[0])
                for _ in range(9)]
    scope_t = ft.Scope()
    exe_t = ft.Executor(ft.CPUPlace())
    exe_t.run(st, scope=scope_t)
    got = [bool(exe_t.run(mt, fetch_list=[ct.name], scope=scope_t)[0][0])
           for _ in range(9)]
    assert got == want == [i % 3 == 2 for i in range(9)]
