"""The training surface's optimizers on the CPU, the port against the JAX
package.

- Every update op the surface adds (lars_momentum, adamax, adagrad,
  decayed_adagrad, adadelta, rmsprop plain and centered, ftrl at two
  lr powers, lamb, also on a zero parameter, proximal_gd,
  proximal_adagrad, dpsgd at sigma 0, average_accumulates across its
  roll and window branches) against the JAX lowering on the same seeded
  inputs: float32 outputs within 1e-5 of max(1, max|reference|),
  counters exactly; the port writes Param in place. dpsgd at sigma 1
  draws its noise from another generator than threefry, so both
  packages' noise is held by distribution.
- Every optimizer class and wrapper (ExponentialMovingAverage,
  ModelAverage, LookaheadOptimizer) builds a byte-identical program on a
  small net (fc 8-16 relu, fc 16-1, mean squared error), and 4 steps
  from the JAX package's startup values, carried with
  convert.scope_from_numpy, give losses and every persistable (moments,
  beta powers, shadows, sums, slow weights, step counters) within 1e-5
  of max(1, max|reference|).
- EMA and ModelAverage apply() / restore(), Lookahead at k 2 over 4
  steps, a per-parameter learning rate, and the positional
  minimize(loss, startup) / backward(loss, startup) calls of a plain
  optimizer and of the AMP decorator.
"""
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
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.core import lowering as tlow
from paddle_tpu_torch.core.registry import REGISTRY as TREG

F32_TOL = 1e-5
B, STEPS = 6, 4


@pytest.fixture(autouse=True)
def _no_clip_leak():
    """set_gradient_clip is process-global in both packages."""
    yield
    fj.clip.set_gradient_clip(None)
    ft.clip.set_gradient_clip(None)


def _close(got, want, what):
    want = np.asarray(want)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    tol = F32_TOL * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


# -- update ops -------------------------------------------------------------

def _op(attrs):
    return types.SimpleNamespace(attrs=dict(attrs), id=7, block=None,
                                 type="op", inputs={}, outputs={})


def _jax_lower(op_type, ins, attrs):
    ctx = jlow._OpCtx(jlow.LowerCtx(jax.random.PRNGKey(0)), _op(attrs))
    return JREG.get(op_type).lower(
        ctx, {s: [jnp.asarray(a) for a in vs] for s, vs in ins.items()},
        attrs)


def _port_lower(op_type, ins, attrs, step=0):
    tins = {s: [torch.from_numpy(np.array(a)) for a in vs]
            for s, vs in ins.items()}
    ctx = tlow._OpCtx(tlow.LowerCtx("cpu", step=step), _op(attrs))
    return tins, TREG.get(op_type).lower(ctx, tins, attrs)


def _state(rng, kinds, shape=(5, 4)):
    """Param, Grad, a learning rate and the op's accumulators: "n"
    normal, "p" positive (|normal| + 0.5), a float a [1] beta power."""
    out = {"Param": [rng.randn(*shape).astype(np.float32)],
           "Grad": [rng.randn(*shape).astype(np.float32)],
           "LearningRate": [np.array([0.05], np.float32)]}
    for slot, kind in kinds.items():
        if isinstance(kind, float):
            out[slot] = [np.array([kind], np.float32)]
        else:
            a = rng.randn(*shape).astype(np.float32)
            out[slot] = [np.abs(a) + 0.5 if kind == "p" else a]
    return out


ADAM_STATE = {"Moment1": "n", "Moment2": "p", "Beta1Pow": 0.9 ** 3,
              "Beta2Pow": 0.999 ** 3}
UPDATE_CASES = {
    "lars_momentum": ({"Velocity": "n"}, {
        "mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005}),
    "adamax": ({"Moment": "n", "InfNorm": "p", "Beta1Pow": 0.9 ** 3},
               {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
    "adagrad": ({"Moment": "p"}, {"epsilon": 1e-6}),
    "decayed_adagrad": ({"Moment": "p"}, {"decay": 0.95, "epsilon": 1e-6}),
    "adadelta": ({"AvgSquaredGrad": "p", "AvgSquaredUpdate": "p"},
                 {"rho": 0.95, "epsilon": 1e-6}),
    "rmsprop": ({"MeanSquare": "p", "Moment": "n"}, {
        "decay": 0.95, "epsilon": 1e-6, "momentum": 0.9,
        "centered": False}),
    "rmsprop_centered": ({"MeanSquare": "p", "Moment": "n",
                          "MeanGrad": "n"}, {
        "decay": 0.95, "epsilon": 1e-6, "momentum": 0.9, "centered": True}),
    "ftrl": ({"SquaredAccumulator": "p", "LinearAccumulator": "n"},
             {"l1": 0.01, "l2": 0.02, "lr_power": -0.5}),
    "ftrl_power": ({"SquaredAccumulator": "p", "LinearAccumulator": "n"},
                   {"l1": 0.01, "l2": 0.02, "lr_power": -0.7}),
    "lamb": (ADAM_STATE, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                          "weight_decay": 0.01}),
    "lamb_zero_param": (ADAM_STATE, {"beta1": 0.9, "beta2": 0.999,
                                     "epsilon": 1e-6, "weight_decay": 0.01}),
    "proximal_gd": ({}, {"l1": 0.01, "l2": 0.02}),
    "proximal_adagrad": ({"Moment": "p"}, {"l1": 0.01, "l2": 0.02}),
    "dpsgd": ({}, {"clip": 1.0, "batch_size": 16.0, "sigma": 0.0}),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_op(case):
    """One update within F32_TOL of the JAX lowering, every output slot;
    ParamOut is the Param tensor, updated in place."""
    kinds, attrs = UPDATE_CASES[case]
    op_type = case.replace("_centered", "").replace("_zero_param", "") \
        .replace("_power", "")
    ins = _state(np.random.RandomState(sorted(UPDATE_CASES).index(case)),
                 kinds)
    if case == "lamb_zero_param":
        ins["Param"][0][:] = 0.0
    oj = _jax_lower(op_type, ins, attrs)
    tins, ot = _port_lower(op_type, ins, attrs)
    assert set(ot) == set(oj)
    for slot in oj:
        _close(ot[slot][0].numpy(), oj[slot][0], f"{case} {slot}")
    assert ot["ParamOut"][0] is tins["Param"][0]
    assert not np.allclose(tins["Param"][0].numpy(), ins["Param"][0])
    if case == "lamb_zero_param":
        # trust ratio 1: the step is lr * r exactly
        m1 = 0.9 * ins["Moment1"][0] + 0.1 * ins["Grad"][0]
        m2 = 0.999 * ins["Moment2"][0] + 0.001 * ins["Grad"][0] ** 2
        _close(ot["ParamOut"][0].numpy(),
               -0.05 * (m1 / (np.sqrt(m2) + 1e-6)), "lamb trust 1")


def test_every_update_op_is_registered_as_in_jax():
    for t in ("lars_momentum", "adamax", "adagrad", "decayed_adagrad",
              "adadelta", "rmsprop", "ftrl", "lamb", "proximal_gd",
              "proximal_adagrad", "dpsgd", "average_accumulates"):
        jdef, tdef = JREG.get(t), TREG.get(t)
        assert tdef.inplace and jdef.inplace, t
        assert tdef.stateful == jdef.stateful, t


def test_dpsgd_noise_by_distribution():
    """sigma 1, a zero gradient: ParamOut = -lr * clip * N(0, 1) in both
    packages (threefry's bits cannot be reproduced), held by mean and
    standard deviation over 4096 draws; two steps draw apart."""
    attrs = {"clip": 2.0, "batch_size": 16.0, "sigma": 1.0}
    ins = {"Param": [np.zeros((64, 64), np.float32)],
           "Grad": [np.zeros((64, 64), np.float32)],
           "LearningRate": [np.array([0.5], np.float32)]}
    draws = [np.asarray(_jax_lower("dpsgd", ins, attrs)["ParamOut"][0]),
             _port_lower("dpsgd", ins, attrs)[1]["ParamOut"][0].numpy(),
             _port_lower("dpsgd", ins, attrs, step=1)[1]["ParamOut"][0]
             .numpy()]
    for d in draws:
        z = -d / (0.5 * 2.0)
        assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1) < 0.05
    assert not np.array_equal(draws[1], draws[2])


@pytest.mark.parametrize("case", ["accumulate", "window", "roll"])
def test_average_accumulates(case):
    """ModelAverage's accumulator op: a plain step, a saturated window
    (the sums roll into sum3) and the 16384-update roll into sum2."""
    na, nu = {"accumulate": (3, 3), "window": (12, 20),
              "roll": (5, 16383)}[case]
    rng = np.random.RandomState(4)
    f = lambda: rng.randn(3, 4).astype(np.float32)  # noqa: E731
    ins = {"Param": [f()], "InSum1": [f()], "InSum2": [f()],
           "InSum3": [f()], "InNumAccumulates": [np.array([na], np.int64)],
           "InOldNumAccumulates": [np.array([2], np.int64)],
           "InNumUpdates": [np.array([nu], np.int64)]}
    attrs = {"average_window": 0.5, "max_average_window": 100,
             "min_average_window": 10}
    oj = _jax_lower("average_accumulates", ins, attrs)
    _, ot = _port_lower("average_accumulates", ins, attrs)
    assert set(ot) == set(oj)
    for slot in oj:
        _close(ot[slot][0].numpy(), oj[slot][0], f"{case} {slot}")
    assert ot["OutNumUpdates"][0].dtype == torch.int64
    moved = {"accumulate": "OutSum1", "window": "OutSum3",
             "roll": "OutSum2"}[case]
    assert not np.allclose(ot[moved][0].numpy(), ins["In" + moved[3:]][0])


# -- optimizers on a small net ----------------------------------------------

OPTIMIZERS = {
    "sgd": lambda o: o.SGD(0.1),
    "momentum": lambda o: o.Momentum(0.1, 0.9, use_nesterov=True),
    "lars_momentum": lambda o: o.LarsMomentum(0.1, 0.9),
    "adagrad": lambda o: o.Adagrad(0.1, initial_accumulator_value=0.1),
    "decayed_adagrad": lambda o: o.DecayedAdagrad(0.1),
    "adam": lambda o: o.Adam(0.01),
    "adamw": lambda o: o.AdamW(0.01, weight_decay=0.01),
    "lamb": lambda o: o.Lamb(0.01, lamb_weight_decay=0.01),
    "adamax": lambda o: o.Adamax(0.01),
    "adadelta": lambda o: o.Adadelta(1.0),
    "rmsprop": lambda o: o.RMSProp(0.01, momentum=0.9),
    "rmsprop_centered": lambda o: o.RMSProp(0.01, momentum=0.9,
                                            centered=True),
    "ftrl": lambda o: o.Ftrl(0.1, l1=0.001, l2=0.001),
    "dpsgd": lambda o: o.Dpsgd(0.1, clip=1.0, sigma=0.0),
    "dgc_momentum": lambda o: o.DGCMomentum(0.1, 0.9, rampup_begin_step=0,
                                            sparsity=[0.999]),
}


def _wrapped(name):
    """(optimizer factory, wrapper name) for a case name."""
    if name == "ema":
        return OPTIMIZERS["adam"], "ema"
    if name == "model_average":
        return OPTIMIZERS["momentum"], "model_average"
    if name == "lookahead":
        return OPTIMIZERS["sgd"], "lookahead"
    return OPTIMIZERS[name], None


def _net(f, make_opt, wrapper=None, param_lr=1.0):
    """fc 8-16 relu, fc 16-1, mean squared error; returns (main,
    startup, loss, the wrapper object or None)."""
    main, startup = f.Program(), f.Program()
    startup.random_seed = 5
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data("x", shape=[8], dtype="float32")
        y = f.layers.data("y", shape=[1], dtype="float32")
        h = f.layers.fc(x, 16, act="relu", param_attr=f.ParamAttr(
            name="fc0.w", learning_rate=param_lr))
        pred = f.layers.fc(h, 1, param_attr=f.ParamAttr(name="fc1.w"))
        loss = f.layers.mean(f.layers.square(pred - y))
        opt = make_opt(f.optimizer)
        extra = None
        if wrapper == "lookahead":
            extra = f.optimizer.LookaheadOptimizer(opt, alpha=0.5, k=2)
            extra.minimize(loss, startup)
        else:
            opt.minimize(loss, startup)
        if wrapper == "ema":
            extra = f.optimizer.ExponentialMovingAverage(0.8)
            extra.update()
        elif wrapper == "model_average":
            extra = f.optimizer.ModelAverage(0.15, min_average_window=2,
                                             max_average_window=10)
            extra.attach()
    return main, startup, loss, extra


def _feed():
    rng = np.random.RandomState(3)
    return {"x": rng.randn(B, 8).astype(np.float32),
            "y": rng.randn(B, 1).astype(np.float32)}


def _jax_startup(startup):
    scope = fj.Scope()
    with fj.scope_guard(scope):
        fj.Executor(fj.CPUPlace()).run(startup)
    return scope


def _values(scope):
    return {n: np.asarray(scope.get(n)) for n in scope.names()
            if scope.find_var(n) is not None}


class _Pair:
    """The same program in both packages, the port's scope carried from
    the JAX package's startup values."""

    def __init__(self, name, **kw):
        make, wrapper = _wrapped(name)
        self.mj, sj, self.lj, self.wj = _net(fj, make, wrapper, **kw)
        self.mt, self.st, self.lt, self.wt = _net(ft, make, wrapper, **kw)
        self.sj = _jax_startup(sj)
        self.exe_j = fj.Executor(fj.CPUPlace())
        self.exe_t = ft.Executor(ft.CPUPlace())
        self.scope_t = scope_from_numpy(_values(self.sj), ft.Scope(),
                                        ft.CPUPlace(), program=self.mt)

    def step(self, feed, fetch=()):
        with fj.scope_guard(self.sj):
            oj = self.exe_j.run(self.mj, feed=feed,
                                fetch_list=[self.lj, *fetch])
        ot = self.exe_t.run(self.mt, feed=feed,
                            fetch_list=[self.lt.name, *fetch],
                            scope=self.scope_t)
        return [np.asarray(a) for a in oj], ot

    def persistables(self):
        return sorted(v.name for v in self.mt.list_vars() if v.persistable)

    def check_state(self, what):
        for n in self.persistables():
            got = self.scope_t.get(n)
            _close(got.numpy(), np.asarray(self.sj.get(n)), f"{what} {n}")


CASES = sorted(OPTIMIZERS) + ["ema", "model_average", "lookahead"]


@pytest.mark.parametrize("name", CASES)
def test_program_byte_identical(name):
    make, wrapper = _wrapped(name)
    mj, sj, _, _ = _net(fj, make, wrapper)
    mt, st, _, _ = _net(ft, make, wrapper)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()


@pytest.mark.parametrize("name", CASES)
def test_steps_match_jax(name):
    """4 steps from the JAX startup values: the losses and every
    persistable after the last step."""
    pair = _Pair(name)
    feed = _feed()
    losses_j, losses_t = [], []
    for _ in range(STEPS):
        oj, ot = pair.step(feed)
        losses_j.append(float(oj[0]))
        losses_t.append(float(ot[0]))
    _close(np.array(losses_t), np.array(losses_j), f"{name} losses")
    assert len(set(losses_t)) > 1
    pair.check_state(name)
    if name == "lookahead":
        counter = pair.scope_t.get("@LOOKAHEAD_STEP@")
        assert counter.dtype == torch.int64 and int(counter) == STEPS


def test_ema_and_model_average_apply_restore():
    """apply() swaps the shadow (EMA) or the running average
    (ModelAverage) into the global scope's parameters in both packages;
    restore() puts the trained values back; training on after apply and
    restore leaves the shadow alone."""
    for name in ("ema", "model_average"):
        pair = _Pair(name)
        feed = _feed()
        for _ in range(3):
            pair.step(feed)
        params = sorted(p.name for p in pair.mt.all_parameters())
        trained = {p: pair.scope_t.get(p).clone() for p in params}
        with fj.scope_guard(pair.sj), ft.scope_guard(pair.scope_t):
            pair.wj.apply(pair.exe_j)
            pair.wt.apply(pair.exe_t)
            for p in params:
                got = pair.scope_t.get(p).numpy()
                _close(got, np.asarray(pair.sj.get(p)), f"{name} apply {p}")
                assert not np.allclose(got, trained[p].numpy())
            pair.wj.restore(pair.exe_j)
            pair.wt.restore(pair.exe_t)
        for p in params:
            assert torch.equal(pair.scope_t.get(p), trained[p])
        pair.step(feed)
        pair.check_state(f"{name} after restore")


def test_lookahead_syncs_every_k_steps():
    """k 2, alpha 0.5: after steps 2 and 4 the fast weights equal the
    slow ones (up to the rounding of p + (slow - p)), after steps 1 and 3
    they do not; every step matches the
    JAX package. The slow weights are copies: the in-place update of a
    parameter does not reach them."""
    pair = _Pair("lookahead")
    feed = _feed()
    slow = {p.name: [v.name for v in pair.mt.list_vars()
                     if v.name.startswith(p.name + "_slow")][0]
            for p in pair.mt.all_parameters()}
    init = {p: pair.scope_t.get(p).clone() for p in slow}
    for p, s in slow.items():
        assert torch.equal(pair.scope_t.get(s), init[p])
    exe = ft.Executor(ft.CPUPlace())
    scope = ft.Scope()
    exe.run(pair.st, scope=scope)
    for p, s in slow.items():  # the port's own startup: a copy
        assert torch.equal(scope.get(s), scope.get(p))
        assert scope.get(s).data_ptr() != scope.get(p).data_ptr()
    for step in range(1, 5):
        pair.step(feed)
        pair.check_state(f"lookahead step {step}")
        synced = all(torch.allclose(pair.scope_t.get(p),
                                    pair.scope_t.get(s), rtol=0, atol=1e-7)
                     for p, s in slow.items())
        assert synced == (step % 2 == 0), step


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_per_parameter_learning_rate(name):
    """ParamAttr(learning_rate=0.5) on fc0.w: its update reads a scale
    of the LR var; programs identical, steps equal the JAX package's."""
    make, _ = _wrapped(name)
    mj, _, _, _ = _net(fj, make, param_lr=0.5)
    mt, _, _, _ = _net(ft, make, param_lr=0.5)
    assert mt.to_json() == mj.to_json()
    op_type = "sgd" if name == "sgd" else "adam"
    updates = [op for op in mt.global_block().ops if op.type == op_type]
    lr_of = {op.input("Param")[0]: op.input("LearningRate")[0]
             for op in updates}
    assert lr_of["fc0.w"] != lr_of["fc1.w"]
    scale = [op for op in mt.global_block().ops
             if op.output_names() == [lr_of["fc0.w"]]][0]
    assert scale.type == "scale" and scale.attrs["scale"] == 0.5
    pair = _Pair(name, param_lr=0.5)
    feed = _feed()
    for _ in range(3):
        pair.step(feed)
    pair.check_state(name)


def _positional(f, amp):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data("x", shape=[4], dtype="float32")
        loss = f.layers.mean(f.layers.fc(x, 3))
        opt = f.optimizer.SGD(0.1)
        if amp:
            from importlib import import_module
            mp = import_module(f.__name__ + ".contrib.mixed_precision")
            opt = mp.decorate(opt)
        params_grads = opt.backward(loss, startup)
        if amp:
            opt.apply_gradients(params_grads)
        else:
            opt.apply_optimize(loss, startup, params_grads)
        # a second loss, minimized positionally
        loss2 = f.layers.mean(f.layers.fc(x, 2))
        opt.minimize(loss2, startup)
    return main, startup


@pytest.mark.parametrize("amp", [False, True], ids=["plain", "amp"])
def test_positional_startup_program(amp):
    """opt.backward(loss, startup) and opt.minimize(loss, startup), the
    Fluid idiom, build the same program in both packages."""
    mj, sj = _positional(fj, amp)
    mt, st = _positional(ft, amp)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    assert sum(op.type == "sgd" for op in mt.global_block().ops) == 4


def test_carry_widens_the_step_counter():
    """The JAX scope holds the int64-declared step counter as int32;
    scope_from_numpy(program=...) gives it the port's int64, and the
    increment keeps it there. Without the program it stays int32."""
    pair = _Pair("lookahead")
    assert np.asarray(pair.sj.get("@LOOKAHEAD_STEP@")).dtype == np.int32
    assert pair.scope_t.get("@LOOKAHEAD_STEP@").dtype == torch.int64
    plain = scope_from_numpy(_values(pair.sj), ft.Scope(), ft.CPUPlace())
    assert plain.get("@LOOKAHEAD_STEP@").dtype == torch.int32
    assert plain.get("fc0.w").dtype == torch.float32
    pair.step(_feed())
    assert pair.scope_t.get("@LOOKAHEAD_STEP@").dtype == torch.int64
