"""Gradient clips, regularizers and loss scaling on the CPU, the port
against the JAX package, on a small net (fc 8-16 relu, fc 16-1, mean
squared error, SGD 0.1 unless a case says otherwise).

- GradientClipByValue, GradientClipByNorm and GradientClipByGlobalNorm,
  each with its bound at half of what the unclipped step-1 gradients
  measure (the smallest of their largest |values|, their smallest norm,
  their global norm), so that every gradient is cut: programs byte-identical, 3 steps
  from the JAX startup values with the losses, the clipped gradients
  (the update ops' Grad inputs) and the parameters within 1e-5 of
  max(1, max|reference|), and the step-1 clipped gradients at the bound.
- L1Decay and L2Decay, optimizer-wide and through
  ParamAttr(regularizer=...) (the parameter's own wins over the
  optimizer's): the update's gradient is grad + coeff * param, or
  grad + coeff * sign(param), and the steps match.
- The regularizer runs before the clip: the squared norm reads the
  regularized gradient.
- Static loss scaling under bf16 AMP (init_loss_scaling 128, a power of
  two, so scaling commutes with bf16 rounding): programs byte-identical,
  the unscaled gradients equal to the unscaled step's to the bit. Against
  the JAX package the two frameworks round the bf16 products at other
  points (the head's output is one bf16 product of 16 terms), so the
  steps (SGD 0.01) are held by Frobenius gap: each gradient within 2e-2
  of its norm, tests/test_torch_train.py's AMP gradient bar (measured
  at most 2.0e-3), the loss within 5e-3 (measured 2.5e-4 at step 1 and
  1.7e-3 at step 2, with or without the scaling: scaling by 128 changes
  no bit in either package).
- None of these ops enters the autograd region: no grad op names one,
  and the executor records no autograd graph for them.
"""
import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu_torch.convert import scope_from_numpy

TOL = 1e-5
AMP_RTOL, AMP_LOSS_RTOL = 2e-2, 5e-3
AMP_SGD = lambda o: o.SGD(0.01)  # noqa: E731
B, STEPS = 6, 3


@pytest.fixture(autouse=True)
def _no_clip_leak():
    """set_gradient_clip is process-global in both packages."""
    yield
    fj.clip.set_gradient_clip(None)
    ft.clip.set_gradient_clip(None)


def _close(got, want, what, amp=False):
    want = np.asarray(want)
    if amp:
        gap = float(np.linalg.norm(got - want))
        bar = (AMP_LOSS_RTOL if want.ndim == 0 else AMP_RTOL) * \
            float(np.linalg.norm(want)) + 1e-6
        assert gap <= bar, (what, gap, bar)
        return
    tol = TOL * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


def _net(f, opt=None, fc0_reg=None, amp=False, loss_scaling=1.0):
    main, startup = f.Program(), f.Program()
    startup.random_seed = 5
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data("x", shape=[8], dtype="float32")
        y = f.layers.data("y", shape=[1], dtype="float32")
        h = f.layers.fc(x, 16, act="relu", param_attr=f.ParamAttr(
            name="fc0.w", regularizer=fc0_reg))
        pred = f.layers.fc(h, 1, param_attr=f.ParamAttr(name="fc1.w"))
        loss = f.layers.mean(f.layers.square(pred - y))
        o = (opt or (lambda o: o.SGD(0.1)))(f.optimizer)
        if amp:
            from importlib import import_module
            mp = import_module(f.__name__ + ".contrib.mixed_precision")
            o = mp.decorate(o, init_loss_scaling=loss_scaling,
                            use_dynamic_loss_scaling=True)
        o.minimize(loss, startup)
    return main, startup, loss, o


def _feed():
    rng = np.random.RandomState(3)
    return {"x": rng.randn(B, 8).astype(np.float32),
            "y": rng.randn(B, 1).astype(np.float32)}


def _jax_values(startup):
    scope = fj.Scope()
    with fj.scope_guard(scope):
        fj.Executor(fj.CPUPlace()).run(startup)
    return scope, {n: np.asarray(scope.get(n)) for n in scope.names()
                   if scope.find_var(n) is not None}


def _update_grads(main):
    """{param: the Grad input of its update op}."""
    return {op.input("Param")[0]: op.input("Grad")[0]
            for op in main.global_block().ops if op.input("Param")}


def _run_both(build, steps=STEPS, amp=False):
    """Programs byte-identical; `steps` steps in both from the JAX
    startup values, fetching the loss and every update op's Grad input,
    each within TOL (with `amp`, the AMP bars). Returns (port main, [per
    step: port fetches], port scope)."""
    mj, sj, lj, _ = build(fj)
    mt, st, lt, _ = build(ft)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    grads = _update_grads(mt)
    assert grads == _update_grads(mj)
    fetch = sorted(grads.values())
    scope_j, values = _jax_values(sj)
    scope_t = scope_from_numpy(values, ft.Scope(), ft.CPUPlace(),
                               program=mt)
    exe_j, exe_t = fj.Executor(fj.CPUPlace()), ft.Executor(ft.CPUPlace())
    out = []
    for step in range(steps):
        with fj.scope_guard(scope_j):
            oj = exe_j.run(mj, feed=_feed(), fetch_list=[lj.name, *fetch])
        ot = exe_t.run(mt, feed=_feed(), fetch_list=[lt.name, *fetch],
                       scope=scope_t)
        for name, a, b in zip([lt.name, *fetch], ot, oj):
            _close(a, b, f"step {step} {name}", amp)
        out.append(dict(zip([lt.name, *fetch], ot)))
    for p in grads:
        _close(scope_t.get_numpy(p), np.asarray(scope_j.get(p)), p, amp)
    return mt, out, scope_t


def _plain_grads():
    """The unclipped, unregularized step-1 gradients (port, from the JAX
    startup values) and those values."""
    mt, st, lt, _ = _net(ft)
    _, values = _jax_values(_net(fj)[1])
    grads = _update_grads(mt)
    scope = scope_from_numpy(values, ft.Scope(), ft.CPUPlace(), program=mt)
    got = ft.Executor(ft.CPUPlace()).run(
        mt, feed=_feed(), fetch_list=list(grads.values()), scope=scope)
    return dict(zip(grads, got)), values


@pytest.mark.parametrize("kind", ["value", "norm", "global_norm"])
def test_gradient_clip_binds_and_matches_jax(kind):
    g0, _ = _plain_grads()
    norms = {p: float(np.linalg.norm(g)) for p, g in g0.items()}
    global_norm = float(np.sqrt(sum(n * n for n in norms.values())))
    bound = {"value": 0.5 * min(float(np.abs(g).max())
                                for g in g0.values()),
             "norm": 0.5 * min(norms.values()),
             "global_norm": 0.5 * global_norm}[kind]

    def build(f):
        c = f.clip
        clip = {"value": lambda: c.GradientClipByValue(bound),
                "norm": lambda: c.GradientClipByNorm(bound),
                "global_norm": lambda: c.GradientClipByGlobalNorm(bound)}
        f.clip.set_gradient_clip(clip[kind]())
        try:
            return _net(f)
        finally:
            f.clip.set_gradient_clip(None)

    mt, out, _ = _run_both(build)
    types = [op.type for op in mt.global_block().ops]
    assert {"value": "clip", "norm": "clip_by_norm",
            "global_norm": "squared_l2_norm"}[kind] in types
    grads = _update_grads(mt)
    step1 = {p: out[0][g] for p, g in grads.items()}
    for p, g in step1.items():
        assert not np.allclose(g, g0[p]), f"{kind} did not cut {p}"
    if kind == "value":
        for g in step1.values():
            assert float(np.abs(g).max()) == pytest.approx(bound, rel=1e-6)
    elif kind == "norm":
        for g in step1.values():
            assert float(np.linalg.norm(g)) == pytest.approx(bound,
                                                             rel=1e-5)
    else:
        got = float(np.sqrt(sum(float((g * g).sum())
                                for g in step1.values())))
        assert got == pytest.approx(bound, rel=1e-5)
        for p, g in step1.items():
            _close(g, g0[p] * (bound / global_norm), p)


@pytest.mark.parametrize("where", ["optimizer", "param_attr", "both"])
@pytest.mark.parametrize("kind", ["l1", "l2"])
def test_regularizer_matches_jax(kind, where):
    """Optimizer-wide, on fc0.w through ParamAttr, or both (fc0.w's own
    L1 or L2 at 0.05, the optimizer's the other kind at 0.02): the
    update's gradient is grad + coeff * param (L2) or grad + coeff *
    sign(param) (L1), by the coefficient that applies to it."""
    cls = {"l1": "L1Decay", "l2": "L2Decay"}
    other = {"l1": "l2", "l2": "l1"}[kind]
    opt_kind = {"optimizer": kind, "param_attr": None, "both": other}[where]
    own = kind if where != "optimizer" else None

    def build(f):
        reg = f.regularizer
        opt_reg = getattr(reg, cls[opt_kind])(0.02) if opt_kind else None
        own_reg = getattr(reg, cls[own])(0.05) if own else None
        return _net(f, opt=lambda o: o.SGD(0.1, regularization=opt_reg),
                    fc0_reg=own_reg)

    g0, values = _plain_grads()
    mt, out, _ = _run_both(build)
    grads = _update_grads(mt)
    for p, g in grads.items():
        applies = own if p == "fc0.w" and own else opt_kind
        coeff = 0.05 if p == "fc0.w" and own else 0.02
        if applies is None:
            want = g0[p]
        else:
            w = values[p]
            want = g0[p] + coeff * (np.sign(w) if applies == "l1" else w)
        _close(out[0][g], want, f"{where} {p}")


def test_regularizer_runs_before_the_clip():
    """L2Decay and GradientClipByGlobalNorm together: each squared norm
    reads the regularized gradient (the regularizer's elementwise_add
    output), and the steps match the JAX package."""
    def build(f):
        f.clip.set_gradient_clip(f.clip.GradientClipByGlobalNorm(0.1))
        try:
            return _net(f, opt=lambda o: o.Momentum(
                0.1, 0.9, regularization=f.regularizer.L2Decay(0.02)))
        finally:
            f.clip.set_gradient_clip(None)

    mt, _, _ = _run_both(build)
    ops = mt.global_block().ops
    adds = {op.output("Out")[0]: i for i, op in enumerate(ops)
            if op.type == "elementwise_add"}
    norms = [(i, op.input("X")[0]) for i, op in enumerate(ops)
             if op.type == "squared_l2_norm"]
    assert len(norms) == 4
    assert all(x in adds and adds[x] < i for i, x in norms)


def test_static_loss_scaling_under_amp():
    """decorate(init_loss_scaling=128, use_dynamic_loss_scaling=True):
    the loss is scaled and each gradient unscaled by scale ops before
    the update (dynamic scaling degenerates to the static scale, as in
    the JAX package); the unscaled gradients equal the unscaled AMP
    step's to the bit; the steps match the JAX package's at the AMP
    bars."""
    mt, out, _ = _run_both(lambda f: _net(f, opt=AMP_SGD, amp=True,
                                          loss_scaling=128.0), amp=True)
    _, _, _, opt = _net(ft, amp=True, loss_scaling=128.0)
    assert opt.get_loss_scaling() == 128.0
    ops = mt.global_block().ops
    scales = [op for op in ops if op.type == "scale"]
    assert scales[0].attrs["scale"] == 128.0
    assert sum(op.attrs["scale"] == 1.0 / 128.0 for op in scales) == 4
    assert "cast" in {op.type for op in ops}
    m1, out1, _ = _run_both(lambda f: _net(f, opt=AMP_SGD, amp=True),
                            amp=True)
    g128, g1 = _update_grads(mt), _update_grads(m1)
    for p in g128:
        np.testing.assert_array_equal(out[0][g128[p]], out1[0][g1[p]],
                                      err_msg=p)


def test_surface_ops_stay_out_of_autograd():
    """The schedule (before the forward), the regularizer and the clip
    (after the backward): no grad op names one as its forward, the
    executor records autograd graphs for forward ops only, and a fetched
    clipped gradient carries no graph."""
    def build(f):
        f.clip.set_gradient_clip(f.clip.GradientClipByGlobalNorm(0.1))
        try:
            main, startup = f.Program(), f.Program()
            with f.program_guard(main, startup), f.unique_name.guard():
                L = f.layers
                lr = L.linear_lr_warmup(L.piecewise_decay(
                    [3], [0.1, 0.05]), 2, 0.0, 0.1)
                x = L.data("x", shape=[8], dtype="float32")
                y = L.data("y", shape=[1], dtype="float32")
                pred = L.fc(L.fc(x, 16, act="relu"), 1)
                loss = L.mean(L.square(pred - y))
                f.optimizer.Adam(lr, regularization=f.regularizer.L2Decay(
                    0.01)).minimize(loss)
            return main, startup, loss
        finally:
            f.clip.set_gradient_clip(None)

    mj, _, _ = build(fj)
    main, startup, loss = build(ft)
    assert main.to_json() == mj.to_json()
    ops = main.global_block().ops
    first_fwd = min(i for i, op in enumerate(ops) if op.type == "mul")
    last_grad = max(i for i, op in enumerate(ops)
                    if op.type == "grad::generic")
    surface = {op.id for op in ops[:first_fwd]} | \
        {op.id for op in ops[last_grad + 1:]}
    assert len(surface) > 20
    fwd_ids = {op.attrs["fwd_id"] for op in ops
               if op.type == "grad::generic"}
    assert not fwd_ids & surface
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    prepared = exe._prepare(main, main.global_block(), scope, [loss.name])
    assert prepared.record_ids == fwd_ids
    clipped = _update_grads(main)["fc_0.w_0"]
    g, = exe.run(main, feed=_feed(), fetch_list=[clipped], scope=scope,
                 return_numpy=False)
    assert not g.requires_grad and g.grad_fn is None


# -- the ops the surface adds, each against the JAX lowering ---------------

def _lower_both(op_type, ins, attrs):
    import types

    import jax
    import jax.numpy as jnp
    import torch

    from paddle_tpu.core import lowering as jlow
    from paddle_tpu.core.registry import REGISTRY as JREG
    from paddle_tpu_torch.core import lowering as tlow
    from paddle_tpu_torch.core.registry import REGISTRY as TREG

    op = types.SimpleNamespace(attrs=dict(attrs), id=7, block=None,
                               type=op_type, inputs={}, outputs={})
    oj = JREG.get(op_type).lower(
        jlow._OpCtx(jlow.LowerCtx(jax.random.PRNGKey(0)), op),
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}, attrs)
    ot = TREG.get(op_type).lower(
        tlow._OpCtx(tlow.LowerCtx("cpu"), op),
        {s: [torch.from_numpy(np.array(a)) for a in v]
         for s, v in ins.items()}, attrs)
    return np.asarray(oj["Out"][0]), ot["Out"][0].numpy()


_RNG = np.random.RandomState(8)
_X = (_RNG.randn(3, 4) * 2).astype(np.float32)
_POS = (np.abs(_X) + 0.1).astype(np.float32)
_ROW = _RNG.randn(4).astype(np.float32)
_COL = _RNG.randn(3).astype(np.float32)
_INT = np.array([[7, -7, 9, 0], [-3, 5, 6, -8]], np.int64)
_DIV = np.array([3, 3, -4, 5], np.int64)
SURFACE_OPS = {
    "elementwise_sub": ({"X": [_X], "Y": [_ROW]}, {"axis": -1}),
    "elementwise_div": ({"X": [_X], "Y": [_POS]}, {"axis": -1}),
    "elementwise_max": ({"X": [_X], "Y": [_COL]}, {"axis": 0}),
    "elementwise_min": ({"X": [_X], "Y": [_ROW]}, {"axis": -1}),
    "elementwise_pow": ({"X": [_POS], "Y": [_ROW]}, {"axis": -1}),
    "elementwise_mod": ({"X": [_INT], "Y": [_DIV]}, {"axis": -1}),
    "elementwise_floordiv": ({"X": [_INT], "Y": [_DIV]}, {"axis": -1}),
    "elementwise_mod_float": ({"X": [_X], "Y": [_POS]}, {"axis": -1}),
    "equal": ({"X": [_INT], "Y": [_DIV]}, {}),
    "exp": ({"X": [_X]}, {}), "abs": ({"X": [_X]}, {}),
    "ceil": ({"X": [_X]}, {}), "floor": ({"X": [_X]}, {}),
    "cos": ({"X": [_X]}, {}), "reciprocal": ({"X": [_X]}, {}),
    "square": ({"X": [_X]}, {}), "sqrt": ({"X": [_POS]}, {}),
    "pow": ({"X": [_POS]}, {"factor": -0.5}),
    "sign": ({"X": [np.array([-2.0, 0.0, 3.0], np.float32)]}, {}),
    "clip": ({"X": [_X]}, {"min": -0.5, "max": 1.0}),
    "clip_by_norm": ({"X": [_X]}, {"max_norm": 1.0}),
    "clip_by_norm_below": ({"X": [_X]}, {"max_norm": 100.0}),
    "squared_l2_norm": ({"X": [_X]}, {}),
    "increment": ({"X": [np.array([41], np.int64)]}, {"step": 1.0}),
    "increment_float": ({"X": [np.array([0.5], np.float32)]},
                        {"step": 2.0}),
}


@pytest.mark.parametrize("case", sorted(SURFACE_OPS))
def test_surface_op_matches_jax(case):
    """Each op the schedules, clips and regularizers reach: float
    outputs within 1e-6 of max(1, max|reference|), integer and bool
    outputs exactly; an int64 counter stays int64 in the port."""
    op_type = case.replace("_float", "").replace("_below", "")
    ins, attrs = SURFACE_OPS[case]
    want, got = _lower_both(op_type, ins, attrs)
    assert got.shape == want.shape, case
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=1e-6 * max(1.0, float(np.abs(want).max())), err_msg=case)
    else:
        np.testing.assert_array_equal(got, want, err_msg=case)
    if case == "increment":
        assert got.dtype == np.int64 and int(got[0]) == 42


def test_weighted_average_matches_jax():
    a, b = fj.average.WeightedAverage(), ft.average.WeightedAverage()
    for v, w in ((0.5, 2), (np.array([1.0, 3.0]), 1), (2.0, 3)):
        a.add(v, w)
        b.add(v, w)
    np.testing.assert_array_equal(b.eval(), a.eval())
    b.reset()
    with pytest.raises(ValueError, match="no data"):
        b.eval()
