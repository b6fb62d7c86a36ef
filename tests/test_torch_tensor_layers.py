"""The tensor layers, initializers and op types of the static-graph basics
slice, each built by both packages and run on the CPU.

- Each layer case builds the same program in both packages (byte-equal
  JSON), runs the JAX startup, carries its scope over with
  convert.scope_from_numpy and runs both main programs on one seeded
  numpy feed: float outputs within 1e-6 of max(1, max|JAX|), integer,
  index and bool outputs exactly; where the layer is differentiable,
  the input's gradient (fetched as `x@GRAD`) within the same 1e-6.
- Adaptive pool2d (max and avg), from a Program the JAX package built
  and the port loads by Program.from_json: output and gradient within
  1e-6, and the JAX NotImplementedError for sizes that do not divide.
- Bilinear and NumpyArray initializers give the JAX package's values
  exactly. TruncatedNormal and MSRA draw from each framework's own
  generator (the random bits differ by design), so they are held by
  their bounds (exact: |z| <= 2 std, |u| <= sqrt(6 / fan_in)) and by
  their moments against the closed form and the JAX draws.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.core.registry import REGISTRY as TREG

FLOAT_TOL = 1e-6
NEW_OPS = ("arg_max", "arg_min", "fill_constant_batch_size_like",
           "fill_zeros_like", "linspace", "eye", "diag", "reverse",
           "isfinite", "has_inf", "has_nan", "truncated_gaussian_random",
           "assign_value", "load", "load_combine", "save", "save_combine")


def _build(f, fn, seed=7):
    main, startup = f.Program(), f.Program()
    startup.random_seed = seed
    with f.program_guard(main, startup), f.unique_name.guard():
        fetch = fn(f)
    return main, startup, fetch


def _jax_run(main, startup, feed, fetch):
    scope = fj.Scope()
    with fj.scope_guard(scope):
        exe = fj.Executor(fj.CPUPlace())
        exe.run(startup)
        out = exe.run(main, feed=feed, fetch_list=fetch)
    params = {n: np.asarray(scope.get(n)) for n in scope.names()
              if scope.find_var(n) is not None}
    return [np.asarray(o) for o in out], params


def run_both(fn, feed, grad_of=()):
    """(JAX fetches, port fetches) of fn's fetch list plus the gradients
    `<name>@GRAD` of `grad_of`, the port run from the JAX startup."""
    mj, sj, fetch_j = _build(fj, fn)
    mt, st, fetch_t = _build(ft, fn)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    names = [v.name for v in fetch_j] + [f"{n}@GRAD" for n in grad_of]
    got_j, params = _jax_run(mj, sj, feed, names)
    scope = scope_from_numpy(params, ft.Scope(), ft.CPUPlace(), program=mt)
    got_t = ft.Executor(ft.CPUPlace()).run(mt, feed=feed, fetch_list=names,
                                           scope=scope)
    return got_j, got_t


def assert_same(got_t, got_j):
    for t, j in zip(got_t, got_j):
        t, j = np.asarray(t), np.asarray(j)
        assert t.shape == j.shape
        if j.dtype.kind == "f":
            tol = FLOAT_TOL * max(1.0, float(np.abs(j).max(initial=0.0)))
            np.testing.assert_allclose(t, j, rtol=0, atol=tol)
        else:
            assert t.dtype.kind == j.dtype.kind
            np.testing.assert_array_equal(t, j)


def _x(f, shape=(2, 3, 8, 8)):
    x = f.layers.data("x", list(shape[1:]), dtype="float32")
    x.stop_gradient = False
    return x


def _loss(f, *outs):
    loss = f.layers.mean(outs[0])
    for o in outs[1:]:
        loss = loss + f.layers.mean(o)
    f.backward.append_backward(loss)


def _feed(shape=(2, 3, 8, 8), seed=0):
    return {"x": np.random.RandomState(seed).randn(*shape)
            .astype(np.float32)}


def test_new_op_types_are_registered():
    for op in NEW_OPS:
        assert JREG.has(op) and TREG.has(op), op
    assert len(TREG.types()) >= 96 + len(NEW_OPS)


def _case_arg(f):
    x = _x(f)
    return [f.layers.argmax(x, axis=1), f.layers.argmin(x, axis=-1),
            f.layers.argmax(x), f.layers.argmin(x, axis=2)]


def _case_fills(f):
    x = _x(f)
    return [f.layers.fill_constant_batch_size_like(x, [-1, 5], "float32",
                                                   2.5),
            f.layers.fill_constant_batch_size_like(x, [4, -1, 3], "int64",
                                                   7, input_dim_idx=1,
                                                   output_dim_idx=1),
            f.layers.zeros_like(x), f.layers.ones_like(x),
            f.layers.ones([2, 3], "float32"), f.layers.zeros([4], "int64")]


def _case_ranges(f):
    return [f.layers.linspace(0.0, 1.0, 7, "float32"),
            f.layers.linspace(-3.5, 11.25, 33, "float32"),
            f.layers.linspace(2.0, 2.0, 1, "float32"),
            f.layers.eye(3), f.layers.eye(3, 5, dtype="float32"),
            f.layers.eye(4, 2, dtype="int64")]


def _case_checks(f):
    x = _x(f)
    return [f.layers.isfinite(x), f.layers.has_inf(x), f.layers.has_nan(x)]


def _case_assign(f):
    ints = f.layers.assign(np.arange(6, dtype=np.int64).reshape(2, 3))
    flt = f.layers.assign(np.linspace(-1, 1, 10, dtype=np.float32))
    i32 = f.layers.assign(np.array([[3, -4]], np.int32))
    return [ints, flt, i32]


def _case_reverse_diag(f):
    x = _x(f)
    r1 = f.layers.reverse(x, 1)
    r2 = f.layers.reverse(x, [2, 3])
    v = f.layers.reshape(f.layers.slice(x, [1, 2, 3], [0, 0, 0],
                                        [1, 1, 1]), [-1])
    d = f.layers.diag(v)
    _loss(f, r1 * r1, r2, d * d)
    return [r1, r2, d]


def _case_create(f):
    t = f.layers.create_tensor("float32", name="t0")
    p = f.layers.create_parameter([3, 4], "float32", name="p0",
                                  default_initializer=f.initializer.Constant(
                                      0.5))
    b = f.layers.create_parameter([4], "float32", is_bias=True)
    x = _x(f, (2, 3))
    y = f.layers.elementwise_add(f.layers.matmul(x, p), b)
    f.layers.assign(y, t)
    _loss(f, y * y)
    return [t, y, p]


LAYER_CASES = {
    "arg": (_case_arg, ()),
    "fills": (_case_fills, ()),
    "ranges": (_case_ranges, ()),
    "checks": (_case_checks, ()),
    "assign": (_case_assign, ()),
    "reverse_diag": (_case_reverse_diag, ("x",)),
    "create": (_case_create, ("x", "p0.w_0")),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(case):
    fn, grads = LAYER_CASES[case]
    shape = (2, 3) if case == "create" else (2, 3, 8, 8)
    feed = {} if case in ("ranges", "assign") else _feed(shape)
    got_j, got_t = run_both(fn, feed, grads)
    assert_same(got_t, got_j)


@pytest.mark.parametrize("bad", ["nan", "inf", "-inf"])
def test_checks_see_a_bad_value(bad):
    feed = _feed()
    feed["x"][1, 2, 3, 4] = float(bad)
    got_j, got_t = run_both(_case_checks, feed)
    assert_same(got_t, got_j)
    assert not bool(got_t[0])
    assert bool(got_t[1]) == (bad != "nan")
    assert bool(got_t[2]) == (bad == "nan")


def test_arg_ties_take_the_first_index():
    feed = {"x": np.zeros((2, 3, 8, 8), np.float32)}
    feed["x"][:, :, 2:5, :] = 1.0
    got_j, got_t = run_both(_case_arg, feed)
    assert_same(got_t, got_j)


# -- adaptive pool2d -------------------------------------------------------

def _adaptive(f, size, ptype):
    x = _x(f)
    out = f.layers.adaptive_pool2d(x, size, ptype)
    _loss(f, out * out)
    return [out]


@pytest.mark.parametrize("ptype", ["max", "avg"])
@pytest.mark.parametrize("size", [[2, 4], 4, [1, 1], [8, 8]])
def test_adaptive_pool2d_from_a_jax_program(size, ptype):
    mj, sj, fetch = _build(fj, lambda f: _adaptive(f, size, ptype))
    feed = _feed()
    names = [fetch[0].name, "x@GRAD"]
    got_j, _ = _jax_run(mj, sj, feed, names)
    mt = ft.Program.from_json(mj.to_json())
    got_t = ft.Executor(ft.CPUPlace()).run(mt, feed=feed, fetch_list=names,
                                           scope=ft.Scope())
    assert_same(got_t, got_j)
    # the port's own layer builds the same program
    mt2, _, _ = _build(ft, lambda f: _adaptive(f, size, ptype))
    assert mt2.to_json() == mj.to_json()


def test_adaptive_pool2d_indivisible_sizes_raise():
    mj, sj, fetch = _build(fj, lambda f: [
        f.layers.adaptive_pool2d(_x(f), [3, 3], "avg")])
    with pytest.raises(NotImplementedError):
        _jax_run(mj, sj, _feed(), [fetch[0].name])
    mt = ft.Program.from_json(mj.to_json())
    with pytest.raises(NotImplementedError, match="divisible"):
        ft.Executor(ft.CPUPlace()).run(mt, feed=_feed(),
                                       fetch_list=[fetch[0].name],
                                       scope=ft.Scope())


def test_adaptive_pool2d_require_index_raises():
    """The reference returns (out, mask) with require_index; the JAX
    package drops the mask and returns out. The port raises instead."""
    with pytest.raises(NotImplementedError, match="indices"):
        _build(ft, lambda f: [f.layers.adaptive_pool2d(
            _x(f), 2, "max", require_index=True)])


# -- initializers ----------------------------------------------------------

def _startup_values(f, shape, init, seed=7, place=None):
    main, startup = f.Program(), f.Program()
    startup.random_seed = seed
    with f.program_guard(main, startup), f.unique_name.guard():
        p = f.layers.create_parameter(shape, "float32", name="w",
                                      default_initializer=init)
    if f is fj:
        scope = fj.Scope()
        with fj.scope_guard(scope):
            fj.Executor(fj.CPUPlace()).run(startup)
        return np.asarray(scope.get(p.name)), startup
    scope = ft.Scope()
    ft.Executor(ft.CPUPlace()).run(startup, scope=scope)
    return scope.get_numpy(p.name), startup


@pytest.mark.parametrize("shape", [[2, 3, 4, 4], [3, 1, 5, 5],
                                   [1, 2, 6, 3]])
def test_bilinear_initializer_equals_jax(shape):
    got_j, sj = _startup_values(fj, shape, fj.initializer.Bilinear())
    got_t, st = _startup_values(ft, shape, ft.initializer.Bilinear())
    assert st.to_json() == sj.to_json()
    np.testing.assert_array_equal(got_t, got_j)


@pytest.mark.parametrize("value", [np.arange(12.0).reshape(3, 4),
                                   np.linspace(-2, 2, 12).reshape(3, 4)
                                   .astype(np.float32)])
def test_numpy_array_initializer_equals_jax(value):
    got_j, sj = _startup_values(fj, [3, 4],
                                fj.initializer.NumpyArrayInitializer(value))
    got_t, st = _startup_values(ft, [3, 4],
                                ft.initializer.NumpyArrayInitializer(value))
    assert st.to_json() == sj.to_json()
    np.testing.assert_array_equal(got_t, got_j)
    np.testing.assert_array_equal(got_t, value.astype(np.float32))


# a standard normal truncated to [-2, 2]: its standard deviation
_TRUNC_STD = math.sqrt(1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi)
                       / math.erf(2 / math.sqrt(2)))


@pytest.mark.parametrize("loc,scale", [(0.0, 1.0), (0.5, 0.02)])
def test_truncated_normal_by_bounds_and_moments(loc, scale):
    shape = [256, 512]
    got_j, sj = _startup_values(fj, shape, fj.initializer.TruncatedNormal(
        loc, scale))
    got_t, st = _startup_values(ft, shape, ft.initializer.TruncatedNormal(
        loc, scale))
    assert st.to_json() == sj.to_json()
    assert not np.array_equal(got_t, got_j)  # the bits differ by design
    n = got_t.size
    for got in (got_t, got_j):
        z = (got.astype(np.float64) - loc) / scale
        assert np.abs(z).max() <= 2.0 + 1e-6
        assert abs(z.mean()) < 5 * _TRUNC_STD / math.sqrt(n)
        assert abs(z.std() - _TRUNC_STD) < 0.01
    # the draws reach out to the bound
    assert np.abs(got_t - loc).max() > 1.9 * scale


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("shape", [[512, 256], [64, 32, 3, 3]])
def test_msra_by_bounds_and_moments(uniform, shape):
    fan_in = shape[0] if len(shape) == 2 else shape[1] * 9
    std = math.sqrt(2.0 / fan_in)
    got_j, sj = _startup_values(fj, shape, fj.initializer.MSRA(uniform))
    got_t, st = _startup_values(ft, shape, ft.initializer.MSRA(uniform))
    assert st.to_json() == sj.to_json()
    n = got_t.size
    for got in (got_t, got_j):
        g = got.astype(np.float64)
        if uniform:
            assert np.abs(g).max() <= math.sqrt(6.0 / fan_in) * (1 + 1e-6)
        assert abs(g.mean()) < 5 * std / math.sqrt(n)
        assert abs(g.std() / std - 1) < 0.02


def test_new_initializers_in_dygraph():
    """The eager Layer materialises the new initializers on the host."""
    from paddle_tpu_torch import dygraph
    with dygraph.guard(ft.CPUPlace()):
        layer = dygraph.Layer()
        t = layer.create_parameter(
            [64, 64], initializer=ft.initializer.TruncatedNormal(0, 0.5))
        m = layer.create_parameter([64, 16], initializer=ft.initializer.MSRA())
        a = layer.create_parameter(
            [2, 2], initializer=ft.initializer.NumpyArrayInitializer(
                np.eye(2)))
        assert float(np.abs(t.numpy()).max()) <= 1.0 + 1e-6
        assert float(np.abs(m.numpy()).max()) <= math.sqrt(6 / 64) + 1e-6
        np.testing.assert_array_equal(a.numpy(), np.eye(2))


def test_init_on_cpu_and_framework_names():
    for f in (fj, ft):
        assert not f.initializer.force_init_on_cpu()
        with f.initializer.init_on_cpu():
            assert f.initializer.force_init_on_cpu()
        assert not f.initializer.force_init_on_cpu()
        assert [type(p).__name__ for p in f.cpu_places(2)] == \
            ["CPUPlace", "CPUPlace"]

    def build(f):
        x = f.layers.data("x", [4])
        with f.name_scope("block1"):
            y = f.layers.fc(x, 3, param_attr=f.WeightNormParamAttr(
                dim=0, name="wn.w"))
        return [y]

    mj, sj, _ = _build(fj, build)
    mt, st, _ = _build(ft, build)
    assert mt.to_json() == mj.to_json() and st.to_json() == sj.to_json()
    assert ft.WeightNormParamAttr(dim=1).dim == 1
    got_j, got_t = run_both(build, {"x": np.ones((2, 4), np.float32)})
    assert_same(got_t, got_j)


def test_truncated_gaussian_op_draws_per_step():
    """The op's generator folds in the step: two runs of one program give
    two draws, both inside the bounds."""
    main, startup = ft.Program(), ft.Program()
    with ft.program_guard(main, startup):
        out = main.global_block().create_var(name="o", shape=[1000],
                                             dtype="float32")
        main.global_block().append_op(
            "truncated_gaussian_random", outputs={"Out": ["o"]},
            attrs={"shape": [1000], "dtype": "float32", "mean": 1.0,
                   "std": 3.0}, infer_shape=False)
    exe = ft.Executor(ft.CPUPlace())
    a, = exe.run(main, fetch_list=[out], scope=ft.Scope())
    b, = exe.run(main, fetch_list=[out], scope=ft.Scope())
    assert not np.array_equal(a, b)
    for v in (a, b):
        assert np.abs(v - 1.0).max() <= 6.0 + 1e-5
    assert torch.special.ndtri(torch.tensor(0.5)).item() == 0.0
