"""Shared by the control-flow, sequence, RNN and gradient-merge tests of
the port: one program-building function run in both packages, and runs
of both programs from the JAX package's startup state."""
import warnings

import numpy as np

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu_torch.convert import scope_from_numpy


def build(f, fn, seed=11):
    """(main, startup, fn(f)) built under fresh unique names."""
    main, startup = f.Program(), f.Program()
    startup.random_seed = seed
    with f.program_guard(main, startup), f.unique_name.guard():
        out = fn(f)
    return main, startup, out


def build_both(fn, seed=11):
    """The JAX and the port builds of `fn`; asserts their programs (main
    and startup) serialize to the same JSON and fingerprint."""
    bj, bt = build(fj, fn, seed), build(ft, fn, seed)
    for pj, pt in zip(bj[:2], bt[:2]):
        assert pj.to_json() == pt.to_json()
        assert pj.fingerprint() == pt.fingerprint()
    return bj, bt


def run_both(bj, bt, feeds, fetch):
    """Run JAX startup, carry its state to the port, then run each feed
    of `feeds` through both mains: (JAX fetches per run, port fetches per
    run, JAX state after, port state after)."""
    (mj, sj, _), (mt, _, _) = bj, bt
    scope = fj.Scope()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with fj.scope_guard(scope):
            exe = fj.Executor(fj.CPUPlace())
            exe.run(sj)
            init = {n: np.asarray(scope.get(n)) for n in scope.names()
                    if scope.find_var(n) is not None}
            got_j = [[np.asarray(x) for x in exe.run(mj, feed=fd,
                                                     fetch_list=fetch)]
                     for fd in feeds]
            after_j = {n: np.asarray(scope.get(n)) for n in init}
        tscope = scope_from_numpy(init, ft.Scope(), ft.CPUPlace(),
                                  program=mt)
        exe_t = ft.Executor(ft.CPUPlace())
        got_t = [[np.asarray(x) for x in exe_t.run(
            mt, feed=fd, fetch_list=fetch, scope=tscope)] for fd in feeds]
    after_t = {n: tscope.get_numpy(n) for n in init}
    return got_j, got_t, after_j, after_t


def assert_close(got_t, got_j, tol):
    """Floats within `tol` of max(1, max|JAX|); the rest exactly (int32
    in the JAX package is int64 in the port)."""
    for i, (t, j) in enumerate(zip(got_t, got_j)):
        t, j = np.asarray(t), np.asarray(j)
        assert t.shape == j.shape, (i, t.shape, j.shape)
        if j.dtype.kind == "f":
            scale = max(1.0, float(np.abs(j[np.isfinite(j)]).max(
                initial=0.0)))
            np.testing.assert_allclose(t, j, rtol=0, atol=tol * scale,
                                       err_msg=str(i))
        else:
            np.testing.assert_array_equal(t, j.astype(t.dtype),
                                          err_msg=str(i))


def fro(a, b):
    """||a - b|| / ||b||."""
    b = np.asarray(b, np.float64)
    n = np.linalg.norm(b)
    d = np.linalg.norm(np.asarray(a, np.float64) - b)
    return d / n if n else d
