"""The MoE FFN (parallel/moe.py, layers.moe_ffn) against the JAX
package's: the dense and the capacity-based sparse formulations over a
mesh ep2 at two gloo ranks, the single-device dense evaluation, and the
static program of tests/test_parallel.py:474 on one rank and over ep2.
"""
import numpy as np
import pytest

import paddle_tpu as fj
import torch_parallel_jobs as jobs
from torch_parallel_pool import make_pool_fixture

pool = make_pool_fixture()

E, D, F = 8, 16, 32


def _case(seed):
    from paddle_tpu.parallel.moe import init_moe_params
    params = {k: np.asarray(v) for k, v in
              init_moe_params(seed, E, D, F).items()}
    rng = np.random.RandomState(seed + 3)
    x = rng.randn(2, 6, D).astype(np.float32)
    cot = rng.randn(2, 6, D).astype(np.float32)
    return x, params, cot


def _jax(x, params, capacity, cot):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from paddle_tpu.parallel.moe import (moe_ffn_sharded,
                                         moe_ffn_sparse_sharded)
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2), ("ep",))

    def f(p, xx):
        if capacity is None:
            return moe_ffn_sharded(xx, p, mesh, ep_axis="ep")
        return moe_ffn_sparse_sharded(xx, p, mesh, ep_axis="ep",
                                      capacity=capacity)
    @jax.jit
    def run(p, xx, c):
        (y, load), vjp = jax.vjp(f, p, xx)
        return y, load, vjp((c, jnp.zeros_like(load)))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    y, load, (gp, gx) = run(jp, jnp.asarray(x), jnp.asarray(cot))
    grads = {k: np.asarray(v) for k, v in gp.items()}
    grads["x"] = np.asarray(gx)
    return np.asarray(y), float(load), grads


def test_init_moe_params_equal_the_jax_package():
    from paddle_tpu.parallel.moe import init_moe_params as jinit
    from paddle_tpu_torch.parallel.moe import init_moe_params as tinit
    a, b = jinit(7, 4, 8, 16), tinit(7, 4, 8, 16)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy())


@pytest.mark.parametrize("capacity", [None, 12, 1],
                         ids=["dense", "capacity12", "capacity1"])
def test_moe_over_ep2_matches_jax(pool, capacity):
    """The output, the load and the gradients of sum(y * c) in every
    parameter and in x within 2e-5 of the JAX package's on both ranks.
    At capacity 12 nothing is dropped and the sparse output equals the
    dense one; at capacity 1 the dropped rows are exactly 0 and the kept
    rows equal the dense output."""
    x, params, cot = _case(1)
    want = _jax(x, params, capacity, cot)
    dense = _jax(x, params, None, cot)[0].reshape(-1, D)
    for y, load, grads in pool.run(jobs.moe_sharded, x, params, capacity,
                                   cot):
        np.testing.assert_allclose(y, want[0], atol=2e-5, rtol=0)
        assert load == pytest.approx(want[1], abs=1e-6)
        assert 0.0 < load <= 1.0
        for k in want[2]:
            np.testing.assert_allclose(grads[k], want[2][k], atol=2e-5,
                                       rtol=0, err_msg=k)
        rows = y.reshape(-1, D)
        if capacity == 12:
            np.testing.assert_allclose(rows, dense, atol=2e-5, rtol=0)
        if capacity == 1:
            zero = np.all(rows == 0.0, axis=-1)
            assert zero.any() and not zero.all()
            np.testing.assert_allclose(rows[~zero], dense[~zero],
                                       atol=2e-5, rtol=0)


def test_single_device_dense_matches_jax():
    """No ep axis: the dense evaluation with the same routing."""
    import jax.numpy as jnp
    import torch
    from paddle_tpu.core.registry import REGISTRY as JR
    from paddle_tpu_torch.core.registry import REGISTRY as TR
    x, params, _ = _case(2)
    slots = {"GateW": "gate_w", "W1": "w1", "B1": "b1", "W2": "w2",
             "B2": "b2"}

    class Ctx:
        mesh = None
    jins = {"X": [jnp.asarray(x)]}
    tins = {"X": [torch.tensor(x)]}
    for s, k in slots.items():
        jins[s] = [jnp.asarray(params[k])]
        tins[s] = [torch.tensor(params[k])]
    want = JR.get("moe_ffn").lower(Ctx(), jins, {"ep_axis": "ep"})
    got = TR.get("moe_ffn").lower(None, tins, {"ep_axis": "ep"})
    np.testing.assert_allclose(got["Out"][0].numpy(),
                               np.asarray(want["Out"][0]), atol=2e-5)
    assert float(got["Load"][0]) == pytest.approx(
        float(want["Load"][0]), abs=1e-6)


def _jax_program(capacity=None, steps=25, mesh_axes=None):
    main, startup, loss, load = jobs.moe_program(fj, capacity)
    scope = fj.Scope()
    with fj.scope_guard(scope):
        exe = fj.Executor()
        exe.run(startup)
        init = {v.name: np.asarray(scope.get_numpy(v.name))
                for v in main.list_vars() if v.persistable
                and scope.find_var(v.name) is not None}
        prog = main
        if mesh_axes:
            import jax
            from jax.sharding import Mesh
            mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2),
                        mesh_axes)
            prog = fj.CompiledProgram(main).with_distributed(
                mesh, batch_axes=())
        out = [exe.run(prog, feed=jobs.moe_feeds(),
                       fetch_list=[loss, load]) for _ in range(steps)]
    return init, [float(o[0]) for o in out], [float(o[1]) for o in out]


def test_moe_layer_trains_in_static_graph():
    """tests/test_parallel.py:474 on one rank: 25 Adam steps' losses and
    loads within 1e-4 of the JAX package's, the loss down by 20%."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    init, want, want_load = _jax_program()
    main, startup, loss, load = jobs.moe_program(ptt)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(startup, scope=scope)
    scope_from_numpy(init, scope, ptt.CPUPlace(), program=main)
    out = [exe.run(main, feed=jobs.moe_feeds(), fetch_list=[loss, load],
                   scope=scope) for _ in range(25)]
    np.testing.assert_allclose([float(o[0]) for o in out], want,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose([float(o[1]) for o in out], want_load,
                               rtol=1e-4)
    assert want[-1] < want[0] * 0.8


@pytest.mark.parametrize("capacity", [None, 24], ids=["dense", "sparse"])
def test_moe_program_over_ep2_matches_jax(pool, capacity):
    """The same program over a mesh ep2: each rank holds 2 of the 4
    experts (gate whole), and 6 Adam steps' losses and loads equal the
    JAX package's ep2 run within 1e-4."""
    init, want, want_load = _jax_program(capacity, steps=6,
                                         mesh_axes=("ep",))
    for losses, loads, shapes in pool.run(jobs.moe_train, init, 6,
                                          capacity):
        np.testing.assert_allclose(losses, want, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(loads, want_load, rtol=1e-4)
        w1 = [s for n, s in shapes.items() if n.endswith(".w1")]
        gate = [s for n, s in shapes.items() if n.endswith(".gate_w")]
        assert w1 == [(2, 16, 32)] and gate == [(16, 4)]


@pytest.mark.parametrize("kind", ["moe_dense", "moe_sparse"])
def test_priced_collectives_are_the_moved_bytes(pool, kind):
    """The MoE program over ep2, dense and at capacity 12: the sharding
    gate's price of the rank program (f's gradient all-reduces, the sum
    over ep or the dispatch and combine all-to-alls) equals, to the
    byte, what the rank's collectives moved in its second step."""
    for moved, priced, kinds in pool.run(jobs.priced_and_moved, kind):
        assert priced == moved, kinds
