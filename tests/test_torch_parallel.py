"""Data parallelism and the sharded executor at two ranks over gloo,
against the JAX package's single-device and data-parallel runs
(tests/test_parallel.py, tests/test_zero_sharding.py).

The JAX package runs one process over its 8-device CPU mesh and GSPMD
inserts the collectives; the port runs one process per rank (two here,
each a spawned process in one gloo group) and issues them itself. Both
are fed the global batch: each port rank keeps its rows. Deliberate
differences, each held below:

- one process per rank, the global batch fed on every rank
  (test_each_rank_keeps_its_rows_and_fetches_the_global_batch);
- a scalar fetch other than the loss is the rank's own value (the same
  test): the JAX package returns the global one;
- batch_norm normalises by the global batch's moments, all-reduced, as
  GSPMD does (test_batch_norm_uses_the_global_batch_statistics);
- a mesh with a tp axis runs the model-parallel rewrite's rank program
  (tests/test_torch_tensor_parallel.py holds it at full detail), and the
  ranks along a pipeline (pp) axis run the program as replicas
  (test_model_parallel_meshes_run_and_pp_and_unknown_batch_axes_raise;
  tests/test_torch_pipeline.py);
- on a single card two ranks run gloo, which stages CUDA tensors
  through host memory: tests/test_torch_cuda.py counts it on the card.
"""
import numpy as np
import pytest

import paddle_tpu as fj
import torch_parallel_jobs as jobs
from torch_parallel_pool import make_pool_fixture

pool = make_pool_fixture()

_jax_gpt = {}


def _jax_tiny_gpt(data_parallel):
    """(startup state, 5 losses, final parameters) of the JAX package's
    tiny GPT of tests/test_zero_sharding.py, single-device or through
    with_data_parallel on its 8-device mesh."""
    if data_parallel in _jax_gpt:
        return _jax_gpt[data_parallel]
    scope = fj.Scope()
    with fj.scope_guard(scope):
        main, startup, loss, cfg = jobs.tiny_gpt(fj)
        exe = fj.Executor()
        exe.run(startup)
        init = {v.name: np.asarray(scope.get_numpy(v.name))
                for v in main.list_vars() if v.persistable
                and scope.find_var(v.name) is not None}
        prog = fj.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name) if data_parallel else main
        losses = [float(np.asarray(exe.run(
            prog, feed={"tokens": _tokens()}, fetch_list=[loss])[0]))
            for _ in range(5)]
        params = {v.name: np.asarray(scope.get_numpy(v.name))
                  for v in main.list_vars()
                  if getattr(v, "is_parameter", False)}
    _jax_gpt[data_parallel] = (init, losses, params)
    return _jax_gpt[data_parallel]


def _tokens():
    return np.random.RandomState(0).randint(
        0, 64, (jobs.BATCH, jobs.SEQ)).astype(np.int64)


@pytest.mark.parametrize("mesh_spec,second_fetch_at", [
    (None, None), ("2", None), ("2", 2)],
    ids=["replicated", "zero", "zero_second_fetch_list"])
def test_tiny_gpt_matches_jax_at_two_ranks(pool, mesh_spec,
                                           second_fetch_at):
    """5 AdamW steps: losses and final parameters within 1e-4 of the JAX
    package's single-device run and of its with_data_parallel run; 2
    cache misses (startup, step) and 4 hits a rank; under ZeRO
    (FLAGS_sharded_exec over mesh '2') each rank holds half of each
    moment whose dim 0 divides, the rest whole. With a parameter fetched
    beside the loss at step 3 (a second cache entry on the same scope,
    3 misses), rank 0's rows of the sharded moments must not be
    broadcast over rank 1's."""
    init, _, _ = _jax_tiny_gpt(False)
    got = pool.run(jobs.gpt_train, init, _tokens(), 5, mesh_spec,
                   second_fetch_at)
    for dp in (False, True):
        _, losses, params = _jax_tiny_gpt(dp)
        for r_losses, r_params, _, _ in got:
            np.testing.assert_allclose(r_losses, losses, rtol=1e-4,
                                       atol=1e-5)
            assert r_params.keys() == params.keys()
            for n in params:
                np.testing.assert_allclose(r_params[n], params[n],
                                           rtol=1e-4, atol=1e-4,
                                           err_msg=n)
    full = {n: v.shape for n, v in init.items() if "_moment" in n}
    for _, _, stats, accs in got:
        entries = 2 if second_fetch_at is None else 3
        assert stats == {"hits": 6 - entries, "misses": entries,
                         "size": entries}
        assert accs.keys() == full.keys()
        for n, shape in full.items():
            want = shape if mesh_spec is None or shape[0] % 2 else \
                (shape[0] // 2, *shape[1:])
            assert accs[n] == want, n


def test_mlp_data_parallel_matches_jax(pool):
    """tests/test_parallel.py's MLP under with_data_parallel: 5 SGD
    steps equal the JAX package's data-parallel run (rtol 1e-4)."""
    rng = np.random.RandomState(0)
    xs = rng.randn(32, 16).astype(np.float32)
    ys = rng.randn(32, 1).astype(np.float32)
    init, j_losses, j_state = _jax_mlp(xs, ys, data_parallel=True)
    for losses, _, _, state in pool.run(jobs.mlp_train, init, xs, ys, 5):
        np.testing.assert_allclose(losses, j_losses, rtol=1e-4, atol=1e-5)
        for n in j_state:
            np.testing.assert_allclose(state[n], j_state[n], rtol=1e-4,
                                       atol=1e-5, err_msg=n)
    assert pool.run(jobs.parallel_executor, init, xs, ys, 5)[0] == \
        pytest.approx(j_losses, rel=1e-4)


def test_each_rank_keeps_its_rows_and_fetches_the_global_batch(pool):
    """Every rank is fed the global batch of 32 and runs 16 rows; the
    prediction (a batch-dim fetch) comes back all-gathered, equal to the
    JAX package's global fetch; the loss is averaged; reduce_sum(pred),
    a scalar that is not the loss, is the rank's own 16 rows' sum."""
    rng = np.random.RandomState(1)
    xs = rng.randn(32, 16).astype(np.float32)
    ys = rng.randn(32, 1).astype(np.float32)
    main, startup, loss, pred, total = jobs.mlp(fj)
    scope = fj.Scope()
    with fj.scope_guard(scope):
        exe = fj.Executor()
        exe.run(startup)
        init = {v.name: np.asarray(scope.get_numpy(v.name))
                for v in main.list_vars() if v.persistable
                and scope.find_var(v.name) is not None}
        prog = fj.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        j_loss, j_pred, j_total = [np.asarray(a) for a in exe.run(
            prog, feed={"x": xs, "y": ys},
            fetch_list=[loss, pred, total])]
    got = pool.run(jobs.mlp_train, init, xs, ys, 1)
    for r, (losses, pred_r, total_r, _) in enumerate(got):
        np.testing.assert_allclose(losses[0], j_loss, rtol=1e-5)
        assert pred_r.shape == (32, 1)
        np.testing.assert_allclose(pred_r, j_pred, rtol=1e-5, atol=1e-6)
        own = float(j_pred[r * 16:(r + 1) * 16].sum())
        assert total_r == pytest.approx(own, rel=1e-4, abs=1e-5)
    assert float(j_total) == pytest.approx(
        got[0][2] + got[1][2], rel=1e-4, abs=1e-5)


def test_batch_norm_uses_the_global_batch_statistics(pool):
    """With a batch_norm after the hidden layer, the two ranks' 5 steps
    equal the JAX package's data-parallel run on the global batch: the
    moments are all-reduced, as GSPMD computes them."""
    rng = np.random.RandomState(2)
    xs = (rng.randn(32, 16) * np.linspace(0.5, 2, 32)[:, None]
          ).astype(np.float32)
    ys = rng.randn(32, 1).astype(np.float32)
    init, j_losses, j_state = _jax_mlp(xs, ys, bn=True, data_parallel=True)
    for losses, _, _, state in pool.run(jobs.mlp_train, init, xs, ys, 5,
                                        True):
        np.testing.assert_allclose(losses, j_losses, rtol=1e-4, atol=1e-5)
        for n in j_state:
            np.testing.assert_allclose(state[n], j_state[n], rtol=1e-4,
                                       atol=1e-5, err_msg=n)


def test_model_parallel_meshes_run_and_pp_and_unknown_batch_axes_raise(
        pool):
    """A batch axis the mesh lacks raises ValueError naming batch_axes
    (tests/test_parallel.py:98); a tp axis of two ranks runs, its 5 SGD
    steps equal to the JAX package's single-device run (rtol 1e-4); a
    pipeline (pp) axis of two ranks runs too, its ranks replicas of the
    one batch coordinate, with the same 5 steps
    (tests/test_torch_pipeline.py holds it against the JAX
    CompiledProgram on that mesh)."""
    for name, msg in pool.run(jobs.refused, "batch_axes"):
        assert name == "ValueError" and "batch_axes" in msg
    rng = np.random.RandomState(0)
    xs = rng.randn(32, 16).astype(np.float32)
    ys = rng.randn(32, 1).astype(np.float32)
    init, j_losses, j_state = _jax_mlp(xs, ys)
    got = pool.run(jobs.mlp_tp_train, init, xs, ys, 5) + [
        r[:2] for r in pool.run(jobs.mlp_pp_train, init, xs, ys, 5,
                                (1, 2))]
    for losses, state in got:
        np.testing.assert_allclose(losses, j_losses, rtol=1e-4, atol=1e-5)
        for n in j_state:
            np.testing.assert_allclose(state[n], j_state[n], rtol=1e-4,
                                       atol=1e-5, err_msg=n)


@pytest.mark.parametrize("mesh_spec", ["1,2", "1,1,2"],
                         ids=["tp2", "fsdp2"])
def test_parallel_executor_on_a_model_parallel_mesh(pool, mesh_spec):
    """ParallelExecutor(mesh=...) with a tp or an fsdp axis runs the
    model-parallel rewrite: 5 SGD steps of the MLP equal the JAX
    package's single-device run (rtol 1e-4), the state gathered whole
    too."""
    rng = np.random.RandomState(4)
    xs = rng.randn(32, 16).astype(np.float32)
    ys = rng.randn(32, 1).astype(np.float32)
    init, j_losses, j_state = _jax_mlp(xs, ys)
    for losses, state in pool.run(jobs.parallel_executor_mp, init, xs, ys,
                                  5, mesh_spec):
        np.testing.assert_allclose(losses, j_losses, rtol=1e-4, atol=1e-5)
        for n in j_state:
            np.testing.assert_allclose(state[n], j_state[n], rtol=1e-4,
                                       atol=1e-5, err_msg=n)


def test_data_parallel_dygraph_at_two_ranks(pool):
    """Eager DataParallel: each rank runs its 16 rows, and
    apply_collective_grads averages the gradients, so 3 SGD steps give
    both ranks the JAX package's one-process Linear on all 32 rows."""
    rng = np.random.RandomState(3)
    xs = rng.randn(32, 16).astype(np.float32)
    ys = rng.randn(32, 1).astype(np.float32)
    w = (rng.randn(16, 1) * 0.1).astype(np.float32)
    b = np.zeros((1,), np.float32)
    import paddle_tpu.dygraph as jdg
    with jdg.guard():
        lin = jdg.Linear(16, 1)
        lin.weight.set_value(w)
        lin.bias.set_value(b)
        opt = fj.optimizer.SGD(learning_rate=0.1)
        for _ in range(3):
            loss = fj.layers.mean(fj.layers.square_error_cost(
                lin(jdg.to_variable(xs)), jdg.to_variable(ys)))
            loss.backward()
            opt.minimize(loss, parameter_list=lin.parameters())
            lin.clear_gradients()
        jw, jb = lin.weight.numpy(), lin.bias.numpy()
    for _, tw, tb in pool.run(jobs.dygraph_dp, w, b, xs, ys, 3):
        np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-6)


def _jax_mlp(xs, ys, bn=False, data_parallel=False, steps=5):
    main, startup, loss, _, _ = jobs.mlp(fj, bn)
    scope = fj.Scope()
    with fj.scope_guard(scope):
        exe = fj.Executor()
        exe.run(startup)
        init = {v.name: np.asarray(scope.get_numpy(v.name))
                for v in main.list_vars() if v.persistable
                and scope.find_var(v.name) is not None}
        prog = fj.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name) if data_parallel else main
        losses = [float(np.asarray(exe.run(
            prog, feed={"x": xs, "y": ys}, fetch_list=[loss])[0]))
            for _ in range(steps)]
        state = {n: np.asarray(scope.get_numpy(n)) for n in init}
    return init, losses, state
