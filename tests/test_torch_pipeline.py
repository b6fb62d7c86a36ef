"""Pipeline parallelism (paddle_tpu_torch/parallel/pipeline.py) against
the JAX package's (paddle_tpu/parallel/pipeline.py), and the executor on
a mesh with a `pp` axis against the JAX CompiledProgram.

The JAX package runs GPipe as one SPMD program over its 8-device CPU
mesh; the port runs one gloo rank a stage (tests/torch_parallel_jobs.py
holds the rank jobs). Both start from the same numpy weights and
inputs. Tolerances: float32 throughout, 2e-5 on outputs and losses,
1e-4 relative on gradients and updated parameters (the sums run in
another order). Deliberate differences, each held below:

- a rank skips the bubble ticks: it calls stage_fn n_micro times a
  step where the JAX scan calls it n_micro + n_stages - 1 times;
- a rank holds the gradient of its own stage's slice of the stacked
  parameters (the other slices read zero);
- the executor runs the ranks along `pp` as replicas of their batch
  coordinate, as GSPMD replicates the program over an axis nothing
  names, and syncs gradients over the batch axis only.
"""
import os

import numpy as np
import pytest

import paddle_tpu as fj
import torch_parallel_jobs as jobs
from torch_parallel_pool import make_pool_fixture

pool = make_pool_fixture()

RTOL = 1e-4


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    from paddle_tpu_torch.distributed.spawn import RankPool
    store = os.path.join(str(tmp_path_factory.mktemp("ranks4")), "store")
    p = RankPool(4, store, backend="gloo", timeout_s=60.0,
                 env={"OMP_NUM_THREADS": "1"})
    yield p
    p.close()


def _stage_params(seed, n_stages, d):
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(d, d) / 4).astype(np.float32),
             "b": (rng.randn(d) / 10).astype(np.float32)}
            for _ in range(n_stages)]


def _jax_gpipe(params, x, n_micro, n_stages, grad=True):
    """(output, loss mean(out ** 2), its gradients, x's gradient) of the
    JAX gpipe of the same stage over a pp mesh of n_stages devices
    (jitted: eager shard_map dispatch takes seconds an op)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.parallel import gpipe, stack_stage_params
    from paddle_tpu.parallel.mesh import make_mesh
    mesh = make_mesh((n_stages,), ("pp",), devices=jax.devices()[:n_stages])
    stacked = stack_stage_params([{k: jnp.asarray(v) for k, v in p.items()}
                                  for p in params])

    def stage(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def run(sp, xx):
        return gpipe(stage, sp, xx, n_microbatches=n_micro, mesh=mesh,
                     axis="pp")

    out = jax.jit(run)(stacked, jnp.asarray(x))
    if not grad:
        return np.asarray(out), None, None, None
    loss, (g, gx) = jax.jit(jax.value_and_grad(
        lambda sp, xx: jnp.mean(run(sp, xx) ** 2), argnums=(0, 1)))(
        stacked, jnp.asarray(x))
    return (np.asarray(out), float(loss),
            {k: np.asarray(v) for k, v in g.items()}, np.asarray(gx))


def test_gpipe_matches_jax_forward_and_backward(pool):
    """pp=2 over two gloo ranks, 4 microbatches of 2: every rank's
    output equals the JAX gpipe's (2e-5), the loss too, each rank's
    slice of the stacked gradients equals the JAX gradient's slice of
    that stage (1e-4 relative), and x's gradient, broadcast from stage
    0, is the JAX one on both ranks."""
    params = _stage_params(1, 2, 16)
    x = np.random.RandomState(2).randn(8, 16).astype(np.float32)
    j_out, j_loss, j_grad, j_gx = _jax_gpipe(params, x, 4, 2)
    for out, loss, grad, gx, calls, s in pool.run(
            jobs.gpipe_run, params, x, 4, (2,), ("pp",), True):
        np.testing.assert_allclose(out, j_out, rtol=2e-5, atol=2e-5)
        assert abs(loss - j_loss) <= 2e-5 * abs(j_loss)
        for k in j_grad:
            np.testing.assert_allclose(grad[k][s], j_grad[k][s],
                                       rtol=RTOL, atol=1e-6, err_msg=k)
            assert not grad[k][1 - s].any(), k
        np.testing.assert_allclose(gx, j_gx, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("n_micro", [1, 3])
def test_bubble_ticks_are_skipped(pool, n_micro):
    """A deliberate difference: each rank calls stage_fn n_micro times
    a step (the JAX scan runs n_micro + n_stages - 1 ticks on every
    stage), and the output still equals the JAX gpipe's."""
    params = _stage_params(3, 2, 8)
    x = np.random.RandomState(4).randn(6 if n_micro == 3 else 4, 8) \
        .astype(np.float32)
    j_out = _jax_gpipe(params, x, n_micro, 2, grad=False)[0]
    for out, _, _, _, calls, _ in pool.run(jobs.gpipe_run, params, x,
                                           n_micro, (2,), ("pp",)):
        assert calls == n_micro
        np.testing.assert_allclose(out, j_out, rtol=2e-5, atol=2e-5)


def test_gpipe_raises_as_the_jax_package_does():
    """No `pp` axis on the mesh, and a batch the microbatches do not
    divide: the ValueErrors of the JAX gpipe (pipeline.py:55-61)."""
    import torch
    from paddle_tpu_torch.parallel import gpipe, stack_stage_params
    from paddle_tpu_torch.parallel.mesh import make_mesh
    stacked = stack_stage_params(_stage_params(0, 1, 4))
    with pytest.raises(ValueError, match="no axis 'pp'"):
        gpipe(jobs.tanh_stage, stacked, torch.zeros(4, 4),
              n_microbatches=2, mesh=make_mesh((1,), ("dp",)))
    with pytest.raises(ValueError, match="n_microbatches"):
        gpipe(jobs.tanh_stage, stacked, torch.zeros(5, 4),
              n_microbatches=2, mesh=make_mesh((1,), ("pp",)))


def test_gpipe_in_one_process_runs_the_stages_in_sequence():
    """With no process group a pp=4 mesh's stages run one after another
    in this process: output and gradients equal the JAX gpipe over four
    devices."""
    import torch
    from paddle_tpu_torch.parallel import gpipe, stack_stage_params
    from paddle_tpu_torch.parallel.mesh import Mesh
    params = _stage_params(5, 4, 8)
    x = np.random.RandomState(6).randn(8, 8).astype(np.float32)
    j_out, j_loss, j_grad, _ = _jax_gpipe(params, x, 4, 4)
    stacked = {k: v.requires_grad_() for k, v in
               stack_stage_params(params).items()}
    out = gpipe(jobs.tanh_stage, stacked, torch.as_tensor(x),
                n_microbatches=4, mesh=Mesh(np.arange(4), ("pp",)))
    (out ** 2).mean().backward()
    np.testing.assert_allclose(out.detach().numpy(), j_out, rtol=2e-5,
                               atol=2e-5)
    for k in j_grad:
        np.testing.assert_allclose(stacked[k].grad.numpy(), j_grad[k],
                                   rtol=RTOL, atol=1e-6, err_msg=k)


def test_stack_stage_params_takes_tensors_and_arrays():
    import torch
    from paddle_tpu_torch.parallel import stack_stage_params
    got = stack_stage_params([{"w": np.ones((2, 3), np.float32)},
                              {"w": torch.zeros(2, 3)}])
    assert tuple(got["w"].shape) == (2, 2, 3)
    assert got["w"][0].sum() == 6 and got["w"][1].sum() == 0


def _jax_3axis(params, x, y, lr=0.1):
    """__graft_entry__._dryrun_3axis's jitted step on a dp1 x tp2 x pp2
    mesh of four CPU devices: (loss, updated stacked parameters)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P
    from paddle_tpu.parallel import gpipe, stack_stage_params
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 2, 2),
                axis_names=("dp", "tp", "pp"))
    stacked = stack_stage_params([{k: jnp.asarray(v) for k, v in p.items()}
                                  for p in params])
    place = {"w1": P("pp", None, "tp"), "b1": P("pp", "tp"),
             "w2": P("pp", "tp", None), "b2": P("pp", None)}
    stacked = {k: jax.device_put(v, NamedSharding(mesh, place[k]))
               for k, v in stacked.items()}
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("dp", None)))
    ys = jax.device_put(jnp.asarray(y), NamedSharding(mesh, P("dp", None)))

    def stage(p, h):
        hh = jax.nn.gelu(h @ p["w1"] + p["b1"])
        return jnp.tanh(hh @ p["w2"] + p["b2"])

    def loss_fn(sp):
        out = gpipe(stage, sp, xs, n_microbatches=2, mesh=mesh, axis="pp")
        return jnp.mean((out - ys) ** 2)

    @jax.jit
    def step(sp):
        loss, g = jax.value_and_grad(loss_fn)(sp)
        return loss, jax.tree.map(lambda p, gg: p - lr * gg, sp, g)

    loss, new = step(stacked)
    return float(loss), {k: np.asarray(v) for k, v in new.items()}


def test_dp1_tp2_pp2_matches_the_jax_3axis_step(pool4):
    """The 3-axis composition at four ranks: GPipe over pp with the
    stage's w1/w2 split over tp (its f/g collectives over the tp group,
    the pipeline's sends over the pp group). Every rank's loss equals
    the JAX step's (2e-5), and its updated shard equals the JAX update's
    block of that stage and tp rank (1e-4 relative)."""
    rng = np.random.RandomState(3)
    d, f, batch = 16, 32, 4
    params = [{"w1": (rng.randn(d, f) / 4).astype(np.float32),
               "b1": np.zeros((f,), np.float32),
               "w2": (rng.randn(f, d) / 4).astype(np.float32),
               "b2": np.zeros((d,), np.float32)} for _ in range(2)]
    x = rng.randn(batch, d).astype(np.float32)
    y = rng.randn(batch, d).astype(np.float32)
    j_loss, j_new = _jax_3axis(params, x, y)
    seen = set()
    for loss, new, (t, s) in pool4.run(jobs.gpipe_3axis, params, x, y):
        seen.add((t, s))
        assert abs(loss - j_loss) <= 2e-5 * abs(j_loss)
        cols = slice(t * f // 2, (t + 1) * f // 2)
        want = {"w1": j_new["w1"][s][:, cols], "b1": j_new["b1"][s][cols],
                "w2": j_new["w2"][s][cols], "b2": j_new["b2"][s]}
        for k in want:
            np.testing.assert_allclose(new[k], want[k], rtol=RTOL,
                                       atol=1e-6, err_msg=k)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_section_pipeline_matches_jax():
    """SectionPipeline.forward and .grad (4 microbatches over two
    sections) against the JAX SectionPipeline on the same weights: the
    output within 2e-5, the mean loss within 1e-5 relative, each
    gradient within 1e-4 relative; both equal one gradient over the
    whole batch."""
    import jax.numpy as jnp
    import torch
    from paddle_tpu.parallel import SectionPipeline as JPipe
    from paddle_tpu_torch.parallel import SectionPipeline
    rng = np.random.RandomState(2)
    d = 8
    p1 = {"w": rng.randn(d, d).astype(np.float32)}
    p2 = {"w": rng.randn(d, 1).astype(np.float32)}
    x = rng.randn(16, d).astype(np.float32)
    y = rng.randn(16, 1).astype(np.float32)
    j = JPipe([lambda p, h: jnp.tanh(h @ p["w"]), lambda p, h: h @ p["w"]],
              n_microbatches=4)
    t = SectionPipeline([lambda p, h: torch.tanh(h @ p["w"]),
                         lambda p, h: h @ p["w"]], n_microbatches=4)
    jp = [{k: jnp.asarray(v) for k, v in p.items()} for p in (p1, p2)]
    tp = [{k: torch.as_tensor(v) for k, v in p.items()} for p in (p1, p2)]
    np.testing.assert_allclose(
        t.forward(tp, torch.as_tensor(x)).numpy(),
        np.asarray(j.forward(jp, jnp.asarray(x))), rtol=2e-5, atol=2e-5)
    j_loss, j_g = j.grad(lambda a, b: jnp.mean((a - b) ** 2), jp,
                         jnp.asarray(x), jnp.asarray(y))
    loss, g = t.grad(lambda a, b: ((a - b) ** 2).mean(), tp,
                     torch.as_tensor(x), torch.as_tensor(y))
    assert abs(float(loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    for gi, ji in zip(g, j_g):
        np.testing.assert_allclose(gi["w"].numpy(), np.asarray(ji["w"]),
                                   rtol=RTOL, atol=1e-5)
    with pytest.raises(ValueError, match="n_microbatches"):
        t.forward(tp, torch.zeros(5, d))


def _jax_mlp_on(xs, ys, shape, steps=5):
    """The MLP's `steps` SGD steps through the JAX CompiledProgram's
    with_distributed on a ("dp", "pp") mesh of `shape` CPU devices."""
    import jax
    from jax.sharding import Mesh
    main, startup, loss, _, _ = jobs.mlp(fj)
    scope = fj.Scope()
    with fj.scope_guard(scope):
        exe = fj.Executor()
        exe.run(startup)
        init = {v.name: np.asarray(scope.get_numpy(v.name))
                for v in main.list_vars() if v.persistable
                and scope.find_var(v.name) is not None}
        mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))])
                    .reshape(shape), ("dp", "pp"))
        prog = fj.CompiledProgram(main).with_distributed(
            mesh, batch_axes=("dp",))
        losses = [float(np.asarray(exe.run(
            prog, feed={"x": xs, "y": ys}, fetch_list=[loss])[0]))
            for _ in range(steps)]
        state = {n: np.asarray(scope.get_numpy(n)) for n in init}
    return init, losses, state


def _mlp_data(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(32, 16).astype(np.float32),
            rng.randn(32, 1).astype(np.float32))


def test_executor_pp_replicas_match_jax(pool):
    """The executor on a dp1 x pp2 mesh: both ranks run the program as
    replicas, 5 SGD steps equal to the JAX CompiledProgram on the same
    mesh (1e-4); no gradient is synced and the gate prices no bytes."""
    xs, ys = _mlp_data(5)
    init, j_losses, j_state = _jax_mlp_on(xs, ys, (1, 2))
    for losses, state, priced, synced in pool.run(
            jobs.mlp_pp_train, init, xs, ys, 5, (1, 2)):
        np.testing.assert_allclose(losses, j_losses, rtol=RTOL, atol=1e-6)
        for n in j_state:
            np.testing.assert_allclose(state[n], j_state[n], rtol=RTOL,
                                       atol=1e-6, err_msg=n)
        assert not priced and synced == 0


def test_executor_dp2_pp2_syncs_over_dp_only(pool4):
    """dp2 x pp2 at four ranks: the batch split over dp, the pp ranks
    replicas; 3 SGD steps equal to the JAX CompiledProgram on the same
    mesh, the gradients synced over dp only (each rank all-reduced the
    MLP's 577 gradient floats a step), and the sharding gate prices
    what a dp2 mesh without pp prices (the gradients' ring all-reduce
    and the loss's)."""
    from paddle_tpu_torch.analysis.sharding import analyze_program_sharding
    from paddle_tpu_torch.parallel.layout import MeshDims, SpecLayout
    import paddle_tpu_torch as ft
    xs, ys = _mlp_data(6)
    init, j_losses, j_state = _jax_mlp_on(xs, ys, (2, 2), steps=3)
    main = jobs.mlp(ft)[0]
    dp2 = analyze_program_sharding(
        main, SpecLayout(MeshDims((2,), ("dp",))).add_program(main),
        feed_shapes={"x": ((32, 16), "float32"),
                     "y": ((32, 1), "float32")}).collective_bytes_per_step
    assert dp2 >= 2 * 577 * 4
    for losses, state, priced, synced in pool4.run(
            jobs.mlp_pp_train, init, xs, ys, 3, (2, 2)):
        np.testing.assert_allclose(losses, j_losses, rtol=RTOL, atol=1e-6)
        for n in j_state:
            np.testing.assert_allclose(state[n], j_state[n], rtol=RTOL,
                                       atol=1e-6, err_msg=n)
        assert priced == dp2 and synced == 3 * 577 * 4


def test_pp_train_controls_fail_their_bars(pool, tmp_path):
    """chip_smoke's [pp_train] at toy size on the CPU (BERT encoder
    layers d 64, 4 layers, T 32, batch 8, 4 microbatches, float32): the
    two-rank pipeline within PP_BARS of the one-process run, calling its
    stage 4 times a step; each control fails its bar: the replication's
    backward summed over pp (the gradient gap reads 1.0) and stage 0
    fed microbatch t-1 (the loss gap)."""
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as c
    spec = {"place": "cpu", "amp": False, "steps": 2, "pipe": False,
            "control": None, "d": 64, "heads": 2, "ff": 128, "layers": 4,
            "batch": 8, "T": 32}
    ref = str(tmp_path / "one.npz")
    one = c.pp_train_run({**spec, "out": ref})
    for res in pool.run(c.pp_train_run, {**spec, "pipe": True,
                                         "ref": ref}):
        loss, grad = c.pp_gaps(res, one)
        assert loss <= c.PP_BARS["loss"] and grad <= c.PP_BARS["grad"]
        assert res["stage_calls_step"] == 4
    for kind, bar in c.PP_CONTROLS.items():
        res = pool.run(c.pp_train_run, {**spec, "pipe": True, "steps": 1,
                                        "control": kind, "ref": ref})
        gaps = [dict(zip(("loss", "grad"), c.pp_gaps(r, one)))
                for r in res]
        assert max(g[bar] for g in gaps) > c.PP_BARS[bar], (kind, gaps)
        if kind == "replica_bwd_summed":
            assert all(abs(g["grad"] - 1.0) < 1e-3 for g in gaps)
