"""The port's collective ops, layers and transpilers against the JAX
package's.

- Every one of the 15 collective op types the JAX package registers
  (ops/collective.py) is registered in the port.
- Two ranks over gloo (one process each, the reference's model) run each
  c_* op in a program, and differentiate sum(out * c) through it: the
  outputs and the input gradients equal what numpy computes on the host
  from both ranks' inputs (all-reduce is its own transpose, all-gather
  and reduce-scatter each other's, broadcast sums onto its root,
  all-to-all is undone by the swapped one). At one rank each op is the
  identity, as in the JAX package's GSPMD mode.
- The regression of tests/test_parallel.py: a collective does not sever
  the gradient.
- GradAllReduce and LocalSGD emit the JAX package's ops in the same
  places; at two ranks the GradAllReduce-rewritten program, each rank
  feeding its own rows, equals the JAX package's one-process run on the
  global batch.
- shard_hint runs only over the data axis on dim 0; the bootstrap ops do
  nothing; the launcher's parameter-server mode waits for ROADMAP §A8e.
"""
import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
import torch_parallel_jobs as jobs
from torch_parallel_pool import make_pool_fixture

pool = make_pool_fixture()

OP_TYPES = ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
            "c_allreduce_prod", "allreduce", "c_allgather",
            "c_reducescatter", "c_broadcast", "c_alltoall",
            "c_sync_calc_stream", "c_sync_comm_stream", "c_comm_init",
            "c_comm_init_all", "c_gen_nccl_id", "shard_hint")


def test_all_15_collective_op_types_are_registered():
    from paddle_tpu.core.registry import REGISTRY as JR
    from paddle_tpu_torch.core.registry import REGISTRY as TR
    for t in OP_TYPES:
        assert JR.has(t) and TR.has(t), t
        assert TR.get(t).inplace == JR.get(t).inplace


def _expected(op_type, attrs, xs, cs):
    """(out, d sum(out * c) / dx) of each rank, on the host."""
    n = len(xs)
    sc = sum(cs)
    if op_type in ("c_allreduce_sum", "allreduce"):
        out = sum(xs)
        return [(out, sc) for _ in xs]
    if op_type in ("c_allreduce_max", "c_allreduce_min"):
        out = (np.maximum if op_type.endswith("max") else np.minimum)(*xs)
        return [(out, sc * (x == out)) for x in xs]
    if op_type == "c_allreduce_prod":
        out = np.prod(xs, axis=0)
        return [(out, sc * out / x) for x in xs]
    if op_type == "c_allgather":
        out = np.concatenate(xs)
        rows = len(xs[0])
        return [(out, sc[r * rows:(r + 1) * rows]) for r in range(n)]
    if op_type == "c_reducescatter":
        total = sum(xs)
        rows = len(total) // n
        return [(total[r * rows:(r + 1) * rows], np.concatenate(cs))
                for r in range(n)]
    if op_type == "c_broadcast":
        root = attrs["root"]
        return [(xs[root], sc if r == root else np.zeros_like(sc))
                for r in range(n)]
    if op_type == "c_alltoall":
        blocks = [np.split(x, n) for x in xs]
        cblocks = [np.split(c, n) for c in cs]
        return [(np.concatenate([blocks[s][r] for s in range(n)]),
                 np.concatenate([cblocks[s][r] for s in range(n)]))
                for r in range(n)]
    # the stream syncs and shard_hint: the identity
    return [(x, c) for x, c in zip(xs, cs)]


CASES = [("c_allreduce_sum", {}), ("c_allreduce_max", {}),
         ("c_allreduce_min", {}), ("c_allreduce_prod", {}),
         ("allreduce", {}), ("c_allgather", {}), ("c_reducescatter", {}),
         ("c_broadcast", {"root": 1}), ("c_alltoall", {}),
         ("c_sync_calc_stream", {}), ("c_sync_comm_stream", {}),
         ("shard_hint", {"spec": ["dp", None]})]


@pytest.mark.parametrize("op_type,attrs", CASES,
                         ids=[c[0] for c in CASES])
def test_collective_and_its_gradient_at_two_ranks(pool, op_type, attrs):
    rng = np.random.RandomState(len(op_type))
    xs = [rng.uniform(0.5, 2.0, (4, 3)).astype(np.float32)
          for _ in range(2)]
    if op_type in ("c_allreduce_max", "c_allreduce_min"):
        xs[1][0] = xs[0][0]  # a tie: both ranks hold the result
    cs = [rng.randn(*(8, 3) if op_type == "c_allgather" else
                    (2, 3) if op_type == "c_reducescatter" else (4, 3)
                    ).astype(np.float32) for _ in range(2)]
    got = pool.run(jobs.collective_op, op_type, attrs, xs, cs)
    for (out, grad), (e_out, e_grad) in zip(
            got, _expected(op_type, attrs, xs, cs)):
        np.testing.assert_allclose(out, e_out, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(grad, e_grad, rtol=1e-5, atol=1e-6)


def test_collectives_are_the_identity_at_one_rank():
    """No process group: every op returns its input, as in GSPMD mode."""
    xs = [np.arange(12, dtype=np.float32).reshape(4, 3) + 1]
    cs = [np.ones((4, 3), np.float32)]
    import torch.distributed as dist
    assert not dist.is_initialized()
    for op_type, attrs in CASES:
        out, grad = _rank0(op_type, attrs, xs, cs)
        np.testing.assert_array_equal(out, xs[0])
        np.testing.assert_array_equal(grad, cs[0])


def _rank0(op_type, attrs, xs, cs):
    import torch.distributed as dist
    real = dist.get_rank
    dist.get_rank = lambda *a: 0
    try:
        return jobs.collective_op(op_type, attrs, xs, cs)
    finally:
        dist.get_rank = real


def test_bootstrap_ops_and_the_shard_hint_rule(pool):
    """The bootstrap ops run and do nothing; a shard_hint naming an axis
    the mesh lacks raises (one on a mesh axis is the model-parallel
    rewrite's, tests/test_torch_tensor_parallel.py)."""
    msgs = pool.run(jobs.bootstrap_ops)
    assert all(m and "not an axis of the mesh" in m for m in msgs)


def test_collective_grad_flows():
    """tests/test_parallel.py's regression: the fc weight receives a
    gradient through the collective, in both packages."""
    for f in (fj, ft):
        main, startup = f.Program(), f.Program()
        with f.program_guard(main, startup), f.unique_name.guard():
            x = f.layers.data("x", shape=[4], dtype="float32")
            h = f.layers.fc(x, size=4, bias_attr=False)
            loss = f.layers.mean(f.layers.c_allreduce_sum(h))
            pg = f.optimizer.SGD(0.1).backward(loss)
        assert len(pg) == 1


def _build(f, opt="sgd"):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data("x", shape=[8], dtype="float32")
        y = f.layers.data("y", shape=[1], dtype="float32")
        h = f.layers.fc(x, size=16, act="relu")
        pred = f.layers.fc(h, size=1)
        loss = f.layers.mean(f.layers.square_error_cost(pred, y))
        if opt == "sgd":
            f.optimizer.SGD(0.1).minimize(loss)
        else:
            f.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("kind", ["grad_allreduce", "local_sgd"])
def test_transpilers_emit_the_jax_programs(kind):
    """The same ops in the same places: both packages' rewritten main
    and startup programs are byte-equal."""
    from paddle_tpu import transpiler as jt
    from paddle_tpu_torch import transpiler as tt
    progs = {}
    for f, t in ((fj, jt), (ft, tt)):
        main, startup, _ = _build(f)
        with f.unique_name.guard():
            rw = t.GradAllReduce(nrings=2) if kind == "grad_allreduce" \
                else t.LocalSGD(k_steps=4)
            rw.transpile(startup, main, rank=0,
                         endpoints=["127.0.0.1:6170", "127.0.0.1:6171"],
                         current_endpoint="127.0.0.1:6170")
        progs[f] = (main.to_json(), startup.to_json())
    assert progs[ft] == progs[fj]
    main = _build(ft)[0]
    types = [op.type for op in main.global_block().ops]
    assert "c_allreduce_sum" not in types


def test_grad_allreduce_at_two_ranks_equals_the_global_batch(pool):
    """Each rank feeds its rows to the rewritten plain program; the
    inserted scale + c_allreduce_sum average the gradients, so 5 SGD
    steps equal the JAX package's one-process steps on the global batch
    (the loss fetched is each rank's own rows')."""
    rng = np.random.RandomState(0)
    xs = rng.randn(32, 16).astype(np.float32)
    ys = rng.randn(32, 1).astype(np.float32)
    init, j_losses, j_state = _jax_mlp(xs, ys, 5)
    got = pool.run(jobs.mlp_train, init, xs, ys, 5, False, True)
    for _, _, _, state in got:
        for n in j_state:
            np.testing.assert_allclose(state[n], j_state[n], rtol=1e-5,
                                       atol=1e-6, err_msg=n)
    mean = np.mean([g[0] for g in got], axis=0)
    np.testing.assert_allclose(mean, j_losses, rtol=1e-5)


def _jax_mlp(xs, ys, steps, bn=False, data_parallel=False):
    """(startup state, losses, final state) of the JAX package's MLP."""
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


def test_launcher_and_env_at_one_rank(monkeypatch):
    from paddle_tpu_torch import distributed
    from paddle_tpu_torch.distributed import launch
    with pytest.raises(NotImplementedError, match="§A8e"):
        launch.launch(["--server_num", "1", "train.py"])
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "1")
    distributed.init_parallel_env()  # world 1: no group
    import torch.distributed as dist
    assert not dist.is_initialized()
    assert distributed.parallel_env_world_size() == 1
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(RuntimeError, match="gloo"):
        distributed.init_parallel_env()  # no card: no NCCL, no default
    mesh = distributed.global_mesh({"dp": -1})
    assert mesh.shape == {"dp": 1}


@pytest.mark.cuda
def test_gloo_stages_cuda_tensors_through_the_host(request):
    """On one card two ranks run gloo, which the port feeds host copies
    of CUDA tensors and counts (ops/collective.STAGED_BYTES): the
    all-reduce of a CUDA tensor of 12 float32 stages 48 bytes a rank and
    gives the host's sum."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got = request.getfixturevalue("pool").run(jobs.staged_all_reduce)
    for total, staged in got:
        np.testing.assert_allclose(total, np.arange(12.0) * 2 + 1)
        assert staged == 48
