"""Rank jobs of the two-rank port tests.

Run by paddle_tpu_torch.distributed.spawn.RankPool in spawned rank
processes, so this module imports the port and numpy only (never JAX or
the JAX package: the test modules that start the pool import both).
Each job runs on every rank with the same arguments and returns plain
numpy values.
"""
import numpy as np

BATCH, SEQ = 8, 16


def _flags(**kw):
    import paddle_tpu_torch as ptt
    ptt.set_flags({f"FLAGS_{k}": v for k, v in kw.items()})


def tiny_gpt(ptt, optimizer="adamw"):
    """tests/test_zero_sharding.py's tiny GPT, built by the package
    `ptt` (the port in the ranks)."""
    from importlib import import_module
    gpt = import_module(f"{ptt.__name__}.models.gpt")
    cfg = gpt.gpt_small(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                        d_ff=64, max_seq_len=SEQ, dropout=0.0,
                        attn_dropout=0.0, use_flash=False)
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        loss, _, _ = gpt.build_train(cfg, BATCH, SEQ, lr=1e-3)
    main.random_seed = 7
    startup.random_seed = 7
    return main, startup, loss, cfg


def gpt_train(init, toks, steps, mesh_spec=None, second_fetch_at=None):
    """`steps` data-parallel AdamW steps of the tiny GPT from `init` (the
    JAX startup's arrays) on the global batch `toks`; ZeRO-sharded over
    FLAGS_sharded_mesh=`mesh_spec` when given. Step `second_fetch_at`
    also fetches the first parameter, so that it runs a second cache
    entry of the program on the same scope. Returns (losses, final
    parameters, cache stats, {accumulator: this rank's shape})."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    _flags(sharded_exec=mesh_spec is not None,
           sharded_mesh=mesh_spec or "")
    try:
        main, startup, loss, _ = tiny_gpt(ptt)
        scope = ptt.Scope()
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(startup, scope=scope)
        scope_from_numpy(init, scope, ptt.CPUPlace(), program=main)
        prog = ptt.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name)
        first = main.all_parameters()[0]
        losses = [float(exe.run(prog, feed={"tokens": toks},
                                fetch_list=[loss] + (
                                    [first] if i == second_fetch_at
                                    else []), scope=scope)[0])
                  for i in range(steps)]
        params = {v.name: scope.get_numpy(v.name) for v in main.list_vars()
                  if getattr(v, "is_parameter", False)}
        accs = {n: tuple(scope.find_var(n).shape) for n in scope.names()
                if "_moment" in n}
        return losses, params, exe.cache_stats(), accs
    finally:
        _flags(sharded_exec=False, sharded_mesh="")


def _exe(ptt):
    return ptt.Executor(ptt.CPUPlace())


def collective_op(op_type, attrs, xs, cs):
    """Rank r runs `op_type` on xs[r] in a program and differentiates
    sum(out * cs[r]): returns (out, d/dx) of this rank."""
    import torch.distributed as dist
    import paddle_tpu_torch as ptt
    r = dist.get_rank()
    x, c = xs[r], cs[r]
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        xv = ptt.layers.data("x", shape=list(x.shape), dtype="float32",
                             append_batch_size=False)
        xv.stop_gradient = False
        out = main.global_block().create_var(
            name="out", shape=None, dtype="float32")
        main.global_block().append_op(
            op_type, inputs={"X": [xv.name]}, outputs={"Out": [out.name]},
            attrs=dict(attrs))
        cv = ptt.layers.data("c", shape=list(c.shape), dtype="float32",
                             append_batch_size=False)
        # the collective may change dim 0: no build-time shape inference
        blk = main.global_block()
        prod = blk.create_var(name="prod", shape=None, dtype="float32")
        loss = blk.create_var(name="loss", shape=None, dtype="float32")
        blk.append_op("elementwise_mul", inputs={"X": [out.name],
                                                  "Y": [cv.name]},
                      outputs={"Out": [prod.name]}, attrs={"axis": -1},
                      infer_shape=False)
        blk.append_op("reduce_sum", inputs={"X": [prod.name]},
                      outputs={"Out": [loss.name]},
                      attrs={"reduce_all": True, "dim": [0],
                             "keep_dim": False}, infer_shape=False)
        grad, = ptt.backward.gradients([loss], [xv])
    exe = _exe(ptt)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    got = exe.run(main, feed={"x": x, "c": c},
                  fetch_list=[out, grad], scope=scope)
    return [np.asarray(g) for g in got]


def bootstrap_ops():
    """c_comm_init, c_comm_init_all and c_gen_nccl_id run (and do
    nothing) in a startup program; the shard_hint spec rule."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops.collective import check_shard_hint
    startup = ptt.Program()
    blk = startup.global_block()
    for t in ("c_gen_nccl_id", "c_comm_init", "c_comm_init_all"):
        blk.append_op(t, inputs={}, outputs={}, attrs={"ring_id": 0},
                      infer_shape=False)
    _exe(ptt).run(startup, scope=ptt.Scope())
    check_shard_hint(["dp", None])
    try:
        check_shard_hint([None, "tp"])
    except NotImplementedError as e:
        return str(e)
    return None


def mlp(ptt, bn=False, opt="sgd"):
    """tests/test_parallel.py's MLP (with `bn`, a batch_norm after the
    hidden layer)."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data("x", shape=[16], dtype="float32")
        label = ptt.layers.data("y", shape=[1], dtype="float32")
        h = ptt.layers.fc(x, size=32, act="relu")
        if bn:
            h = ptt.layers.batch_norm(h)
        pred = ptt.layers.fc(h, size=1)
        loss = ptt.layers.mean(ptt.layers.square_error_cost(pred, label))
        total = ptt.layers.reduce_sum(pred)
        ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    main.random_seed = startup.random_seed = 7
    return main, startup, loss, pred, total


def mlp_train(init, xs, ys, steps, bn=False, transpile=False):
    """`steps` SGD steps of the MLP on the global batch: through
    with_data_parallel, or (transpile) as a plain program rewritten by
    GradAllReduce, each rank feeding its own rows. Returns (losses,
    the last step's pred and total fetches, final state)."""
    import torch.distributed as dist
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    main, startup, loss, pred, total = mlp(ptt, bn)
    scope = ptt.Scope()
    exe = _exe(ptt)
    exe.run(startup, scope=scope)
    scope_from_numpy(init, scope, ptt.CPUPlace(), program=main)
    feed = {"x": xs, "y": ys}
    prog = ptt.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    if transpile:
        from paddle_tpu_torch.transpiler import GradAllReduce
        n, r = dist.get_world_size(), dist.get_rank()
        GradAllReduce().transpile(startup, main, rank=r,
                                  endpoints=["a:1", "b:2"][:n],
                                  current_endpoint="a:1")
        rows = len(xs) // n
        feed = {k: v[r * rows:(r + 1) * rows] for k, v in feed.items()}
        prog = main
    out = []
    for _ in range(steps):
        out.append(exe.run(prog, feed=feed, fetch_list=[loss, pred, total],
                           scope=scope))
    state = {n: scope.get_numpy(n) for n in init}
    return [float(o[0]) for o in out], out[-1][1], float(out[-1][2]), state


def refused(kind):
    """The message a refused two-rank run raises."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.parallel.layout import mesh_from_spec
    main, startup, loss, _, _ = mlp(ptt)
    scope = ptt.Scope()
    exe = _exe(ptt)
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((8, 16), np.float32),
            "y": np.ones((8, 1), np.float32)}
    if kind == "batch_axes":
        prog = ptt.CompiledProgram(main).with_distributed(
            mesh_from_spec("2"), batch_axes=("data",))
    else:
        prog = ptt.CompiledProgram(main).with_distributed(
            mesh_from_spec("1,2"))
    try:
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


def parallel_executor(init, xs, ys, steps):
    """fluid.ParallelExecutor over the MLP: the losses."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.parallel import ParallelExecutor
    main, startup, loss, _, _ = mlp(ptt)
    scope = ptt.Scope()
    _exe(ptt).run(startup, scope=scope)
    scope_from_numpy(init, scope, ptt.CPUPlace(), program=main)
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                          main_program=main, scope=scope)
    return [float(pe.run([loss], feed={"x": xs, "y": ys})[0])
            for _ in range(steps)]


def dygraph_dp(w, b, xs, ys, steps):
    """DataParallel over a Linear(16, 1): rank r runs its rows, then
    apply_collective_grads and an SGD step. Returns (losses of the
    rank's rows, final weight, final bias)."""
    import torch.distributed as dist
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import dygraph as dg
    n, r = dist.get_world_size(), dist.get_rank()
    rows = len(xs) // n
    xb, yb = xs[r * rows:(r + 1) * rows], ys[r * rows:(r + 1) * rows]
    with dg.guard(ptt.CPUPlace()):
        lin = dg.Linear(16, 1)
        lin.weight.set_value(w)
        lin.bias.set_value(b)
        model = dg.DataParallel(lin)
        opt = ptt.optimizer.SGD(learning_rate=0.1)
        losses = []
        for _ in range(steps):
            pred = model(dg.to_variable(xb))
            loss = ptt.layers.mean(ptt.layers.square_error_cost(
                pred, dg.to_variable(yb)))
            loss.backward()
            model.apply_collective_grads()
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
            losses.append(float(loss.numpy()))
        return losses, lin.weight.numpy(), lin.bias.numpy()


def staged_all_reduce():
    """(the all-reduced CUDA tensor on the host, the bytes staged)."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.ops import collective as coll
    coll.reset_counts()
    x = torch.arange(12.0, device="cuda") + dist.get_rank()
    out = coll.all_reduce(x, None, "sum")
    return out.cpu().numpy(), coll.STAGED_BYTES["bytes"]
