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
    except ValueError as e:
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
    assert kind == "batch_axes", kind
    prog = ptt.CompiledProgram(main).with_distributed(
        mesh_from_spec("2"), batch_axes=("data",))
    try:
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


def mlp_tp_train(init, xs, ys, steps):
    """`steps` SGD steps of the MLP on a mesh dp1 x tp2 under its
    SpecLayout: (losses, the final state gathered whole)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.parallel.layout import SpecLayout, mesh_from_spec
    from paddle_tpu_torch.parallel.model_parallel import gather_param
    main, startup, loss, _, _ = mlp(ptt)
    scope = ptt.Scope()
    exe = _exe(ptt)
    exe.run(startup, scope=scope)
    scope_from_numpy(init, scope, ptt.CPUPlace(), program=main)
    mesh = mesh_from_spec("1,2")
    prog = ptt.CompiledProgram(main).with_distributed(
        mesh, state_spec_fn=SpecLayout(mesh).add_program(main))
    losses = [float(exe.run(prog, feed={"x": xs, "y": ys},
                            fetch_list=[loss], scope=scope)[0])
              for _ in range(steps)]
    return losses, {n: gather_param(scope, n).numpy() for n in init}


def parallel_executor_mp(init, xs, ys, steps, mesh_spec):
    """fluid.ParallelExecutor(mesh=...) over the MLP on a tp or fsdp mesh:
    (losses, the final state gathered whole)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.parallel import ParallelExecutor
    from paddle_tpu_torch.parallel.layout import mesh_from_spec
    from paddle_tpu_torch.parallel.model_parallel import gather_param
    main, startup, loss, _, _ = mlp(ptt)
    scope = ptt.Scope()
    _exe(ptt).run(startup, scope=scope)
    scope_from_numpy(init, scope, ptt.CPUPlace(), program=main)
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                          main_program=main, scope=scope,
                          mesh=mesh_from_spec(mesh_spec))
    losses = [float(pe.run([loss], feed={"x": xs, "y": ys})[0])
              for _ in range(steps)]
    return losses, {n: gather_param(scope, n).numpy() for n in init}


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


# -- model parallelism ----------------------------------------------------------

def tiny_model(ptt, kind, tp=False, sp=False, amp=False, layers=2):
    """(main, startup, loss, feed names) of a tiny transformer built by
    `ptt`: "bert" (transformer.build_train), "nmt" (nmt.build_train) or
    "gpt" (gpt.build_train), 2 layers (or `layers`), d 64, 4 heads,
    dropout 0, with the tp/sp hints (sp over the tp axis) when asked."""
    from importlib import import_module
    kw = dict(vocab_size=96, d_model=64, n_heads=4, n_layers=layers,
              d_ff=128,
              dropout=0.0, attn_dropout=0.0, tp=tp, sp=sp, sp_axis="tp",
              use_flash=False)
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        if kind == "bert":
            tr = import_module(f"{ptt.__name__}.models.transformer")
            cfg = tr.TransformerConfig(max_seq_len=MP_SEQ, **kw)
            loss, feeds = tr.build_train(cfg, MP_BATCH, MP_SEQ, lr=1e-3,
                                         amp=amp)
        elif kind == "nmt":
            nm = import_module(f"{ptt.__name__}.models.nmt")
            cfg = nm.transformer_big_nmt(max_seq_len=MP_SEQ, **kw)
            loss, feeds = nm.build_train(cfg, MP_BATCH, MP_SEQ, MP_SEQ,
                                         lr=1e-3)
        else:
            gp = import_module(f"{ptt.__name__}.models.gpt")
            cfg = gp.gpt_small(max_seq_len=MP_SEQ, **dict(
                kw, use_flash=False))
            loss, _, tok = gp.build_train(cfg, MP_BATCH, MP_SEQ, lr=1e-3)
            feeds = [tok]
    main.random_seed = startup.random_seed = 7
    return main, startup, loss, [f.name for f in feeds]


MP_BATCH, MP_SEQ = 4, 64


def mp_feeds(kind):
    rng = np.random.RandomState(11)
    toks = lambda t: rng.randint(0, 96, (MP_BATCH, t)).astype(np.int64)
    if kind == "bert":
        return {"tokens": toks(MP_SEQ), "labels": toks(MP_SEQ)}
    if kind == "nmt":
        return {"src_tokens": toks(MP_SEQ), "trg_tokens": toks(MP_SEQ + 1)}
    return {"tokens": toks(MP_SEQ)}


def mp_train(kind, init, steps, mesh_spec, batch_axes=("dp",), tp=True,
             sp=True, fetch_grads=False):
    """`steps` AdamW steps of the tiny `kind` model from `init` on the
    mesh `mesh_spec` ("dp,tp,fsdp" sizes) under its SpecLayout. Returns
    (losses, the final parameters gathered whole, {state: this rank's
    shape}, the first step's gradients gathered when asked)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.parallel.layout import SpecLayout, mesh_from_spec
    from paddle_tpu_torch.parallel.model_parallel import gather_param
    main, startup, loss, _ = tiny_model(ptt, kind, tp=tp, sp=sp)
    scope = ptt.Scope()
    exe = _exe(ptt)
    exe.run(startup, scope=scope)
    scope_from_numpy(init, scope, ptt.CPUPlace(), program=main)
    mesh = mesh_from_spec(mesh_spec)
    layout = SpecLayout(mesh).add_program(main)
    prog = ptt.CompiledProgram(main).with_distributed(
        mesh, state_spec_fn=layout, batch_axes=batch_axes)
    prog._loss_name = loss.name
    params = [v.name for v in main.list_vars()
              if getattr(v, "is_parameter", False)]
    feed = mp_feeds(kind)
    losses, grads = [], None
    fl = [loss] + ([p + "@GRAD" for p in params] if fetch_grads else [])
    for i in range(steps):
        out = exe.run(prog, feed=feed, fetch_list=fl, scope=scope)
        losses.append(float(out[0]))
        if i == 0 and len(out) > 1:
            grads = dict(zip(params, out[1:]))
    final = {p: gather_param(scope, p).numpy() for p in params}
    shapes = {n: tuple(scope.find_var(n).shape) for n in scope.names()
              if isinstance(scope.find_var(n), __import__("torch").Tensor)}
    # the split of the attention's queries in the rank program
    from paddle_tpu_torch.parallel.model_parallel import plan_for
    plan = plan_for(main, mesh, prog.spec_layout(), batch_axes)
    q = [op.inputs["Q"][0] for op in main.global_block().ops
         if op.type == "flash_attention"][0]
    shapes["flash Q split"] = tuple(plan.lay.get(q) or ())
    return losses, final, shapes, grads


def mp_dropout_masks():
    """(the mask dropout draws on a tp-split activation, the mask on a
    whole one) of this rank: x [4, 8, 64] through a column-split fc,
    dropout 0.5 on its split output and on the whole input."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.parallel.layout import SpecLayout, mesh_from_spec
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data("x", shape=[4, 8, 64], dtype="float32",
                            append_batch_size=False)
        h = ptt.layers.fc(x, size=64, num_flatten_dims=2)
        hd = ptt.layers.dropout(h, 0.5,
                                dropout_implementation="upscale_in_train")
        xd = ptt.layers.dropout(x, 0.5,
                                dropout_implementation="upscale_in_train")
        loss = ptt.layers.mean(hd) + ptt.layers.mean(xd)
    main.random_seed = startup.random_seed = 5
    scope = ptt.Scope()
    exe = _exe(ptt)
    exe.run(startup, scope=scope)
    mesh = mesh_from_spec("1,2")
    prog = ptt.CompiledProgram(main).with_distributed(
        mesh, state_spec_fn=SpecLayout(mesh).add_program(main))
    feed = {"x": np.ones((4, 8, 64), np.float32)}
    blk = main.global_block()
    masks = [op.outputs["Mask"][0] for op in blk.ops
             if op.type == "dropout"]
    from paddle_tpu_torch.parallel.model_parallel import plan_for
    split_mask, whole_mask = masks
    out = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(out[0]).all()
    plan = plan_for(main, mesh, prog.spec_layout(), ("dp",))
    assert plan.lay.get(split_mask) is not None
    assert plan.lay.get(whole_mask) is None
    env = {}
    from paddle_tpu_torch.core import lowering
    real = lowering.run_op

    def spy(op, e, ctx, op_idx=None):
        real(op, e, ctx, op_idx)
        for n in op.output_names():
            if n in (split_mask, whole_mask):
                env[n] = e[n].detach().float().numpy().copy()
    lowering.run_op = spy
    try:
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    finally:
        lowering.run_op = real
    return env[split_mask] != 0, env[whole_mask] != 0


# -- sequence parallelism -------------------------------------------------------

def seq_attention(scheme, q, k, v, do, causal):
    """(out, dq, dk, dv) of `scheme` ("ring" or "ulysses") attention over
    a mesh sp2 on whole [b, h, T, d] inputs, differentiated against the
    cotangent `do`; "ulysses_chunks" hands Ulysses each rank's sequence
    chunk (its all-to-all path) and gathers the output."""
    import torch
    from paddle_tpu_torch.ops import collective as coll
    from paddle_tpu_torch.ops.collective import Split
    from paddle_tpu_torch.parallel.mesh import make_mesh
    from paddle_tpu_torch.parallel import ring_attention as ra
    from paddle_tpu_torch.parallel import ulysses as ul
    mesh = make_mesh((2,), ("sp",))

    def chunks(a, b, c, mesh_, axis, causal):
        g = mesh_.group(axis)
        parts = (coll.scatter_to(x, g, Split(2)) for x in (a, b, c))
        return coll.gather_from(ul.ulysses_attention(*parts, g, causal),
                                g, Split(2))
    fn = {"ring": ra.ring_attention_sharded,
          "ulysses": ul.ulysses_attention_sharded,
          "ulysses_chunks": chunks}[scheme]
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fn(qt, kt, vt, mesh, "sp", causal=causal)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(do))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def ulysses_refuses_odd_heads():
    import torch
    from paddle_tpu_torch.parallel.mesh import make_mesh
    from paddle_tpu_torch.parallel import ulysses as ul
    q = torch.zeros(1, 3, 8, 4)
    try:
        ul.ulysses_attention_sharded(q, q, q, make_mesh((2,), ("sp",)),
                                     "sp")
    except ValueError as e:
        return str(e)
    return None


def long_context(ptt, scheme, batch=2, t=64, d=32, heads=4, vocab=64,
                 bf16=False):
    """examples/long_context.py's program built by `ptt` with `scheme`
    attention (ring or ulysses), Adam; with `bf16`, q, k and v cast to
    bfloat16 around the attention op (as the card's cell runs it)."""
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 11
    L = ptt.layers
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        tokens = L.data("tokens", shape=[batch, t], dtype="int64",
                        append_batch_size=False)
        targets = L.data("targets", shape=[batch, t], dtype="int64",
                         append_batch_size=False)
        emb = L.embedding(tokens, size=[vocab, d])
        qkv = L.fc(emb, size=3 * d, num_flatten_dims=2)
        q = L.slice(qkv, axes=[2], starts=[0], ends=[d])
        k = L.slice(qkv, axes=[2], starts=[d], ends=[2 * d])
        v = L.slice(qkv, axes=[2], starts=[2 * d], ends=[3 * d])

        def heads_first(x):
            x = L.reshape(x, shape=[batch, t, heads, d // heads])
            x = L.transpose(x, perm=[0, 2, 1, 3])
            return L.cast(x, "bfloat16") if bf16 else x

        attn = L.ring_attention if scheme == "ring" else \
            L.ulysses_attention
        ctxv = attn(heads_first(q), heads_first(k), heads_first(v),
                    causal=True)
        if bf16:
            ctxv = L.cast(ctxv, "float32")
        ctxv = L.transpose(ctxv, perm=[0, 2, 1, 3])
        ctxv = L.reshape(ctxv, shape=[batch, t, d])
        h = L.fc(ctxv, size=d, num_flatten_dims=2, act="relu")
        logits = L.fc(h, size=vocab, num_flatten_dims=2)
        loss = L.mean(L.softmax_with_cross_entropy(
            logits, L.reshape(targets, shape=[batch, t, 1])))
        ptt.optimizer.Adam(learning_rate=3e-3).minimize(loss)
    return main, startup, loss


def long_context_feeds(batch=2, t=64, vocab=64):
    toks = np.random.RandomState(0).randint(0, vocab, (batch, t))
    return {"tokens": toks.astype(np.int64),
            "targets": np.roll(toks, 1, axis=1).astype(np.int64)}


def long_context_train(scheme, init, steps):
    """`steps` Adam steps of the long-context program over a mesh sp2
    (the batch not split): the losses."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.parallel.mesh import make_mesh
    main, startup, loss = long_context(ptt, scheme)
    scope = ptt.Scope()
    exe = _exe(ptt)
    exe.run(startup, scope=scope)
    scope_from_numpy(init, scope, ptt.CPUPlace(), program=main)
    prog = ptt.CompiledProgram(main).with_distributed(
        make_mesh((2,), ("sp",)), batch_axes=())
    return [float(exe.run(prog, feed=long_context_feeds(),
                          fetch_list=[loss], scope=scope)[0])
            for _ in range(steps)]


# -- mixture of experts -----------------------------------------------------------

def moe_sharded(x, params, capacity, cot):
    """(y, load, {param: d sum(y * cot) / d param}) of the MoE FFN over a
    mesh ep2 from whole arrays: dense when capacity is None, else the
    capacity-based dispatch."""
    import torch
    from paddle_tpu_torch.parallel import moe
    from paddle_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((2,), ("ep",))
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    xt = torch.tensor(x, requires_grad=True)
    if capacity is None:
        y, load = moe.moe_ffn_sharded(xt, p, mesh, ep_axis="ep")
    else:
        y, load = moe.moe_ffn_sparse_sharded(xt, p, mesh, ep_axis="ep",
                                             capacity=capacity)
    names = sorted(p)
    grads = torch.autograd.grad((y * torch.tensor(cot)).sum(),
                                [p[k] for k in names] + [xt])
    return (y.detach().numpy(), float(load),
            {k: g.numpy() for k, g in zip(names + ["x"], grads)})


def moe_program(ptt, capacity=None, batch=4, t=6, d=16, experts=4,
                d_ff=32):
    """tests/test_parallel.py:474's static program around layers.moe_ffn,
    Adam 5e-3."""
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = startup.random_seed = 3
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data("moe_x", shape=[t, d], dtype="float32")
        y, load = ptt.layers.moe_ffn(x, num_experts=experts, d_ff=d_ff,
                                     capacity=capacity)
        tgt = ptt.layers.data("moe_t", shape=[t, d], dtype="float32")
        loss = ptt.layers.mean(ptt.layers.square(
            ptt.layers.elementwise_sub(y, tgt)))
        ptt.optimizer.Adam(learning_rate=5e-3).minimize(loss)
    return main, startup, loss, load


def moe_feeds(batch=4, t=6, d=16):
    xv = np.random.RandomState(0).randn(batch, t, d).astype(np.float32)
    return {"moe_x": xv, "moe_t": np.tanh(xv)}


def moe_train(init, steps, capacity=None):
    """`steps` Adam steps of the MoE program over a mesh ep2 (the batch
    whole on both ranks): (losses, loads, {expert weight: rank shape})."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.parallel.mesh import make_mesh
    main, startup, loss, load = moe_program(ptt, capacity)
    scope = ptt.Scope()
    exe = _exe(ptt)
    exe.run(startup, scope=scope)
    scope_from_numpy(init, scope, ptt.CPUPlace(), program=main)
    prog = ptt.CompiledProgram(main).with_distributed(
        make_mesh((2,), ("ep",)), batch_axes=())
    losses, loads = [], []
    for _ in range(steps):
        lv, ld = exe.run(prog, feed=moe_feeds(), fetch_list=[loss, load],
                         scope=scope)
        losses.append(float(lv))
        loads.append(float(ld))
    shapes = {n: tuple(scope.find_var(n).shape) for n in scope.names()
              if n.endswith((".w1", ".w2", ".b1", ".gate_w"))}
    return losses, loads, shapes


# -- sharded checkpoints ------------------------------------------------------------

def ckpt_spec_fn(name):
    """tests/test_sharded_checkpoint.py's specs: w_col split on its
    columns over tp, w_row on its rows."""
    from paddle_tpu_torch.parallel.layout import PartitionSpec as P
    return {"w_col": P(None, "tp"), "w_row": P("tp", None)}.get(name)


def ckpt_build(ptt, batch=8):
    """tests/test_sharded_checkpoint.py's program built by `ptt`."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup), ptt.unique_name.guard():
        x = ptt.layers.data("x", shape=[batch, 8], dtype="float32",
                            append_batch_size=False)
        y = ptt.layers.data("y", shape=[batch, 1], dtype="float32",
                            append_batch_size=False)
        h = ptt.layers.fc(x, size=16, act="relu",
                          param_attr=ptt.ParamAttr(name="w_col"),
                          bias_attr=ptt.ParamAttr(name="b1"))
        pred = ptt.layers.fc(h, size=1, param_attr=ptt.ParamAttr(
            name="w_row"), bias_attr=ptt.ParamAttr(name="b2"))
        loss = ptt.layers.mean(ptt.layers.square_error_cost(pred, y))
        ptt.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, startup, loss


def ckpt_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(8, 8).astype(np.float32),
            "y": rng.randn(8, 1).astype(np.float32)}


def ckpt_save(init, dirname):
    """One Adam step of the checkpoint program on a mesh tp2 from `init`,
    then save_sharded_persistables: (loss, {state: gathered value},
    {state: this rank's shape})."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.parallel.layout import mesh_from_spec
    from paddle_tpu_torch.parallel.model_parallel import gather_param
    main, startup, loss = ckpt_build(ptt)
    scope = ptt.Scope()
    exe = _exe(ptt)
    exe.run(startup, scope=scope)
    scope_from_numpy(init, scope, ptt.CPUPlace(), program=main)
    prog = ptt.CompiledProgram(main).with_distributed(
        mesh_from_spec("1,2"), state_spec_fn=ckpt_spec_fn)
    lv = float(exe.run(prog, feed=ckpt_feed(), fetch_list=[loss],
                       scope=scope)[0])
    ptt.save_sharded_persistables(exe, dirname, main, scope=scope)
    names = [v.name for v in main.list_vars() if v.persistable
             and isinstance(scope.find_var(v.name), __import__("torch")
                            .Tensor)]
    return (lv, {n: gather_param(scope, n).numpy() for n in names},
            {n: tuple(scope.find_var(n).shape) for n in names})


def ckpt_load(dirname):
    """load_sharded_persistables on a mesh tp2: ({state: this rank's
    shape}, {state: this rank's loaded shard}, the loss of one more
    step)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.parallel.layout import mesh_from_spec
    from paddle_tpu_torch.parallel.model_parallel import gather_param
    main, startup, loss = ckpt_build(ptt)
    mesh = mesh_from_spec("1,2")
    prog = ptt.CompiledProgram(main).with_distributed(
        mesh, state_spec_fn=ckpt_spec_fn)
    scope = ptt.Scope()
    exe = _exe(ptt)
    ptt.load_sharded_persistables(exe, dirname, main, mesh=mesh,
                                  scope=scope, layout=prog.spec_layout())
    loaded = {n: scope.get_numpy(n) for n in scope.names()}
    shapes = {n: tuple(scope.find_var(n).shape) for n in scope.names()}
    lv = float(exe.run(prog, feed=ckpt_feed(), fetch_list=[loss],
                       scope=scope)[0])
    return shapes, loaded, lv


# -- priced against moved ---------------------------------------------------------

def _program(kind):
    """(main, startup, loss, feed, mesh spec, batch axes, with a
    SpecLayout) of the case `kind` of priced_and_moved."""
    import paddle_tpu_torch as ptt
    if kind in ("bert_tp_sp", "bert_tp", "nmt_tp_sp", "bert_fsdp"):
        model = kind.split("_")[0]
        tp = "_tp" in kind
        main, startup, loss, _ = tiny_model(ptt, model, tp=tp,
                                            sp=kind.endswith("_sp"))
        if kind == "bert_fsdp":
            return main, startup, loss, mp_feeds(model), "1,1,2", \
                ("fsdp",), True
        return main, startup, loss, mp_feeds(model), "1,2", ("dp",), True
    if kind == "gpt_dp2tp2":
        main, startup, loss, _ = tiny_model(ptt, "gpt", tp=True)
        return main, startup, loss, mp_feeds("gpt"), "2,2", ("dp",), True
    if kind.startswith(("ring", "ulysses")):
        main, startup, loss = long_context(ptt, kind.split("_")[0],
                                           bf16=kind.endswith("_bf16"))
        return main, startup, loss, long_context_feeds(), "sp", (), False
    cap = {"moe_dense": None, "moe_sparse": 12}[kind]
    main, startup, loss, _ = moe_program(ptt, cap)
    return main, startup, loss, moe_feeds(), "ep", (), False


def priced_and_moved(kind, steps=2):
    """Run `steps` steps of the case `kind` on the ranks' mesh; returns
    (the bytes this rank's collectives moved in the last step, the bytes
    the sharding gate priced for the rank program a step, {collective
    kind: bytes moved})."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import collective as coll
    from paddle_tpu_torch.parallel.layout import SpecLayout, mesh_from_spec
    from paddle_tpu_torch.parallel.mesh import make_mesh
    main, startup, loss, feed, spec, batch_axes, with_layout = \
        _program(kind)
    scope = ptt.Scope()
    exe = _exe(ptt)
    exe.run(startup, scope=scope)
    if with_layout:
        mesh = mesh_from_spec(spec)
        prog = ptt.CompiledProgram(main).with_distributed(
            mesh, state_spec_fn=SpecLayout(mesh).add_program(main),
            batch_axes=batch_axes)
    else:
        prog = ptt.CompiledProgram(main).with_distributed(
            make_mesh((2,), (spec,)), batch_axes=batch_axes)
    prog._loss_name = loss.name
    for i in range(steps):
        if i == steps - 1:
            coll.reset_counts()
        exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
    moved = dict(coll.COLLECTIVE_BYTES)
    return (sum(moved.values()),
            exe.last_sharding_report.collective_bytes_per_step, moved)


def deep_tp_step(init, layers):
    """One AdamW step of the tiny BERT with `layers` layers at tp2 with
    sequence parallelism: (the loss, the last layer's FFN-out weight
    after the step, gathered whole)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.parallel.layout import SpecLayout, mesh_from_spec
    from paddle_tpu_torch.parallel.model_parallel import gather_param
    main, startup, loss, _ = tiny_model(ptt, "bert", tp=True, sp=True,
                                        layers=layers)
    scope = ptt.Scope()
    exe = _exe(ptt)
    exe.run(startup, scope=scope)
    scope_from_numpy(init, scope, ptt.CPUPlace(), program=main)
    mesh = mesh_from_spec("1,2")
    prog = ptt.CompiledProgram(main).with_distributed(
        mesh, state_spec_fn=SpecLayout(mesh).add_program(main))
    prog._loss_name = loss.name
    out = exe.run(prog, feed=mp_feeds("bert"), fetch_list=[loss],
                  scope=scope)
    w = f"layer_{layers - 1}.ffn.fc2.w"
    return float(out[0]), gather_param(scope, w).numpy()


# -- the pipeline (parallel/pipeline.py) --------------------------------

def tanh_stage(p, h):
    """tests/test_parallel.py's GPipe stage."""
    import torch
    return torch.tanh(h @ p["w"] + p["b"])


def gpipe_run(params, x, n_micro, shape, names, x_grad=False):
    """gpipe of tanh_stage over a mesh of `shape` / `names` on the
    global `x`, loss mean(out ** 2) backward: (this rank's output, the
    loss, each stacked parameter's gradient, x's gradient, the
    stage_fn calls, this rank's pp index)."""
    import torch
    from paddle_tpu_torch.parallel import gpipe, pipeline
    from paddle_tpu_torch.parallel import stack_stage_params
    from paddle_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(tuple(shape), tuple(names))
    stacked = {k: v.requires_grad_() for k, v in
               stack_stage_params(params).items()}
    xt = torch.as_tensor(x).requires_grad_(x_grad)
    pipeline.STAGE_CALLS["calls"] = 0
    out = gpipe(tanh_stage, stacked, xt, n_microbatches=n_micro,
                mesh=mesh, axis="pp")
    loss = (out ** 2).mean()
    loss.backward()
    return (out.detach().numpy(), float(loss),
            {k: v.grad.numpy() for k, v in stacked.items()},
            xt.grad.numpy() if x_grad else None,
            pipeline.STAGE_CALLS["calls"], mesh.axis_index("pp"))


def gpipe_3axis(params, x, y, lr=0.1):
    """__graft_entry__._dryrun_3axis's step on a dp1 x tp2 x pp2 mesh:
    w1 split by columns and b1 with it, w2 by rows over tp (Megatron's
    f before w1, g after w2), GPipe over pp with 2 microbatches, loss
    mean((out - y) ** 2), one SGD step on this rank's shards. Returns
    (loss, {name: this rank's updated shard of its stage}, (tp, pp))."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import collective as coll
    from paddle_tpu_torch.parallel import gpipe, stack_stage_params
    from paddle_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((1, 2, 2), ("dp", "tp", "pp"))
    tp_group, t = mesh.group("tp"), mesh.axis_index("tp")
    f = params[0]["w1"].shape[1] // 2
    cols = slice(t * f, (t + 1) * f)
    local = [{"w1": p["w1"][:, cols], "b1": p["b1"][cols],
              "w2": p["w2"][cols], "b2": p["b2"]} for p in params]
    stacked = {k: v.requires_grad_() for k, v in
               stack_stage_params(local).items()}

    def stage(p, h):
        h = coll.copy_to(h, tp_group)
        hh = F.gelu(h @ p["w1"] + p["b1"], approximate="tanh")
        return torch.tanh(coll.reduce_from(hh @ p["w2"], tp_group)
                          + p["b2"])

    out = gpipe(stage, stacked, torch.as_tensor(x), n_microbatches=2,
                mesh=mesh, axis="pp")
    loss = ((out - torch.as_tensor(y)) ** 2).mean()
    loss.backward()
    s = mesh.axis_index("pp")
    new = {k: (v - lr * v.grad)[s].detach().numpy()
           for k, v in stacked.items()}
    return float(loss), new, (t, s)


def mlp_pp_train(init, xs, ys, steps, shape):
    """`steps` SGD steps of the MLP through with_distributed on a mesh
    ("dp", "pp") of `shape` (the pp ranks replicas of their dp
    coordinate): (losses, the final state, the sharding gate's priced
    collective bytes, the gradient bytes this rank synced)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.parallel import data_parallel
    from paddle_tpu_torch.parallel.layout import SpecLayout
    from paddle_tpu_torch.parallel.mesh import make_mesh
    main, startup, loss, _, _ = mlp(ptt)
    scope = ptt.Scope()
    exe = _exe(ptt)
    exe.run(startup, scope=scope)
    scope_from_numpy(init, scope, ptt.CPUPlace(), program=main)
    mesh = make_mesh(tuple(shape), ("dp", "pp"))
    prog = ptt.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name).with_distributed(
        mesh, state_spec_fn=SpecLayout(mesh).add_program(main),
        batch_axes=("dp",))
    data_parallel.GRAD_SYNC_BYTES["bytes"] = 0
    losses = [float(exe.run(prog, feed={"x": xs, "y": ys},
                            fetch_list=[loss], scope=scope)[0])
              for _ in range(steps)]
    report = exe.last_sharding_report
    return (losses, {n: scope.get_numpy(n) for n in init},
            report.collective_bytes_per_step if report else None,
            data_parallel.GRAD_SYNC_BYTES["bytes"])
