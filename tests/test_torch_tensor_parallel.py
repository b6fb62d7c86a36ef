"""Tensor, sequence and weight sharding at two (and four) gloo ranks,
against the JAX package's with_distributed runs on its CPU mesh.

The JAX package jits the global program and GSPMD partitions it; the
port rewrites it into each rank's program (parallel/model_parallel.py)
and runs one process a rank. Both start from the JAX startup state and
take the same global feeds. Held here: the tiny BERT and the tiny NMT at
tp2 with sequence parallelism over the tp axis, the tiny BERT at fsdp2,
the tiny GPT on a dp2 x tp2 mesh with ZeRO (four ranks), and the
deliberate differences: the weights Megatron holds by their rows, and
dropout's masks on split activations (ROADMAP §C).
"""
import numpy as np
import pytest

import paddle_tpu as fj
import torch_parallel_jobs as jobs
from torch_parallel_pool import make_pool_fixture

pool = make_pool_fixture()

STEPS = 3
_ref = {}
# the JAX side's static analysis is not under test here: off, it halves
# the JAX package's compiles
JAX_ANALYSIS_OFF = {"FLAGS_program_verify": "off", "FLAGS_memory_gate": "off",
                    "FLAGS_graph_opt_level": 0, "FLAGS_sharding_verify": "off"}


def _jax_run(kind, mesh_shape, axes, batch_axes, tp=True, sp=True):
    """(startup state, losses, final params, first-step grads) of the JAX
    package's with_distributed run of the tiny `kind` model."""
    key = (kind, mesh_shape, axes, batch_axes, tp, sp)
    if key in _ref:
        return _ref[key]
    import jax
    from jax.sharding import Mesh
    from paddle_tpu.parallel.layout import SpecLayout
    main, startup, loss, _ = jobs.tiny_model(fj, kind, tp=tp, sp=sp)
    n = int(np.prod(mesh_shape))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(mesh_shape), axes)
    scope = fj.Scope()
    params = [v.name for v in main.list_vars()
              if getattr(v, "is_parameter", False)]
    old = fj.get_flags(list(JAX_ANALYSIS_OFF))
    fj.set_flags(JAX_ANALYSIS_OFF)
    try:
        init, losses, final, grads = _jax_steps(main, startup, loss, kind,
                                                mesh, batch_axes, params,
                                                scope)
    finally:
        fj.set_flags(old)
    _ref[key] = (init, losses, final, grads)
    return _ref[key]


def _jax_steps(main, startup, loss, kind, mesh, batch_axes, params, scope):
    from paddle_tpu.parallel.layout import SpecLayout
    with fj.scope_guard(scope):
        exe = fj.Executor()
        exe.run(startup)
        init = {v.name: np.asarray(scope.get_numpy(v.name))
                for v in main.list_vars() if v.persistable
                and scope.find_var(v.name) is not None}
        layout = SpecLayout(mesh).add_program(main)
        prog = fj.CompiledProgram(main).with_distributed(
            mesh, state_spec_fn=layout, batch_axes=batch_axes)
        losses, grads = [], None
        # one fetch list for every step: one compile
        fl = [loss] + [p + "@GRAD" for p in params]
        for i in range(STEPS):
            out = exe.run(prog, feed=jobs.mp_feeds(kind), fetch_list=fl)
            losses.append(float(np.asarray(out[0])))
            if i == 0:
                grads = {p: np.asarray(g) for p, g in zip(params, out[1:])}
        final = {p: np.asarray(scope.get_numpy(p)) for p in params}
    return init, losses, final, grads


def _check(got, ref, grad_rtol=1e-4):
    _, losses, final, grads = ref
    for r_losses, r_params, _, r_grads in got:
        np.testing.assert_allclose(r_losses, losses, rtol=1e-4, atol=1e-5)
        assert r_params.keys() == final.keys()
        for n in final:
            np.testing.assert_allclose(r_params[n], final[n], rtol=1e-4,
                                       atol=1e-4, err_msg=n)
        if r_grads is not None:
            for n in grads:
                scale = float(np.abs(grads[n]).max())
                np.testing.assert_allclose(
                    r_grads[n], grads[n], rtol=0,
                    atol=grad_rtol * max(scale, 1e-6), err_msg=n)


@pytest.mark.parametrize("kind", ["bert", "nmt"])
def test_tp2_with_sequence_parallelism_matches_jax(pool, kind):
    """tp2 with `sp` over the tp axis: 3 AdamW steps' losses and final
    parameters within 1e-4 of the JAX package's dp1 x tp2 run, the
    first step's gradients within 1e-4 of each one's largest entry. Each
    rank holds half of every tp-split weight: the q/k/v and FFN-in
    weights by their columns (SpecLayout's spec), proj and FFN-out by
    their rows."""
    ref = _jax_run(kind, (1, 2), ("dp", "tp"), ("dp",))
    got = pool.run(jobs.mp_train, kind, ref[0], STEPS, "1,2", ("dp",),
                   True, True, True)
    _check(got, ref)
    pre = "layer_0.att" if kind == "bert" else "enc_0.att"
    for _, _, shapes, _ in got:
        assert shapes[f"{pre}.q.w"] == (64, 32)
        assert shapes[f"{pre}.q.w_moment1_0"] == (64, 32)
        assert shapes[f"{pre}.proj.w"] == (32, 64)
        assert shapes[f"{pre}.proj.b"] == (64,)
        # attention runs on this rank's heads: [b, h/2, T, hd]
        assert shapes["flash Q split"] == (1, 1, 1)


def test_tp2_without_sequence_parallelism_matches_jax(pool):
    """The tiny BERT at tp2 with the tp hints only: the partial sums of
    the row-held products are all-reduced (Megatron's g) instead of
    reduce-scattered over the sequence."""
    ref = _jax_run("bert", (1, 2), ("dp", "tp"), ("dp",), sp=False)
    got = pool.run(jobs.mp_train, "bert", ref[0], STEPS, "1,2", ("dp",),
                   True, False, True)
    _check(got, ref)


def test_fsdp2_matches_jax(pool):
    """The tiny BERT on a mesh fsdp2, the batch split over it: every
    weight whose dim 0 divides is held as half its rows (its moments
    too), all-gathered before each use, its gradient reduce-scattered."""
    ref = _jax_run("bert", (1, 1, 2), ("dp", "tp", "fsdp"), ("fsdp",),
                   tp=False, sp=False)
    got = pool.run(jobs.mp_train, "bert", ref[0], STEPS, "1,1,2",
                   ("fsdp",), False, False, True)
    _check(got, ref)
    for _, _, shapes, _ in got:
        assert shapes["word_emb"] == (48, 64)
        assert shapes["word_emb_moment2_0"] == (48, 64)
        assert shapes["layer_0.ffn.fc1.w"] == (32, 128)


def test_dropout_masks_under_tp(pool):
    """A deliberate difference: dropout on an activation split over tp
    draws a different mask on each rank (its seed folded with the rank),
    and on a whole activation the same mask on every rank."""
    got = pool.run(jobs.mp_dropout_masks)
    split0, whole0 = got[0]
    split1, whole1 = got[1]
    np.testing.assert_array_equal(whole0, whole1)
    assert split0.shape == split1.shape
    assert not np.array_equal(split0, split1)
    for m in (split0, split1, whole0):
        assert 0.3 < float(m.mean()) < 0.7


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    import os
    from paddle_tpu_torch.distributed.spawn import RankPool
    store = os.path.join(str(tmp_path_factory.mktemp("ranks4")), "store")
    p = RankPool(4, store, backend="gloo", timeout_s=60.0,
                 env={"OMP_NUM_THREADS": "1"})
    yield p
    p.close()


def test_gpt_on_dp2_tp2_with_zero_matches_jax(pool4):
    """The tiny GPT on a composed dp2 x tp2 mesh (four ranks): the batch
    split over dp, the weights over tp, and ZeRO holding each rank's dp
    rows of its tp shard of the AdamW moments: 3 steps within 1e-4 of
    the JAX package's dp2 x tp2 run."""
    ref = _jax_run("gpt", (2, 2), ("dp", "tp"), ("dp",), sp=False)
    got = pool4.run(jobs.mp_train, "gpt", ref[0], STEPS, "2,2", ("dp",),
                    True, False, False)
    _check(got, ref)
    for _, _, shapes, _ in got:
        # lm_head.w [64, 96]: tp halves its columns, ZeRO its rows
        assert shapes["lm_head.w_moment1_0"] == (32, 48)
        assert shapes["lm_head.w"] == (64, 48)


def test_planner_prices_hints_and_the_rank_programs_buffers():
    """The device peak of the tiny BERT with the tp/sp hints equals the
    one without (a hint returns its input: no bytes of its own), and a
    tp2 rank program's plan charges the adapters' buffers (the gathered
    inputs its products hold to their grad ops) and reads its local
    shapes (below the one-rank plan)."""
    import paddle_tpu_torch as ft
    from paddle_tpu_torch.analysis.memory import analyze_program_memory
    from paddle_tpu_torch.parallel.layout import SpecLayout
    from paddle_tpu_torch.parallel.mesh import Mesh, mesh_context
    from paddle_tpu_torch.parallel.model_parallel import (ModelParallelPlan,
                                                          RankLayout)
    feed = {k: (v.shape, "int64") for k, v in jobs.mp_feeds("bert").items()}
    peaks = {}
    for hints in (False, True):
        main, _, loss, _ = jobs.tiny_model(ft, "bert", tp=hints, sp=hints)
        peaks[hints] = analyze_program_memory(
            main, feed_shapes=feed, fetch_names=[loss.name]) \
            .device_peak_bytes
    assert peaks[True] == peaks[False]
    mesh = Mesh(np.arange(2).reshape(1, 2), ("dp", "tp"))
    layout = SpecLayout(mesh).add_program(main)
    plan = ModelParallelPlan(main, mesh, layout, ("dp",))
    with mesh_context(mesh):
        rank = analyze_program_memory(
            plan.program, feed_shapes=feed, fetch_names=[loss.name],
            layout=RankLayout(layout, plan))
    assert rank.device_charges["collective_buffers"] > 0
    assert rank.device_peak_bytes < peaks[True]


@pytest.mark.parametrize("kind", ["bert_tp_sp", "bert_tp", "nmt_tp_sp",
                                  "bert_fsdp"])
def test_priced_collectives_are_the_moved_bytes(pool, kind):
    """A model-parallel run's sharding gate prices the analyzer's rank
    walk, the plan its rank program was built from: the bytes it charges
    a step equal, to the byte, what the rank's collectives moved in its
    second step (the adapters forward and backward, the gradient sync
    and the fetches)."""
    for moved, priced, kinds in pool.run(jobs.priced_and_moved, kind):
        assert priced == moved, kinds


def test_gpt_dp2_tp2_priced_collectives_are_the_moved_bytes(pool4):
    """The same on the composed dp2 x tp2 mesh, ZeRO's gradient
    reduce-scatter and parameter all-gather included."""
    for moved, priced, kinds in pool4.run(jobs.priced_and_moved,
                                          "gpt_dp2tp2"):
        assert priced == moved, kinds


def test_deep_model_plans_every_row_held_weight(pool):
    """34 layers at tp2: one walk finds every weight whose product
    contracts over a split dim, a second plans with all of them held by
    their rows, and each layer's products get layer 0's adapters. One
    step's loss and the last layer's updated FFN-out weight equal the
    port's one-process run."""
    import paddle_tpu_torch as ft
    from paddle_tpu_torch.parallel.layout import SpecLayout, mesh_from_spec
    from paddle_tpu_torch.parallel.model_parallel import ModelParallelPlan
    layers = 34
    main, startup, loss, _ = jobs.tiny_model(ft, "bert", tp=True, sp=True,
                                             layers=layers)
    mesh = mesh_from_spec("1,2")
    plan = ModelParallelPlan(main, mesh, SpecLayout(mesh).add_program(main),
                             ("dp",))
    assert plan.rehold == {f"layer_{i}.{w}" for i in range(layers)
                           for w in ("att.proj.w", "ffn.fc2.w")}
    assert plan.report.rank.walks == 2
    muls = [plan.attrs.get(op.id) for op in main.global_block().ops
            if op.type == "mul"]
    per_layer = (len(muls) - 1) // layers       # the MLM head's last
    first = [json_of(a) for a in muls[:per_layer]]
    for i in range(layers):
        assert [json_of(a) for a in
                muls[i * per_layer:(i + 1) * per_layer]] == first, i

    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    init = {v.name: scope.get_numpy(v.name) for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}
    want = float(exe.run(main, feed=jobs.mp_feeds("bert"),
                         fetch_list=[loss], scope=scope)[0])
    w = scope.get_numpy(f"layer_{layers - 1}.ffn.fc2.w")
    for got, got_w in pool.run(jobs.deep_tp_step, init, layers):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got_w, w, rtol=1e-4, atol=1e-5)


def json_of(attr):
    import json
    return json.dumps(attr, sort_keys=True)


def test_an_op_without_a_rank_rule_is_named():
    """An op the rank walk has no rule for (reduce_max) gathers its
    split input and runs whole on every rank; the report names it: a
    PTV063 finding and the op type among `uncovered`."""
    import paddle_tpu_torch as ft
    from paddle_tpu_torch.parallel.layout import SpecLayout, mesh_from_spec
    from paddle_tpu_torch.parallel.model_parallel import ModelParallelPlan
    main, startup = ft.Program(), ft.Program()
    with ft.program_guard(main, startup), ft.unique_name.guard():
        x = ft.layers.data("x", shape=[8, 16], dtype="float32",
                           append_batch_size=False)
        h = ft.layers.fc(x, size=32)
        ft.layers.mean(ft.layers.reduce_max(h, dim=1))
    mesh = mesh_from_spec("1,2")
    plan = ModelParallelPlan(main, mesh, SpecLayout(mesh).add_program(main),
                             ("dp",))
    assert plan.report.uncovered == ["reduce_max"]
    found = [d for d in plan.report.result.findings if d.rule == "PTV063"]
    assert len(found) == 1 and "reduce_max" in found[0].message
    op = [o for o in main.global_block().ops if o.type == "reduce_max"][0]
    assert plan.attrs[op.id]["in"]["X"]["0"][0][0] == "gather"
