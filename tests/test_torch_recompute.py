"""Activation recompute (parallel/recompute.py, RecomputeOptimizer) and
PipelineOptimizer against the JAX package.

RecomputeOptimizer moves each segment between checkpoints into a
sub-block behind one `recompute_segment` op before the backward; the
port runs the segment under torch.utils.checkpoint, so its grad op
computes it again. The programs are the JAX package's to the byte, and
the losses equal both the JAX package's recompute run and the port's
plain run (tests/test_parallel.py:248).
"""
import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu_torch.convert import scope_from_numpy


def _mlp(f, recompute, steps_opt="sgd"):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data("x", shape=[16], dtype="float32")
        label = f.layers.data("y", shape=[1], dtype="float32")
        h1 = f.layers.fc(x, size=32, act="relu")
        h2 = f.layers.fc(h1, size=32, act="relu")
        pred = f.layers.fc(h2, size=1)
        loss = f.layers.mean(f.layers.square_error_cost(pred, label))
        inner = f.optimizer.SGD(learning_rate=0.1)
        if recompute:
            opt = f.optimizer.RecomputeOptimizer(inner)
            opt._set_checkpoints([h1, h2])
            opt.minimize(loss)
        else:
            inner.minimize(loss)
    main.random_seed = startup.random_seed = 11
    return main, startup, loss


def _bert(f, recompute, dropout=0.0):
    """The tiny BERT (2 layers, d 64, T 64) with AdamW, recompute
    checkpointed at each layer's output."""
    from importlib import import_module
    tr = import_module(f"{f.__name__}.models.transformer")
    cfg = tr.TransformerConfig(vocab_size=96, d_model=64, n_heads=4,
                               n_layers=2, d_ff=128, max_seq_len=64,
                               dropout=dropout, use_flash=False)
    main, startup = f.Program(), f.Program()

    def opt_cls(learning_rate):
        inner = f.optimizer.AdamW(learning_rate=learning_rate)
        if not recompute:
            return inner
        opt = f.optimizer.RecomputeOptimizer(inner)
        blk = main.global_block()
        opt._set_checkpoints([
            op.outputs["Y"][0] for op in blk.ops
            if op.type == "layer_norm" and
            op.inputs["Scale"][0].endswith(".ln2.w")])
        return opt

    with f.program_guard(main, startup), f.unique_name.guard():
        loss, _ = tr.build_train(cfg, 4, 64, lr=1e-3, optimizer_cls=opt_cls)
    main.random_seed = startup.random_seed = 7
    return main, startup, loss


def _feeds_mlp():
    rng = np.random.RandomState(3)
    return {"x": rng.randn(16, 16).astype(np.float32),
            "y": rng.randn(16, 1).astype(np.float32)}


def _feeds_bert():
    rng = np.random.RandomState(11)
    t = lambda: rng.randint(0, 96, (4, 64)).astype(np.int64)  # noqa
    return {"tokens": t(), "labels": t()}


def _jax_losses(main, startup, loss, feed, steps):
    scope = fj.Scope()
    with fj.scope_guard(scope):
        exe = fj.Executor()
        exe.run(startup)
        init = {v.name: np.asarray(scope.get_numpy(v.name))
                for v in main.list_vars() if v.persistable
                and scope.find_var(v.name) is not None}
        return init, [float(np.asarray(exe.run(
            main, feed=feed, fetch_list=[loss])[0])) for _ in range(steps)]


def _port_losses(main, startup, loss, feed, steps, init=None):
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    if init is not None:
        scope_from_numpy(init, scope, ft.CPUPlace(), program=main)
    return [float(exe.run(main, feed=feed, fetch_list=[loss],
                          scope=scope)[0]) for _ in range(steps)]


@pytest.mark.parametrize("build", [_mlp, _bert], ids=["mlp", "bert"])
def test_recompute_programs_equal_the_jax_rewrite(build):
    a, _, _ = build(fj, True)
    b, _, _ = build(ft, True)
    assert b.to_json() == a.to_json()
    assert sum(op.type == "recompute_segment"
               for op in b.global_block().ops) >= 2


def test_mlp_recompute_losses_match_jax_and_the_plain_run():
    """tests/test_parallel.py:248: 6 SGD steps with recompute equal the
    JAX package's recompute run and plain run and the port's plain
    run."""
    feed = _feeds_mlp()
    init, j_rec = _jax_losses(*_mlp(fj, True), feed, 6)
    _, j_plain = _jax_losses(*_mlp(fj, False), feed, 6)
    t_rec = _port_losses(*_mlp(ft, True), feed, 6, init)
    t_plain = _port_losses(*_mlp(ft, False), feed, 6, init)
    np.testing.assert_allclose(j_rec, j_plain, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_rec, j_rec, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t_rec, t_plain)


def test_bert_recompute_matches_jax_and_the_plain_run():
    """The tiny BERT checkpointed at each layer's output: 3 AdamW steps
    within 1e-4 of the JAX package's plain run, and equal to the port's
    plain run. A deliberate difference: the JAX package cannot run this
    program (a segment that reads token ids, an int input beside its
    floats, gets no gradients there, and the next grad op finds its
    input missing); the port differentiates each float input of a
    segment."""
    feed = _feeds_bert()
    init, j_plain = _jax_losses(*_bert(fj, False), feed, 3)
    with pytest.raises(KeyError, match="not materialised"):
        _jax_losses(*_bert(fj, True), feed, 1)
    t_rec = _port_losses(*_bert(ft, True), feed, 3, init)
    t_plain = _port_losses(*_bert(ft, False), feed, 3, init)
    np.testing.assert_allclose(t_rec, j_plain, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(t_rec, t_plain)


def test_recomputed_dropout_masks_equal_the_forward():
    """With dropout 0.1 inside the segments, recompute's losses and
    updated parameters equal the plain run's: each dropout op draws from
    its own generator (program seed, step, op id), so the mask the
    backward computes again is the forward's."""
    feed = _feeds_bert()
    out = []
    for rec in (True, False):
        main, startup, loss = _bert(ft, rec, dropout=0.1)
        scope = ft.Scope()
        exe = ft.Executor(ft.CPUPlace())
        exe.run(startup, scope=scope)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(3)]
        out.append((losses, scope.get_numpy("layer_0.ffn.fc1.w")))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


def test_a_var_inside_a_segment_is_fetchable():
    """expose_fetch_vars: a fetch made inside a segment becomes one of
    its outputs."""
    main, startup, loss = _mlp(ft, True)
    inner = [op for op in main.blocks[1].ops if op.type == "mul"][0]
    name = inner.outputs["Out"][0]
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    lv, h = exe.run(main, feed=_feeds_mlp(), fetch_list=[loss, name],
                    scope=scope)
    assert h.shape == (16, 32) and np.isfinite(h).all()


def test_recompute_plan_keeps_only_the_boundaries():
    """The memory planner prices recompute: the segments' inner
    activations are live only at their op and again at its grad op, so
    the planned device peak of the recompute program is below the plain
    program's."""
    from paddle_tpu_torch.analysis.memory import analyze_program_memory
    feed = {"tokens": ((4, 64), "int64"), "labels": ((4, 64), "int64")}
    peaks = {}
    for rec in (True, False):
        main, _, loss = _bert(ft, rec)
        plan = analyze_program_memory(main, feed_shapes=feed,
                                      fetch_names=[loss.name])
        peaks[rec] = plan.device_peak_bytes
        if rec:
            assert plan.device_charges["recompute_segments"] >= 0
            assert plan.device_charges["autograd_records"] == 0
    assert peaks[True] < peaks[False]


def test_pipeline_optimizer_records_cuts_and_forwards_minimize():
    """The JAX package's PipelineOptimizer records cut_list and forwards
    minimize; so does the port's: the program equals plain SGD's."""
    for f in (fj, ft):
        main, startup = f.Program(), f.Program()
        with f.program_guard(main, startup), f.unique_name.guard():
            x = f.layers.data("x", shape=[16], dtype="float32")
            h = f.layers.fc(x, size=8)
            loss = f.layers.mean(h)
            opt = f.optimizer.PipelineOptimizer(
                f.optimizer.SGD(0.1), cut_list=[[h]])
            opt.minimize(loss)
        assert opt.cut_list == [[h]]
        plain, s2 = f.Program(), f.Program()
        with f.program_guard(plain, s2), f.unique_name.guard():
            x = f.layers.data("x", shape=[16], dtype="float32")
            f.optimizer.SGD(0.1).minimize(f.layers.mean(
                f.layers.fc(x, size=8)))
        assert main.to_json() == plain.to_json()
