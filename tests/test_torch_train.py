"""The training slice on the CPU: a small BERT (2 layers, d 64, 2 heads,
d_ff 128, vocab 100, batch 2, T 128, dropout 0, use_flash=True) built
and trained by both packages.

- The port's training programs (build_train and build_train_mlm, AMP off
  and on) serialize byte-identically to the JAX package's.
- From the JAX package's startup scope, carried over with
  convert.scope_from_numpy, 5 AdamW steps (lr 1e-3) give the same losses
  within rtol 1e-4, in float32 (measured gap ~2e-7) and under bf16 AMP,
  where the two frameworks round the bf16 products at different points
  (measured gap 6e-6 to 1.5e-5; one AdamW step moves the loss by ~7e-3).
- The step-1 gradients of every parameter match: in float32 within rtol
  1e-4, atol 1e-6 (products summed in different orders); under AMP each
  parameter's |g_port - g_jax| (Frobenius) within 2e-2 |g_jax| + 1e-6
  (measured worst 1.07e-2 |g_jax|; the attention key bias, whose exact
  gradient is 0, reads ~1e-7 of rounding noise).
- Under AMP the white-list ops really run in bf16: the casts' outputs
  and flash attention's output are bfloat16 tensors (a cast that did
  nothing would give losses within the tolerance above: bf16 AMP and
  float32 differ by 1e-5 to 3e-5 here).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.models import transformer as tj
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.models import transformer as tt

B, T, V, N_MASK, STEPS = 2, 128, 100, 16, 5
CONFIGS = [(mlm, amp) for mlm in (False, True) for amp in (False, True)]
CONFIG_IDS = [f"{'mlm' if m else 'lm'}-{'amp' if a else 'fp32'}"
              for m, a in CONFIGS]


def _build(f, tmod, mlm, amp):
    main, startup = f.Program(), f.Program()
    startup.random_seed = 11
    with f.program_guard(main, startup), f.unique_name.guard():
        cfg = tmod.bert_base(vocab_size=V, d_model=64, n_heads=2,
                             n_layers=2, d_ff=128, max_seq_len=T,
                             use_flash=True, dropout=0.0, attn_dropout=0.0)
        if mlm:
            loss, _ = tmod.build_train_mlm(cfg, B, T, N_MASK, lr=1e-3,
                                           amp=amp)
        else:
            loss, _ = tmod.build_train(cfg, B, T, lr=1e-3, amp=amp)
    return main, startup, loss


def _feed(mlm):
    rng = np.random.RandomState(0)
    toks = rng.randint(0, V, (B, T)).astype(np.int64)
    if not mlm:
        return {"tokens": toks, "labels": toks}
    pos = np.stack([rng.choice(T, N_MASK, replace=False) + i * T
                    for i in range(B)]).reshape(-1).astype(np.int32)
    return {"tokens": toks, "mask_pos": pos,
            "mask_label": toks.reshape(-1)[pos].reshape(-1, 1)}


@pytest.mark.parametrize("mlm,amp", CONFIGS, ids=CONFIG_IDS)
def test_training_programs_identical(mlm, amp):
    mj, sj, _ = _build(fj, tj, mlm, amp)
    mt, st, _ = _build(ft, tt, mlm, amp)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    assert mt.fingerprint() == mj.fingerprint()
    assert st.fingerprint() == sj.fingerprint()
    types = {op.type for op in mt.global_block().ops}
    assert {"grad::generic", "adamw", "fill_any_like"} <= types
    assert ("cast" in types) == amp and ("gather" in types) == mlm


@pytest.mark.parametrize("mlm,amp", CONFIGS, ids=CONFIG_IDS)
def test_losses_and_gradients_match_jax(mlm, amp):
    mj, sj, loss_j = _build(fj, tj, mlm, amp)
    mt, _, loss_t = _build(ft, tt, mlm, amp)
    scope_j = fj.Scope()
    with fj.scope_guard(scope_j):
        exe_j = fj.Executor(fj.CPUPlace())
        exe_j.run(sj)
    params = {n: np.asarray(scope_j.get(n)) for n in scope_j.names()
              if scope_j.find_var(n) is not None}
    scope_t = scope_from_numpy(params, ft.Scope(), ft.CPUPlace())
    exe_t = ft.Executor(ft.CPUPlace())
    pnames = sorted(p.name for p in mt.all_parameters())
    fetch = [loss_t.name] + [f"{p}@GRAD" for p in pnames]
    feed = _feed(mlm)
    losses_j, losses_t = [], []
    for step in range(STEPS):
        with fj.scope_guard(scope_j):
            out_j = exe_j.run(mj, feed=feed, fetch_list=fetch)
        out_t = exe_t.run(mt, feed=feed, fetch_list=fetch, scope=scope_t)
        losses_j.append(float(np.asarray(out_j[0])))
        losses_t.append(float(out_t[0]))
        if step == 0:
            for name, a, b in zip(fetch[1:], out_j[1:], out_t[1:]):
                a = np.asarray(a, np.float32)
                if not amp:
                    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6,
                                               err_msg=name)
                    continue
                gap = float(np.linalg.norm(b - a))
                assert gap <= 2e-2 * float(np.linalg.norm(a)) + 1e-6, \
                    (name, gap, float(np.linalg.norm(a)))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[-1] < losses_t[0]
    assert exe_t.cache_stats()["misses"] == 1


@pytest.mark.parametrize("mlm", [False, True], ids=["lm", "mlm"])
def test_amp_runs_white_list_ops_in_bf16(mlm):
    main, startup, loss = _build(ft, tt, mlm, True)
    ops = main.global_block().ops
    casts = [op.output("Out")[0] for op in ops
             if op.type == "cast" and op.attrs["out_dtype"] == "bfloat16"]
    flash = [op.output("Out")[0] for op in ops
             if op.type == "flash_attention"]
    assert casts and len(flash) == 2
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    out = exe.run(main, feed=_feed(mlm), fetch_list=[loss] + casts + flash,
                  scope=scope, return_numpy=False)
    assert out[0].dtype == torch.float32
    assert all(t.dtype == torch.bfloat16 for t in out[1:])


def test_unread_softmax_output_is_not_made():
    """The LM loss's softmax_with_cross_entropy never materializes its
    [rows, vocab] Softmax output unless a fetch names it; fetched, it
    is the softmax of the logits."""
    main, startup, loss = _build(ft, tt, False, False)
    ce = [op for op in main.global_block().ops
          if op.type == "softmax_with_cross_entropy"][0]
    sm_name = ce.output("Softmax")[0]
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    plain = exe._prepare(main, main.global_block(), scope, [loss.name])
    assert sm_name in plain.unread[ce.id]
    fetched = exe._prepare(main, main.global_block(), scope,
                           [loss.name, sm_name])
    assert ce.id not in fetched.unread
    sm, = exe.run(main, feed=_feed(False), fetch_list=[sm_name],
                  scope=scope)
    assert sm.shape == (B * T, V)
    np.testing.assert_allclose(sm.sum(-1), 1.0, rtol=1e-5)


def test_startup_then_train_on_cpu():
    """The port's own startup program, then training steps on the same
    Scope: the parameters it makes must be tensors that autograd and the
    in-place AdamW update accept."""
    main, startup, loss = _build(ft, tt, False, False)
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    w0 = scope.get_numpy("word_emb")
    losses = [float(exe.run(main, feed=_feed(False), fetch_list=[loss],
                            scope=scope)[0]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert not scope.get("word_emb").is_inference()
    assert not np.array_equal(scope.get_numpy("word_emb"), w0)
    assert float(scope.get_numpy("word_emb_beta1_pow_0")[0]) == \
        pytest.approx(0.9 ** 4)


def test_predictor_runs_under_inference_mode(tmp_path):
    """A program that writes no state and holds no grad op (what a
    predictor serves) still runs under inference_mode; a training
    program's for-test clone does too."""
    main, startup, loss = _build(ft, tt, False, False)
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    head = [op for op in main.global_block().ops
            if op.type == "mul" and op.input("Y") == ["lm_head.w"]][0]
    hidden = main.global_block().var(head.input("X")[0])
    with ft.scope_guard(scope):
        ft.io.save_inference_model(str(tmp_path), ["tokens"], [hidden], exe,
                                   main_program=main)
    cfg = ft.inference.AnalysisConfig(str(tmp_path))
    cfg.disable_gpu()
    pred = ft.inference.create_paddle_predictor(cfg)
    toks = _feed(False)["tokens"]
    out = pred._exe.run(pred.program(), feed={"tokens": toks},
                        fetch_list=pred.get_output_names(),
                        scope=pred._scope, return_numpy=False)[0]
    assert out.is_inference() and out.shape == (B, T, 64)
    np.testing.assert_allclose(pred.run_dict({"tokens": toks})[0],
                               out.numpy(), atol=0)
    test_prog = main.clone(for_test=True)
    got = exe.run(test_prog, feed=_feed(False), fetch_list=[loss],
                  scope=scope, return_numpy=False)[0]
    assert got.is_inference()


def test_grad_op_without_its_forward_record_raises():
    """A grad op whose forward op left no record (it did not run in the
    same block, under the executor's recording) raises instead of
    recomputing the forward."""
    from paddle_tpu_torch.core import lowering
    main, _, _ = _build(ft, tt, False, False)
    block = main.global_block()
    op = [op for op in block.ops if op.type == "grad::generic"][-1]
    env = {n: torch.zeros([max(d, 1) for d in block.var(n).shape])
           for n in op.input_names() if n}
    with pytest.raises(RuntimeError, match="left no autograd record"):
        lowering.run_op(op, env, lowering.LowerCtx("cpu"))


def test_fetch_gradient_var_and_optimizer_ops_not_differentiated():
    from paddle_tpu_torch.core.registry import REGISTRY
    assert REGISTRY.get("adamw").inplace
    assert not REGISTRY.get("mul").inplace
    main, startup, loss = _build(ft, tt, False, False)
    fwd_ids = {op.attrs["fwd_id"] for op in main.global_block().ops
               if op.type == "grad::generic"}
    adamw_ids = {op.id for op in main.global_block().ops
                 if op.type == "adamw"}
    assert adamw_ids and not fwd_ids & adamw_ids
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    g, = exe.run(main, feed=_feed(False), fetch_list=["lm_head.w@GRAD"],
                 scope=scope, return_numpy=False)
    assert g.shape == (64, V) and not g.requires_grad
    assert torch.isfinite(g).all() and g.abs().max() > 0
