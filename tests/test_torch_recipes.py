"""The training recipes end to end on the CPU, the port against the JAX
package.

- tests/test_torch_train.py's small BERT (2 layers, d 64, 2 heads, d_ff
  128, vocab 100, batch 2, T 128, MLM with 16 masked positions, dropout
  0) under two recipes with GradientClipByGlobalNorm(1.0): AdamW (weight
  decay 0.01, epsilon 1e-6) with a linear warmup over 3 steps into a
  linear decay, and Lamb (weight decay 0.01) with the same schedule; in
  float32 and bf16 AMP. Programs byte-identical; from the JAX startup
  values, 5 steps whose rates cross the end of warmup give the same
  learning rates (1e-6 relative), losses within that file's rtol 1e-4
  and global norms within 1e-4 (AMP: the losses and norms at its AMP
  bars, 1e-4 and 2e-2).
- LeNet (models/lenet.py convolutional_neural_network) under Momentum
  0.9 with L2Decay(5e-4) and piecewise_decay across two boundaries:
  5 steps' losses within tests/test_torch_lenet.py's rtol 1e-5 and the
  parameters after them within 1e-5 of max(1, max|reference|).
- chip_smoke.py's recipe programs (_build_bert_recipe for both recipes,
  _build_resnet_recipe) at a small width serialize byte-identically to
  the same calls through the JAX package.
"""
import functools
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.models import lenet as lj
from paddle_tpu.models import transformer as tj
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.models import lenet as lt
from paddle_tpu_torch.models import transformer as tt

B, T, V, N_MASK, STEPS = 2, 128, 100, 16, 5
FIRST_STEP = 1  # warmup over 3 steps: steps 1-5 cross its end at 3


@pytest.fixture(autouse=True)
def _no_clip_leak():
    yield
    fj.clip.set_gradient_clip(None)
    ft.clip.set_gradient_clip(None)


def _schedule(L, lr):
    return L.linear_lr_warmup(
        L.polynomial_decay(lr, decay_steps=20, end_learning_rate=0.0,
                           power=1.0), warmup_steps=3, start_lr=0.0,
        end_lr=lr)


def _build_bert(f, tmod, recipe, amp):
    opt_cls = {"adamw": functools.partial(f.optimizer.AdamW,
                                          weight_decay=0.01, epsilon=1e-6),
               "lamb": functools.partial(f.optimizer.Lamb,
                                         lamb_weight_decay=0.01)}[recipe]
    main, startup = f.Program(), f.Program()
    startup.random_seed = 11
    f.clip.set_gradient_clip(f.clip.GradientClipByGlobalNorm(1.0))
    try:
        with f.program_guard(main, startup), f.unique_name.guard():
            cfg = tmod.bert_base(vocab_size=V, d_model=64, n_heads=2,
                                 n_layers=2, d_ff=128, max_seq_len=T,
                                 use_flash=True, dropout=0.0,
                                 attn_dropout=0.0)
            lr = _schedule(f.layers, 1e-3 if recipe == "adamw" else 1e-2)
            loss, _ = tmod.build_train_mlm(cfg, B, T, N_MASK, lr=lr,
                                           optimizer_cls=opt_cls, amp=amp)
    finally:
        f.clip.set_gradient_clip(None)
    ops = main.global_block().ops
    norm = [op for op in ops if op.type == "sqrt"][-1].output("Out")[0]
    return main, startup, loss, lr, norm


def _feed():
    rng = np.random.RandomState(0)
    toks = rng.randint(0, V, (B, T)).astype(np.int64)
    pos = np.stack([rng.choice(T, N_MASK, replace=False) + i * T
                    for i in range(B)]).reshape(-1).astype(np.int32)
    return {"tokens": toks, "mask_pos": pos,
            "mask_label": toks.reshape(-1)[pos].reshape(-1, 1)}


def _jax_values(startup):
    scope = fj.Scope()
    with fj.scope_guard(scope):
        fj.Executor(fj.CPUPlace()).run(startup)
    return scope, {n: np.asarray(scope.get(n)) for n in scope.names()
                   if scope.find_var(n) is not None}


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
@pytest.mark.parametrize("recipe", ["adamw", "lamb"])
def test_bert_recipe_matches_jax(recipe, amp):
    mj, sj, lj_, lrj, nj = _build_bert(fj, tj, recipe, amp)
    mt, st, lt_, lrt, nt = _build_bert(ft, tt, recipe, amp)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    assert nt == nj
    scope_j, values = _jax_values(sj)
    scope_t = scope_from_numpy(values, ft.Scope(), ft.CPUPlace(),
                               program=mt)
    exe_j, exe_t = fj.Executor(fj.CPUPlace()), ft.Executor(ft.CPUPlace())
    feed = _feed()
    got, want = [], []
    for _ in range(STEPS):
        with fj.scope_guard(scope_j):
            want.append([float(np.asarray(x).reshape(-1)[0]) for x in
                         exe_j.run(mj, feed=feed,
                                   fetch_list=[lj_.name, lrj.name, nj])])
        got.append([float(np.asarray(x).reshape(-1)[0]) for x in
                    exe_t.run(mt, feed=feed,
                              fetch_list=[lt_.name, lrt.name, nt],
                              scope=scope_t)])
    got, want = np.array(got), np.array(want)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    np.testing.assert_allclose(got[:, 2], want[:, 2],
                               rtol=2e-2 if amp else 1e-4)
    assert got[2, 1] == pytest.approx(
        0.5 * (1.0 + (1 - 3 / 20)) * (1e-3 if recipe == "adamw" else 1e-2),
        rel=1e-6)  # the 0.5 blend at the end of warmup
    assert got[-1, 0] < got[0, 0]
    assert exe_t.cache_stats()["misses"] == 1


def _build_lenet(f, mod):
    main, startup = f.Program(), f.Program()
    startup.random_seed = 5
    with f.program_guard(main, startup), f.unique_name.guard():
        img = f.layers.data("img", shape=[1, 28, 28], dtype="float32")
        label = f.layers.data("label", shape=[1], dtype="int64")
        loss, predict = mod.convolutional_neural_network(img, label)
        f.layers.accuracy(predict, label)
        lr = f.layers.piecewise_decay([2, 4], [0.01, 0.005, 0.001])
        f.optimizer.Momentum(
            lr, 0.9, regularization=f.regularizer.L2Decay(5e-4)).minimize(
                loss)
    return main, startup, loss, lr


def test_lenet_l2_decay_piecewise_matches_jax():
    mj, sj, loss_j, lr_j = _build_lenet(fj, lj)
    mt, st, loss_t, lr_t = _build_lenet(ft, lt)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    scope_j, values = _jax_values(sj)
    scope_t = scope_from_numpy(values, ft.Scope(), ft.CPUPlace(),
                               program=mt)
    exe_j, exe_t = fj.Executor(fj.CPUPlace()), ft.Executor(ft.CPUPlace())
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(32, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (32, 1)).astype(np.int64)}
    losses_j, losses_t, lrs = [], [], []
    for _ in range(5):
        with fj.scope_guard(scope_j):
            oj = exe_j.run(mj, feed=feed, fetch_list=[loss_j, lr_j])
        ot = exe_t.run(mt, feed=feed, fetch_list=[loss_t.name, lr_t.name],
                       scope=scope_t)
        losses_j.append(float(np.asarray(oj[0])))
        losses_t.append(float(ot[0]))
        lrs.append(float(ot[1][0]))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    np.testing.assert_allclose(lrs, [0.01, 0.0075, 0.005, 0.003, 0.001],
                               rtol=1e-6)
    for p in mt.all_parameters():
        want = np.asarray(scope_j.get(p.name))
        np.testing.assert_allclose(
            scope_t.get_numpy(p.name), want, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=p.name)


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_recipes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_recipe_programs_match_jax():
    """The card's recipe programs, built by chip_smoke.py's builders at a
    small width (T 64, 8 masked positions; ResNet-50 at 3x32x32, 10
    classes), against the same calls through the JAX package; the clip
    is None after each build."""
    smoke = _chip_smoke()
    smoke.T, smoke.N_MASK = 64, 8
    smoke.RESNET_IMAGE, smoke.RESNET_CLASSES = (3, 32, 32), 10

    def cfg(mod):
        return mod.bert_base(vocab_size=V, d_model=64, n_heads=2,
                             n_layers=2, d_ff=128, max_seq_len=64,
                             use_flash=True, dropout=0.1, attn_dropout=0.0)

    for name in ("bert", "lamb"):
        recipe = smoke.RECIPES[name]
        mt, st, _, _, norm, clipped = smoke._build_bert_recipe(
            ft, tt, cfg(tt), 2, True, name)
        assert ft.clip.get_gradient_clip() is None
        opt = fj.optimizer
        opt_cls = (functools.partial(opt.Lamb, lamb_weight_decay=0.01)
                   if name == "lamb" else functools.partial(
                       opt.AdamW, weight_decay=0.01, epsilon=1e-6))
        mj, sj = fj.Program(), fj.Program()
        sj.random_seed = smoke.SEED
        fj.clip.set_gradient_clip(fj.clip.GradientClipByGlobalNorm(1.0))
        with fj.program_guard(mj, sj), fj.unique_name.guard():
            L = fj.layers
            lr = L.linear_lr_warmup(L.polynomial_decay(
                recipe["lr"], decay_steps=recipe["decay_steps"],
                end_learning_rate=0.0, power=recipe["power"]),
                warmup_steps=recipe["warmup"], start_lr=0.0,
                end_lr=recipe["lr"])
            tj.build_train_mlm(cfg(tj), 2, 64, 8, lr=lr,
                               optimizer_cls=opt_cls, amp=True)
        fj.clip.set_gradient_clip(None)
        assert mt.to_json() == mj.to_json(), name
        assert st.to_json() == sj.to_json(), name
        assert len(clipped) == len(mt.all_parameters())
    from paddle_tpu.contrib import mixed_precision as mpj
    from paddle_tpu.models import resnet as rj
    mt, st, _, _ = smoke._build_resnet_recipe(ft, True)
    recipe = smoke.RECIPES["resnet"]
    mj, sj = fj.Program(), fj.Program()
    sj.random_seed = smoke.SEED
    with fj.program_guard(mj, sj), fj.unique_name.guard():
        L = fj.layers
        img = L.data("image", shape=[3, 32, 32], dtype="float32")
        label = L.data("label", shape=[1], dtype="int64")
        logits = rj.resnet(img, 10, 50)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        L.accuracy(L.softmax(logits), label)
        lr = L.piecewise_decay(recipe["boundaries"], recipe["values"])
        mpj.decorate(fj.optimizer.Momentum(
            learning_rate=lr, momentum=0.9,
            regularization=fj.regularizer.L2Decay(1e-4))).minimize(loss)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    assert recipe["boundaries"] == [150150, 300300, 450450]
