"""The models of the dense-layer slice on the CPU against the JAX package:
SE-ResNeXt, the book's word2vec and recommender, and the BERT-large and
Transformer-big configs.

- SE-ResNeXt at the JAX package's test size (tests/test_models.py:
  3x32x32, 10 classes, stages (1, 1), cardinality 4, base 32, Momentum lr
  0.01), batch 4, from the JAX startup carried over: programs byte-equal,
  then two steps: the losses, every parameter's step-1 gradient and its
  update after both steps. The model's dropout (0.2) is built with
  probability 0 for the steps, as the two frameworks draw other masks.
  Bars from tools/torch_rounding_sensitivity.py se_resnext (the JAX
  package's own readings under a 1e-6 change of the image: gradients
  1.1e-5, updates 6.6e-5, losses 3.4e-7; the port against it: 4.7e-6,
  1.5e-5 and 2.2e-7): losses 1e-5, gradients 1e-4, updates 3e-4 (each
  Frobenius gap over the norm).
- word2vec (dict 200, the book's widths) on the n-gram corpus of
  tests/test_models.py and the recommender (default table sizes) on the
  port's movielens reader through io.batch and DataFeeder
  (chip_smoke.movielens_batches, as [book_models] feeds it): three
  steps from the JAX startup, losses within 1e-5.
- bert_large() and transformer_big() have the JAX package's fields, and
  BERT-large's MLM training program at its full size (24 layers, d 1024,
  b16, T512, 80 masked positions, bf16 AMP; 365 M parameters, the LM
  head untied) is byte-equal, built but not run.
"""
import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu_torch.convert import scope_from_numpy
from torch_dense_helpers import chip_smoke

SE_BARS = {"loss": 1e-5, "grad": 1e-4, "update": 3e-4}


def _build(f, fn, seed=11):
    main, startup = f.Program(), f.Program()
    startup.random_seed = seed
    with f.program_guard(main, startup), f.unique_name.guard():
        out = fn(f)
    return main, startup, out


def _no_dropout(f, monkeypatch):
    drop = f.layers.dropout
    monkeypatch.setattr(f.layers, "dropout",
                        lambda x, dropout_prob, **kw: drop(x, 0.0, **kw))


def _se(f):
    from importlib import import_module
    mod = import_module(f"{f.__name__}.models.se_resnext")
    return mod.build_train(img_shape=(3, 32, 32), class_dim=10,
                           layers_per_stage=(1, 1), cardinality=4,
                           base_ch=32, lr=0.01)


def _fro(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(b))


def _steps(mj, sj, mt, fetch, feeds):
    """The JAX startup, then one run a feed in each package from it:
    ({startup values}, JAX fetches a step, port fetches a step, the JAX
    scope's and the port scope's values after)."""
    scope = fj.Scope()
    with fj.scope_guard(scope):
        exe = fj.Executor(fj.CPUPlace())
        exe.run(sj)
        init = {n: np.asarray(scope.get(n)) for n in scope.names()
                if scope.find_var(n) is not None}
        got_j = [[np.asarray(x) for x in exe.run(mj, feed=fd,
                                                 fetch_list=fetch)]
                 for fd in feeds]
        after_j = {n: np.asarray(scope.get(n)) for n in init}
    tscope = scope_from_numpy(init, ft.Scope(), ft.CPUPlace(), program=mt)
    exe_t = ft.Executor(ft.CPUPlace())
    got_t = [exe_t.run(mt, feed=fd, fetch_list=fetch, scope=tscope)
             for fd in feeds]
    after_t = {n: tscope.get_numpy(n) for n in init}
    return init, got_j, got_t, after_j, after_t


def test_se_resnext_programs_are_byte_equal():
    mj, sj, _ = _build(fj, _se)
    mt, st, _ = _build(ft, _se)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    types = {op.type for op in mt.global_block().ops}
    assert {"unsqueeze2", "conv2d", "dropout", "momentum"} <= types


def test_se_resnext_two_momentum_steps(monkeypatch):
    for f in (fj, ft):
        _no_dropout(f, monkeypatch)
    mj, sj, (lj, _) = _build(fj, _se)
    mt, st, _ = _build(ft, _se)
    assert mt.to_json() == mj.to_json()
    grouped = [op for op in mt.global_block().ops
               if op.type == "conv2d" and op.attrs["groups"] == 4]
    assert len(grouped) == 2
    rng = np.random.RandomState(0)
    feed = {"image": rng.randn(4, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    names = sorted(p.name for p in mt.all_parameters())
    fetch = [lj.name] + [f"{n}@GRAD" for n in names]
    init, got_j, got_t, after_j, after_t = _steps(mj, sj, mt, fetch,
                                                  [feed, feed])
    for j, t in zip(got_j, got_t):
        assert abs(float(t[0]) - float(j[0])) <= \
            SE_BARS["loss"] * abs(float(j[0]))
    assert float(got_t[1][0]) < float(got_t[0][0])
    grads = [_fro(t, j) for t, j in zip(got_t[0][1:], got_j[0][1:])]
    assert max(grads) <= SE_BARS["grad"], dict(zip(names, grads))
    ups = [_fro(after_t[n] - init[n], after_j[n] - init[n]) for n in names]
    assert max(ups) <= SE_BARS["update"], dict(zip(names, ups))


def _w2v(f):
    from importlib import import_module
    return import_module(f"{f.__name__}.models.word2vec").build_train(
        200, lr=0.05)


def test_word2vec_three_steps():
    mj, sj, (lj, names) = _build(fj, _w2v)
    mt, st, (_, names_t) = _build(ft, _w2v)
    assert mt.to_json() == mj.to_json() and st.to_json() == sj.to_json()
    assert names_t == names
    # the n-gram corpus of tests/test_models.py: next = sum of context
    rng = np.random.RandomState(0)
    ctx = rng.randint(0, 200, (256, 4)).astype(np.int64)
    nxt = (ctx.sum(axis=1) % 200).astype(np.int64)
    feeds = []
    for i in range(3):
        sl = slice(i * 64, (i + 1) * 64)
        fd = {n: ctx[sl, j:j + 1] for j, n in enumerate(names[:4])}
        fd["nextw"] = nxt[sl, None]
        feeds.append(fd)
    _, got_j, got_t, _, _ = _steps(mj, sj, mt, [lj.name], feeds)
    np.testing.assert_allclose([float(t[0]) for t in got_t],
                               [float(j[0]) for j in got_j], rtol=1e-5)


def _rec(f):
    from importlib import import_module
    return import_module(f"{f.__name__}.models.recommender").build_train(
        lr=0.05)


def test_recommender_three_steps_on_movielens():
    mj, sj, (lj, _, feeds_j) = _build(fj, _rec)
    mt, st, (_, _, feed_names) = _build(ft, _rec)
    assert mt.to_json() == mj.to_json() and st.to_json() == sj.to_json()
    assert feed_names == feeds_j
    feeds = chip_smoke.movielens_batches(ft, mt, feed_names, 32, 3)
    assert feeds[0]["category_id"].shape == (32, 4)
    assert feeds[0]["movie_title"].shape == (32, 8)
    assert feeds[0]["score"].dtype == np.float32
    _, got_j, got_t, _, _ = _steps(mj, sj, mt, [lj.name], feeds)
    np.testing.assert_allclose([float(t[0]) for t in got_t],
                               [float(j[0]) for j in got_j], rtol=1e-5)


@pytest.mark.parametrize("name", ["bert_large", "transformer_big"])
def test_config_fields_equal_jax(name):
    from paddle_tpu.models import transformer as tj
    from paddle_tpu_torch.models import transformer as tt
    for kw in ({}, {"dropout": 0.0, "use_flash": True, "n_layers": 2}):
        a, b = getattr(tj, name)(**kw), getattr(tt, name)(**kw)
        # the mesh axis names of the tp/sp hints included
        assert vars(b) == vars(a)


def test_bert_large_mlm_program_is_byte_equal():
    def build(f):
        from importlib import import_module
        tr = import_module(f"{f.__name__}.models.transformer")
        cfg = tr.bert_large(dropout=0.1, attn_dropout=0.0, use_flash=True)
        return tr.build_train_mlm(cfg, 16, 512, 80, amp=True)
    mj, sj, _ = _build(fj, build)
    mt, st, _ = _build(ft, build)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    ops = mt.global_block().ops
    assert sum(op.type == "flash_attention" for op in ops) == 24
    # 335 M as published, plus the untied LM head's 31.3 M
    n_params = sum(int(np.prod(p.shape)) for p in mt.all_parameters())
    assert 364e6 < n_params < 366e6
