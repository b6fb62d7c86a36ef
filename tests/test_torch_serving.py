"""The serving slice end to end on the CPU: a tiny BERT (2 layers, d 32,
T 128, use_flash=True) saved by one package and served by the other.

Tolerance atol 1e-4 between the packages' float32 outputs (two layers of
products and layer norms summed in different orders).
"""
import os
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.models import transformer as tj
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.models import transformer as tt
from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention
from paddle_tpu_torch.serving import EngineConfig, ServingEngine

T = 128
ATOL = 1e-4


def _build(f, tmod):
    main, startup = f.Program(), f.Program()
    startup.random_seed = 7
    with f.program_guard(main, startup), f.unique_name.guard():
        cfg = tmod.bert_base(vocab_size=60, d_model=32, n_heads=2,
                             n_layers=2, d_ff=64, max_seq_len=T,
                             use_flash=True, dropout=0.1, attn_dropout=0.0)
        tok = f.layers.data("tokens", shape=[T], dtype="int64")
        hidden = tmod.encoder(tok, cfg)
    return main, startup, hidden


@pytest.fixture(scope="module")
def jax_model_dir():
    """A tiny encoder initialised and saved by paddle_tpu."""
    with tempfile.TemporaryDirectory() as d:
        main, startup, hidden = _build(fj, tj)
        scope = fj.Scope()
        with fj.scope_guard(scope):
            exe = fj.Executor(fj.CPUPlace())
            exe.run(startup)
            fj.io.save_inference_model(d, ["tokens"], [hidden], exe,
                                       main_program=main)
        params = {n: np.asarray(scope.get(n)) for n in scope.names()
                  if scope.find_var(n) is not None}
        yield d, main, params


def _tokens(rows, seed=0):
    return np.random.RandomState(seed).randint(0, 60, (rows, T)) \
        .astype(np.int64)


def _cpu_predictor(d):
    cfg = ft.inference.AnalysisConfig(d)
    cfg.disable_gpu()
    return ft.inference.create_paddle_predictor(cfg)


def test_jax_saved_model_serves_in_the_port(jax_model_dir):
    d, _, _ = jax_model_dir
    toks = _tokens(3)
    want = fj.inference.create_paddle_predictor(
        fj.inference.AnalysisConfig(d)).run_dict({"tokens": toks})[0]
    pred = _cpu_predictor(d)
    got = pred.run_dict({"tokens": toks})[0]
    assert got.shape == (3, T, 32)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    # the PaddleTensor path answers the same
    out = pred.run([ft.inference.PaddleTensor(toks, "tokens")])
    np.testing.assert_allclose(out[0].as_ndarray(), got, atol=0)


def test_scope_from_numpy_carries_the_weights(jax_model_dir):
    """The JAX package's parameters, as numpy, into a port scope under
    the same names: the port's own program then answers as the JAX
    predictor does."""
    d, _, params = jax_model_dir
    main, _, hidden = _build(ft, tt)
    infer = main.clone(for_test=True)
    scope = scope_from_numpy(params, ft.Scope(), ft.CPUPlace())
    exe = ft.Executor(ft.CPUPlace())
    toks = _tokens(2, seed=1)
    got = exe.run(infer, feed={"tokens": toks}, fetch_list=[hidden],
                  scope=scope)[0]
    want = fj.inference.create_paddle_predictor(
        fj.inference.AnalysisConfig(d)).run_dict({"tokens": toks})[0]
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_port_saved_model_serves_in_jax():
    """The other direction of the shared on-disk format."""
    main, startup, hidden = _build(ft, tt)
    with tempfile.TemporaryDirectory() as d:
        scope = ft.Scope()
        with ft.scope_guard(scope):
            exe = ft.Executor(ft.CPUPlace())
            exe.run(startup)
            ft.io.save_inference_model(d, ["tokens"], [hidden], exe,
                                       main_program=main)
        assert os.path.exists(os.path.join(d, "__model__.json"))
        toks = _tokens(2, seed=2)
        got = _cpu_predictor(d).run_dict({"tokens": toks})[0]
        want = fj.inference.create_paddle_predictor(
            fj.inference.AnalysisConfig(d)).run_dict({"tokens": toks})[0]
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_startup_is_reproducible_per_seed():
    def init(seed):
        _, startup, _ = _build(ft, tt)
        startup.random_seed = seed
        scope = ft.Scope()
        ft.Executor(ft.CPUPlace()).run(startup, scope=scope)
        return scope.get_numpy("layer_0.att.q.w")
    a, b, c = init(3), init(3), init(4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert abs(a.std() - 0.02) < 0.002  # Normal(0, 0.02)


def test_engine_answers_concurrent_requests(jax_model_dir):
    d, _, _ = jax_model_dir
    pred = _cpu_predictor(d)
    engine = ServingEngine(EngineConfig(max_batch_size=4,
                                        default_timeout_ms=30000),
                           predictor=pred)
    engine.start()
    warm = engine.cache_stats()
    assert warm["misses"] == len(engine.warmup_shapes()) == 3
    reqs = [_tokens(1 + i % 3, seed=10 + i) for i in range(8)]
    answers = [None] * len(reqs)

    def client(i):
        answers[i] = engine.predict({"tokens": reqs[i]})[0]

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    launches = flash_attention.launches
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    engine.stop()
    assert engine.batches >= 1
    assert engine.cache_stats()["misses"] == warm["misses"]
    assert flash_attention.launches == launches  # CPU: no kernel
    direct = pred.clone()
    for x, y in zip(reqs, answers):
        np.testing.assert_allclose(y, direct.run_dict({"tokens": x})[0],
                                   atol=1e-5)


def test_engine_rejects_after_stop(jax_model_dir):
    from paddle_tpu_torch.serving import EngineClosedError
    d, _, _ = jax_model_dir
    engine = ServingEngine(EngineConfig(max_batch_size=2),
                           predictor=_cpu_predictor(d)).start()
    engine.stop()
    with pytest.raises(EngineClosedError):
        engine.submit({"tokens": _tokens(1)})


def test_executor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default place resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ft.inference.create_paddle_predictor(
            ft.inference.AnalysisConfig("unused"))


def test_state_on_another_device_is_refused():
    main, startup, hidden = _build(ft, tt)
    scope = ft.Scope()
    ft.Executor(ft.CPUPlace()).run(startup, scope=scope)
    scope.set("word_emb", scope.get_numpy("word_emb"))  # host numpy
    with pytest.raises(RuntimeError, match="word_emb"):
        ft.Executor(ft.CPUPlace()).run(
            main.clone(for_test=True), feed={"tokens": _tokens(1)},
            fetch_list=[hidden], scope=scope)


def test_scope_from_numpy_reads_bfloat16_bit_for_bit():
    """A bfloat16 array as the JAX package hands it over (ml_dtypes)
    becomes a torch.bfloat16 tensor with the same bits."""
    vals = np.array([1.0, -2.5, 3.140625, 1e-3], np.float32)
    arr = np.asarray(jax.numpy.asarray(vals, jax.numpy.bfloat16))
    scope = scope_from_numpy({"w": arr}, ft.Scope(), ft.CPUPlace())
    t = scope.get("w")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  arr.astype(np.float32))
    assert scope.get_numpy("w").dtype == np.float32
