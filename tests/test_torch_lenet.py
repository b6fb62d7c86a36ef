"""The three MNIST nets of the Fluid book (models/lenet.py:
softmax_regression, multilayer_perceptron, convolutional_neural_network)
trained on the CPU by both packages, under SGD, Momentum and Adam.

- The training programs (net, cross_entropy loss, accuracy, optimizer)
  and their startups serialize byte-identically to the JAX package's.
- From the JAX package's startup scope, carried over with
  convert.scope_from_numpy, 5 steps on one seeded batch of 32 images
  [1, 28, 28] (lr 1e-3; Momentum 0.9) give the same losses within rtol
  1e-5 (measured at most 2.1e-7) and the same accuracies, and the loss
  falls in every case.
"""
import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.models import lenet as lj
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.models import lenet as lt

NETS = ["softmax_regression", "multilayer_perceptron",
        "convolutional_neural_network"]
OPTIMIZERS = ["SGD", "Momentum", "Adam"]
B, STEPS, LR = 32, 5, 1e-3


def _build(f, mod, net, optimizer):
    main, startup = f.Program(), f.Program()
    startup.random_seed = 5
    with f.program_guard(main, startup), f.unique_name.guard():
        img = f.layers.data("img", shape=[1, 28, 28], dtype="float32")
        label = f.layers.data("label", shape=[1], dtype="int64")
        loss, predict = getattr(mod, net)(img, label)
        acc = f.layers.accuracy(predict, label)
        cls = getattr(f.optimizer, optimizer)
        opt = cls(LR, 0.9) if optimizer == "Momentum" else cls(LR)
        opt.minimize(loss)
    return main, startup, loss, acc


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("net", NETS)
def test_lenet_matches_jax(net, optimizer):
    mj, sj, loss_j, acc_j = _build(fj, lj, net, optimizer)
    mt, st, loss_t, acc_t = _build(ft, lt, net, optimizer)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    types = {op.type for op in mt.global_block().ops}
    assert {optimizer.lower(), "cross_entropy", "top_k", "accuracy"} <= \
        types
    assert ("conv2d" in types) == ("conv" in net)
    assert ("tanh" in types) == (net == "multilayer_perceptron")
    scope_j = fj.Scope()
    with fj.scope_guard(scope_j):
        exe_j = fj.Executor(fj.CPUPlace())
        exe_j.run(sj)
    params = {n: np.asarray(scope_j.get(n)) for n in scope_j.names()
              if scope_j.find_var(n) is not None}
    scope_t = scope_from_numpy(params, ft.Scope(), ft.CPUPlace())
    exe_t = ft.Executor(ft.CPUPlace())
    rng = np.random.RandomState(3)
    feed = {"img": rng.rand(B, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (B, 1)).astype(np.int64)}
    got_j, got_t = [], []
    for _ in range(STEPS):
        with fj.scope_guard(scope_j):
            out = exe_j.run(mj, feed=feed, fetch_list=[loss_j, acc_j])
        got_j.append([float(np.asarray(x).reshape(-1)[0]) for x in out])
        out = exe_t.run(mt, feed=feed, fetch_list=[loss_t, acc_t],
                        scope=scope_t)
        got_t.append([float(x.reshape(-1)[0]) for x in out])
    got_j, got_t = np.array(got_j), np.array(got_t)
    np.testing.assert_allclose(got_t[:, 0], got_j[:, 0], rtol=1e-5)
    np.testing.assert_array_equal(got_t[:, 1], got_j[:, 1])
    assert got_t[-1, 0] < got_t[0, 0]
