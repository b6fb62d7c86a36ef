"""chip_smoke's dygraph models at a narrow width, trained eagerly in both
packages from the JAX package's weights.

- make_dygraph_bert at 2 layers, d 64, 2 heads of 32, FFN 128, vocab 97,
  T 64, batch 2, dropout 0: three steps of BERT's eager recipe
  (chip_smoke.dygraph_bert_opt: AdamW with a PolynomialDecay, under the
  global-norm clip of 1.0).
- make_dygraph_resnet with one bottleneck a stage, 10 classes, batch 4
  at 3x32x32: three steps of the eager ResNet recipe (Momentum 0.9, L2
  decay 1e-4, a PiecewiseDecay of 0.1 and 0.01 at step 2).

The port's model takes the JAX package's state dict through
convert.layer_from_numpy. BERT runs its three steps free in each
package: each step's loss, every parameter's gradient and update, within
rtol 1e-4, atol 1e-6 (the float32 bar of tests/test_torch_train.py).

The ResNet at random init amplifies rounding, as tests/test_torch_resnet.py
found for the static graph: moving each of the JAX package's weights by
1e-5 of itself moves its own gradients by up to 2.5% of their norm at
step 1, 11% at step 2 and 46% at step 3 (Frobenius, per parameter;
measured on the CPU), and even at step 1 the two packages' gradients
part elementwise beyond rtol 1e-4 / atol 1e-6 in 48 of 161 parameters
while their Frobenius gaps stay within 8.4e-5 (three seeds). So each
port step starts from the JAX package's state before it (parameters,
running statistics, velocities), and the bars are each step's loss
within rtol 1e-4 and every gradient, update and running statistic
within 1e-3 of its norm (Frobenius; [train_cpu_check]'s float32
gradient bar in chip_smoke.py, RECIPE_GRAD_RTOL).
"""
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu.dygraph as jdg
import paddle_tpu_torch as ft
import paddle_tpu_torch.dygraph as tdg
from paddle_tpu_torch.convert import layer_from_numpy
from paddle_tpu_torch.models import transformer

RTOL, ATOL = 1e-4, 1e-6
FRO = 1e-3
STEPS = 3


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
CFG = transformer.bert_base(n_layers=2, d_model=64, n_heads=2, d_ff=128,
                            vocab_size=97, max_seq_len=64, dropout=0.0,
                            attn_dropout=0.0)


def _bert(fluid, dg):
    model = SMOKE.make_dygraph_bert(dg, fluid.layers, CFG)
    return model, SMOKE.dygraph_bert_opt(fluid, dg)


def _resnet(fluid, dg):
    model = SMOKE.make_dygraph_resnet(dg, fluid.layers, 10, (1, 1, 1, 1))
    opt = fluid.optimizer.Momentum(
        learning_rate=dg.PiecewiseDecay([2], [0.1, 0.01]), momentum=0.9,
        regularization=fluid.regularizer.L2Decay(1e-4))
    return model, opt


def _inputs(name):
    rng = np.random.RandomState(0)
    if name == "bert":
        toks = rng.randint(0, CFG.vocab_size, (2, 64)).astype(np.int64)
        return toks, toks.reshape(-1, 1)
    return (rng.rand(4, 3, 32, 32).astype(np.float32),
            rng.randint(0, 10, (4, 1)).astype(np.int64))


def _velocities(model, opt):
    """{structured name: velocity as numpy} of a Momentum optimizer."""
    state = getattr(opt, "_dy_state", {})
    return {n: np.asarray(state[p.name]["velocity"])
            for n, p in model.named_parameters() if p.name in state}


def _train(pkg, name, state, restarts=None):
    """STEPS eager steps of model `name` in package `pkg` from `state`
    (None: the model's own). With `restarts` (the JAX package's
    [(state, velocities)] before each step), each step starts from it.
    Returns (the start state, [(loss, gradients, updates)], [(state,
    velocities)] before each step)."""
    import torch
    fluid, dg, place = {"jax": (fj, jdg, None),
                        "port": (ft, tdg, ft.CPUPlace())}[pkg]
    arrays = _inputs(name)
    out, before_steps = [], []
    with dg.guard(place), SMOKE.GlobalNormClip(fluid, 1.0):
        model, opt = (_bert if name == "bert" else _resnet)(fluid, dg)
        xs = [dg.to_variable(a) for a in arrays]
        if name == "resnet":
            with dg.no_grad():
                model(*xs)  # FC's weights are made on the first call
        if state is None:
            state = model.state_dict()
        else:
            layer_from_numpy(state, model)
        for step in range(STEPS):
            if restarts and step:
                start, vel = restarts[step]
                layer_from_numpy(start, model)
                params = dict(model.named_parameters())
                opt._dy_state = {params[n].name: {
                    "velocity": torch.from_numpy(v.copy())}
                    for n, v in vel.items()}
            before = model.state_dict()
            before_steps.append((before, _velocities(model, opt)
                                 if name == "resnet" else {}))
            loss = model(*xs)
            loss.backward()
            grads = {n: p.gradient() for n, p in model.named_parameters()
                     if p.trainable}
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
            after = model.state_dict()
            out.append((float(loss.numpy()), grads,
                        {n: after[n] - before[n] for n in after}))
    return state, out, before_steps


def _fro(a, b):
    nb = np.linalg.norm(b)
    return np.linalg.norm(a - b) / nb if nb else float(np.any(a))


@pytest.mark.parametrize("name", ["bert", "resnet"])
def test_eager_training_matches_jax(name):
    np.random.seed(0)  # the JAX package draws its weights from numpy's
    state, want, starts = _train("jax", name, None)
    _, got, _ = _train("port", name, state,
                       starts if name == "resnet" else None)
    for step, ((gl, gg, gu), (wl, wg, wu)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(gl, wl, rtol=RTOL, err_msg=f"step {step}")
        assert set(gg) == set(wg) and set(gu) == set(wu)
        for kind, g, w in (("grad", gg, wg), ("update", gu, wu)):
            for k in w:
                if name == "bert":
                    np.testing.assert_allclose(
                        g[k], w[k], rtol=RTOL, atol=ATOL,
                        err_msg=f"step {step} {kind} {k}")
                else:
                    assert _fro(g[k], w[k]) <= FRO, (step, kind, k,
                                                     _fro(g[k], w[k]))
