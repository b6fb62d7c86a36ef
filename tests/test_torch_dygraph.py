"""The port's dygraph against the JAX package's on the CPU.

Each case runs the same eager code through both packages (guard,
to_variable, Layer, backward, the eager optimizers), the port's layers
taking the JAX package's weights through convert.layer_from_numpy, and
compares what the caller sees. Float32 values and gradients within rtol
1e-5, atol 1e-6 (the two sum in other orders); weights after 25 eager
optimizer steps within rtol 1e-4, atol 1e-6 (the float32 bar of
tests/test_torch_train.py).

Also the three faults of the JAX package's dygraph that the port
repairs, each shown in both (ROADMAP §C): save_dygraph / load_dygraph
do not round-trip; TracedLayer freezes an op on its input alone; the
tape keeps every step's activations alive. And the port's in-place
eager update, pinned: a backward through a graph recorded before an
update raises.
"""
import gc
import weakref

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu.dygraph as jdg
import paddle_tpu_torch as ft
import paddle_tpu_torch.dygraph as tdg
from paddle_tpu_torch.convert import layer_from_numpy

RTOL, ATOL = 1e-5, 1e-6
TRAIN_RTOL = 1e-4
CPU = ft.CPUPlace()
PKGS = {"jax": (fj, jdg, None), "port": (ft, tdg, CPU)}


def _close(a, b, rtol=RTOL, atol=ATOL):
    if a is None or b is None:
        assert a is None and b is None, (a, b)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                               rtol=rtol, atol=atol)


def _linear_state(shape_in, shape_out, seed=0):
    rng = np.random.RandomState(seed)
    return {"weight": rng.randn(shape_in, shape_out).astype(np.float32),
            "bias": rng.randn(shape_out).astype(np.float32)}


def _carry(pkg, state, layer):
    if pkg == "port":
        layer_from_numpy(state, layer)
    else:
        layer.set_dict(state)


def test_dygraph_names_resolve_in_the_port():
    for name in jdg.__all__:
        assert hasattr(tdg, name), name
    for name in jdg.nn.__all__:
        assert hasattr(tdg.nn, name), name
    for mod in ("base", "layers", "nn", "checkpoint", "jit", "parallel",
                "learning_rate_scheduler"):
        assert hasattr(tdg, mod) or __import__(
            f"paddle_tpu_torch.dygraph.{mod}"), mod


def test_in_dygraph_mode():
    assert not ft.in_dygraph_mode() and not fj.in_dygraph_mode()
    with tdg.guard(CPU), jdg.guard():
        assert ft.in_dygraph_mode() and fj.in_dygraph_mode()
        assert ft.framework.in_dygraph_mode()
    assert not ft.in_dygraph_mode()


def test_guard_defaults_to_the_card():
    """No place means CUDAPlace(0), which raises where there is none."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDAPlace"):
        with tdg.guard():
            pass


# -- VarBase sugar and reductions -----------------------------------------

SUGAR = {
    "add": lambda a, b, c: a + b,
    "add_scalar": lambda a, b, c: a + 2.0,
    "radd": lambda a, b, c: 3.0 + a,
    "sub": lambda a, b, c: a - b,
    "rsub": lambda a, b, c: 1.5 - a,
    "mul": lambda a, b, c: a * b,
    "rmul": lambda a, b, c: 2.0 * a,
    "div": lambda a, b, c: a / b,
    "rdiv": lambda a, b, c: 2.0 / b,
    "pow": lambda a, b, c: a ** 3,
    "neg": lambda a, b, c: -a,
    "matmul": lambda a, b, c: a @ c,
    "mean": lambda a, b, c: a.mean(),
    "mean_dim": lambda a, b, c: a.mean(dim=[1]),
    "sum": lambda a, b, c: a.sum(),
    "sum_keep": lambda a, b, c: a.sum(dim=[0], keep_dim=True),
    "max": lambda a, b, c: a.max(),
    "max_dim": lambda a, b, c: a.max(dim=[1]),
    "min": lambda a, b, c: a.min(),
    "min_keep": lambda a, b, c: a.min(dim=[0], keep_dim=True),
    "reshape": lambda a, b, c: a.reshape([4, 3]),
    "transpose": lambda a, b, c: a.transpose([1, 0]),
    "astype": lambda a, b, c: a.astype("int32"),
    "chain": lambda a, b, c: ((a * b - 1.0) / (b + 1.0)).sum(dim=[1]),
}


def _sugar(pkg, fn, arrays):
    _, dg, place = PKGS[pkg]
    with dg.guard(place):
        vs = [dg.to_variable(a) for a in arrays]
        for v in vs:
            v.stop_gradient = False
        out = fn(*vs)
        val = out.numpy()
        if np.issubdtype(val.dtype, np.floating):
            (out * out).sum().backward()
        return val, [v.gradient() for v in vs]


@pytest.mark.parametrize("case", sorted(SUGAR))
def test_varbase_sugar_matches_jax(case):
    rng = np.random.RandomState(1)
    a = rng.randn(3, 4).astype(np.float32)
    b = (rng.rand(3, 4) + 0.5).astype(np.float32)
    c = rng.randn(4, 2).astype(np.float32)
    a[0, 1] = a[2, 3] = a.max() + 1.0  # a tie for max
    want, want_g = _sugar("jax", SUGAR[case], (a, b, c))
    got, got_g = _sugar("port", SUGAR[case], (a, b, c))
    assert np.asarray(got).dtype.kind == np.asarray(want).dtype.kind
    _close(got, want)
    for g, w in zip(got_g, want_g):
        _close(g, w)


# -- backward semantics ---------------------------------------------------

def _semantics(pkg):
    fluid, dg, place = PKGS[pkg]
    xb = np.random.RandomState(2).randn(5, 4).astype(np.float32)
    out = {}
    with dg.guard(place):
        lin = dg.Linear(4, 3)
        _carry(pkg, _linear_state(4, 3), lin)
        x = dg.to_variable(xb)
        h = lin(x)
        loss = (h * h).mean()
        loss.backward()
        out.update(loss=loss.numpy(), seed=loss.gradient(),
                   h=h.gradient(), w1=lin.weight.gradient(),
                   x=x.gradient())
        loss.backward()  # again: the graph is kept, .grad accumulates
        out.update(w2=lin.weight.gradient(), h2=h.gradient(),
                   seed2=loss.gradient())
        lin.clear_gradients()
        out["cleared"] = lin.weight.gradient()
        with dg.no_grad():
            y = lin(x)
            out["no_grad_stop"] = y.stop_gradient
            with pytest.raises(RuntimeError, match="outside dygraph guard"):
                ((y * y).mean()).backward()
        # a stop_gradient var blocks the gradient behind it
        h = lin(x)
        h.stop_gradient = True
        lin2 = dg.Linear(3, 2)
        _carry(pkg, _linear_state(3, 2, 1), lin2)
        loss = (lin2(h) * h.sum(dim=[1], keep_dim=True)).mean()
        loss.backward()
        out.update(stop_w=lin.weight.gradient(),
                   stop_w2=lin2.weight.gradient(), stop_h=h.gradient())
        # detach() likewise
        lin2.clear_gradients()
        d = lin2(lin(x).detach())
        (d * d).mean().backward()
        out.update(detach_w=lin.weight.gradient(),
                   detach_w2=lin2.weight.gradient())
    with pytest.raises(RuntimeError, match="outside dygraph guard"):
        loss.backward()
    return out


def test_backward_semantics_match_jax():
    want, got = _semantics("jax"), _semantics("port")
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], bool):
            assert got[k] == want[k], k
        else:
            _close(got[k], want[k])
    # the seed is ones, and a second backward doubles every gradient
    assert float(got["seed"]) == 1.0 and float(got["seed2"]) == 2.0
    _close(got["w2"], 2 * got["w1"])
    assert got["cleared"] is None and got["stop_w"] is None
    assert got["x"] is None  # to_variable inputs take no gradient


def _grad_fn(pkg):
    fluid, dg, place = PKGS[pkg]
    xb = np.random.RandomState(3).randn(2, 4).astype(np.float32)
    with dg.guard(place):
        lin = dg.Linear(4, 3)
        _carry(pkg, _linear_state(4, 3), lin)
        x = dg.to_variable(xb)
        x.stop_gradient = False
        y = lin(x)
        loss = (y * y).sum()
        gx, = dg.grad(loss, x)
        gx = np.asarray(gx if pkg == "jax" else gx.numpy())
        return gx, x.gradient(), lin.weight.gradient()


def test_grad_matches_jax():
    """dygraph.grad returns the inputs' gradients and restores their
    .grad; in both packages the backward it runs also adds to every
    other var's .grad (the weight's here)."""
    (jg, jx, jw), (tg, tx, tw) = _grad_fn("jax"), _grad_fn("port")
    _close(tg, jg)
    assert jx is None and tx is None
    assert jw is not None
    _close(tw, jw)


def _modes(pkg):
    fluid, dg, place = PKGS[pkg]
    xb = np.random.RandomState(4).randn(4, 3, 2, 2).astype(np.float32)

    class Net(dg.Layer):
        def __init__(self):
            super().__init__()
            self.bn = dg.BatchNorm(num_channels=3)
            self.drop = dg.Dropout(p=0.5)

        def forward(self, x):
            return fluid.layers.dropout(self.drop(self.bn(x)), 0.25)

    with dg.guard(place):
        net = Net()
        x = dg.to_variable(xb)
        net.eval()
        from importlib import import_module
        state = import_module(dg.__name__)._state
        test_mode = state["is_test"], net.training, net.bn.training
        ev = net(x).numpy()
        net.train()
        train_mode = state["is_test"], net.training, net.bn.training
        net(x)
        stats = net.bn._mean.numpy(), net.bn._variance.numpy()
        return test_mode, train_mode, ev, stats


def test_train_eval_and_is_test_match_jax():
    want, got = _modes("jax"), _modes("port")
    assert want[0] == got[0] == (True, False, False)
    assert want[1] == got[1] == (False, True, True)
    _close(got[2], want[2])  # eval: running statistics, both dropouts off
    for g, w in zip(got[3], want[3]):
        _close(g, w)


# -- the eager optimizers --------------------------------------------------

XV = np.random.RandomState(0).randn(32, 8).astype(np.float32)
YV = (XV[:, :1] * 1.5 - 0.5).astype(np.float32)

OPTIMIZERS = {
    "sgd": lambda f, dg: f.optimizer.SGD(learning_rate=0.05),
    "momentum": lambda f, dg: f.optimizer.Momentum(learning_rate=0.05,
                                                   momentum=0.9),
    "nesterov": lambda f, dg: f.optimizer.Momentum(
        learning_rate=0.05, momentum=0.9, use_nesterov=True),
    "lars_momentum": lambda f, dg: f.optimizer.LarsMomentum(
        learning_rate=0.5, momentum=0.9),
    "adagrad": lambda f, dg: f.optimizer.Adagrad(learning_rate=0.2),
    "decayed_adagrad": lambda f, dg: f.optimizer.DecayedAdagrad(
        learning_rate=0.05),
    "adam": lambda f, dg: f.optimizer.Adam(learning_rate=0.05),
    "adamw": lambda f, dg: f.optimizer.AdamW(learning_rate=0.05,
                                             weight_decay=0.01),
    "dgc_momentum": lambda f, dg: f.optimizer.DGCMomentum(
        learning_rate=0.05, momentum=0.9, rampup_begin_step=0),
    "l2": lambda f, dg: f.optimizer.SGD(
        learning_rate=0.05, regularization=f.regularizer.L2Decay(0.1)),
    "l1": lambda f, dg: f.optimizer.Adam(
        learning_rate=0.05, regularization=f.regularizer.L1Decay(0.01)),
    "piecewise": lambda f, dg: f.optimizer.SGD(
        learning_rate=dg.PiecewiseDecay([5, 15], [0.1, 0.05, 0.01])),
    "natural_exp": lambda f, dg: f.optimizer.Momentum(
        learning_rate=dg.NaturalExpDecay(0.05, 5, 0.5), momentum=0.9),
    "exponential": lambda f, dg: f.optimizer.SGD(
        learning_rate=dg.ExponentialDecay(0.1, 5, 0.5, staircase=True)),
    "inverse_time": lambda f, dg: f.optimizer.SGD(
        learning_rate=dg.InverseTimeDecay(0.1, 5, 0.5)),
    "polynomial": lambda f, dg: f.optimizer.Adam(
        learning_rate=dg.PolynomialDecay(0.05, 10, cycle=True)),
    "cosine": lambda f, dg: f.optimizer.SGD(
        learning_rate=dg.CosineDecay(0.1, 5, 5)),
    "noam": lambda f, dg: f.optimizer.SGD(
        learning_rate=dg.NoamDecay(8, 10)),
}
CLIPS = {
    "value": lambda f: f.clip.GradientClipByValue(0.05),
    "norm": lambda f: f.clip.GradientClipByNorm(0.1),
    "global_norm": lambda f: f.clip.GradientClipByGlobalNorm(0.1),
}
# (optimizer, clip, skip the bias through no_grad_set)
TRAIN_CASES = {name: (name, None, False) for name in OPTIMIZERS}
TRAIN_CASES.update({f"clip_{c}": ("momentum", c, False) for c in CLIPS})
TRAIN_CASES["clip_global_norm_adamw"] = ("adamw", "global_norm", False)
TRAIN_CASES["no_grad_set"] = ("sgd", None, True)


def _train(pkg, opt_name, clip, skip_bias, steps=25):
    fluid, dg, place = PKGS[pkg]
    losses, states = [], []
    with dg.guard(place):
        lin = dg.Linear(8, 1)
        _carry(pkg, _linear_state(8, 1), lin)
        opt = OPTIMIZERS[opt_name](fluid, dg)
        if clip:
            fluid.clip.set_gradient_clip(CLIPS[clip](fluid))
        try:
            for _ in range(steps):
                pred = lin(dg.to_variable(XV))
                loss = ((pred - dg.to_variable(YV)) ** 2).mean()
                loss.backward()
                opt.minimize(loss, parameter_list=lin.parameters(),
                             no_grad_set={lin.bias.name} if skip_bias
                             else None)
                lin.clear_gradients()
                losses.append(float(loss.numpy()))
                states.append(lin.state_dict())
        finally:
            fluid.clip.set_gradient_clip(None)
    return losses, states


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_eager_optimizer_matches_jax(case):
    want_l, want_s = _train("jax", *TRAIN_CASES[case])
    got_l, got_s = _train("port", *TRAIN_CASES[case])
    _close(got_l, want_l, rtol=TRAIN_RTOL)
    for g, w in zip(got_s, want_s):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype == np.float32
            _close(g[k], w[k], rtol=TRAIN_RTOL)
    if TRAIN_CASES[case][2]:
        _close(got_s[-1]["bias"], _linear_state(8, 1)["bias"], rtol=0,
               atol=0)
    if case in ("sgd", "momentum", "adagrad", "adam", "adamw"):
        # the JAX package's own test of these five: the loss halves
        assert got_l[-1] < got_l[0] * 0.5


LR_OBJECTS = {
    "piecewise": lambda dg: dg.PiecewiseDecay([10, 20], [0.1, 0.01, 0.001]),
    "natural_exp": lambda dg: dg.NaturalExpDecay(0.1, 4, 0.3, True),
    "exponential": lambda dg: dg.ExponentialDecay(0.1, 4, 0.8),
    "inverse_time": lambda dg: dg.InverseTimeDecay(0.1, 4, 0.3, True),
    "polynomial": lambda dg: dg.PolynomialDecay(0.1, 7, 1e-3, 2.0, True),
    "cosine": lambda dg: dg.CosineDecay(0.1, 5, 10),
    "noam": lambda dg: dg.NoamDecay(512, 10),
    "piecewise_begin": lambda dg: dg.PiecewiseDecay([3], [1.0, 0.5],
                                                    begin=2, step=2),
}


@pytest.mark.parametrize("name", sorted(LR_OBJECTS))
def test_lr_objects_match_jax(name):
    want = LR_OBJECTS[name](jdg)
    got = LR_OBJECTS[name](tdg)
    assert [got.step() for _ in range(25)] == \
        [want.step() for _ in range(25)]


@pytest.mark.parametrize("name", ["Lamb", "Adamax", "Adadelta", "RMSProp",
                                  "Ftrl", "Dpsgd"])
def test_optimizers_without_an_eager_rule_raise(name):
    for pkg in ("jax", "port"):
        fluid, dg, place = PKGS[pkg]
        with dg.guard(place):
            lin = dg.Linear(4, 1)
            opt = getattr(fluid.optimizer, name)(learning_rate=0.1)
            loss = lin(dg.to_variable(np.ones((2, 4), np.float32))).mean()
            loss.backward()
            with pytest.raises(NotImplementedError, match="eager"):
                opt.minimize(loss, parameter_list=lin.parameters())


def test_minimize_needs_parameter_list():
    for pkg in ("jax", "port"):
        fluid, dg, place = PKGS[pkg]
        with dg.guard(place):
            lin = dg.Linear(4, 1)
            loss = lin(dg.to_variable(np.ones((2, 4), np.float32))).mean()
            loss.backward()
            with pytest.raises(ValueError, match="parameter_list"):
                fluid.optimizer.SGD(0.1).minimize(loss)


def test_untrainable_parameters_are_skipped():
    """A BatchNorm's running statistics are parameters, untrainable: no
    optimizer state, no update, in both packages."""
    xb = np.random.RandomState(5).randn(4, 3, 2, 2).astype(np.float32)
    out = {}
    for pkg in ("jax", "port"):
        fluid, dg, place = PKGS[pkg]
        with dg.guard(place):
            bn = dg.BatchNorm(num_channels=3)
            opt = fluid.optimizer.Momentum(0.1, 0.9)
            loss = (bn(dg.to_variable(xb)) ** 2).mean()
            loss.backward()
            _, pgs = opt.minimize(loss, parameter_list=bn.parameters())
            names = {n for n, p in bn.named_parameters()
                     if any(p is q for q, _ in pgs)}
            out[pkg] = (names, bn.state_dict())
    assert out["jax"][0] == out["port"][0] == {"weight", "bias"}
    for k in out["jax"][1]:
        _close(out["port"][1][k], out["jax"][1][k])


def test_lr_decay_object_in_static_mode_raises():
    for fluid, dg in ((fj, jdg), (ft, tdg)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("lrx", shape=[4], dtype="float32")
            loss = fluid.layers.mean(fluid.layers.fc(x, size=2))
            opt = fluid.optimizer.SGD(
                learning_rate=dg.PiecewiseDecay([2], [0.1, 0.01]))
            with pytest.raises(TypeError, match="dygraph"):
                opt.minimize(loss)


def test_eager_update_is_in_place():
    """The port updates a parameter in place: a backward through a graph
    recorded before the update raises torch's version-counter error,
    where the JAX package replays with the new value (ROADMAP §C)."""
    xb = np.ones((2, 4), np.float32)
    for pkg in ("jax", "port"):
        fluid, dg, place = PKGS[pkg]
        with dg.guard(place):
            lin = dg.Linear(4, 1)
            x = dg.to_variable(xb)
            x.stop_gradient = False
            w = lin.weight
            loss = lin(x).mean()
            loss.backward()
            fluid.optimizer.SGD(0.1).minimize(loss,
                                              parameter_list=[w])
            if pkg == "jax":
                loss.backward()
            else:
                assert lin.weight is w
                with pytest.raises(RuntimeError, match="inplace"):
                    loss.backward()


# -- DataParallel and the layer dispatch ----------------------------------

def test_data_parallel_at_one_rank(monkeypatch):
    """The forward and the state dict are the wrapped layer's in both
    packages. The port's rank count is torch.distributed's world size (1
    without a process group), so scale_loss returns the loss and
    apply_collective_grads does nothing; above one rank it averages the
    gradients over the ranks (here two equal ranks, the all-reduce
    stubbed; tests/test_torch_parallel.py runs two real ones). (The JAX
    package counts its devices, 8 on the test mesh, and divides by
    them.)"""
    xb = np.random.RandomState(6).randn(3, 4).astype(np.float32)
    outs = {}
    for pkg in ("jax", "port"):
        fluid, dg, place = PKGS[pkg]
        with dg.guard(place):
            lin = dg.Linear(4, 2)
            _carry(pkg, _linear_state(4, 2), lin)
            dp = dg.DataParallel(lin)
            outs[pkg] = dp(dg.to_variable(xb)).numpy()
            assert set(dp.state_dict()) == {"weight", "bias"}
            if pkg == "port":
                loss = dp(dg.to_variable(xb)).mean()
                assert dp.scale_loss(loss) is loss
                dp.apply_collective_grads()
                assert dg.prepare_context().nranks == 1
                assert dg.parallel.ParallelEnv().local_rank == 0
                import paddle_tpu_torch.dygraph.parallel as par
                monkeypatch.setattr(par, "_world", lambda: (2, 1))
                _close(dp.scale_loss(loss).numpy(), loss.numpy() * 0.5)
                import paddle_tpu_torch.ops.collective as coll
                monkeypatch.setattr(coll, "all_reduce",
                                    lambda x, group, op: x * 2)
                loss.backward()
                before = [p.gradient() for p in dp.parameters()]
                dp.apply_collective_grads()
                for b, p in zip(before, dp.parameters()):
                    _close(p.gradient(), b)
    _close(outs["port"], outs["jax"])


def test_layers_with_parameters_raise_the_same_key_error():
    xb = np.ones((2, 4), np.float32)
    msgs = {}
    for pkg in ("jax", "port"):
        fluid, dg, place = PKGS[pkg]
        with dg.guard(place), fluid.unique_name.guard():
            with pytest.raises(KeyError) as e:
                fluid.layers.fc(dg.to_variable(xb), size=3)
            msgs[pkg] = str(e.value)
    assert msgs["jax"] == msgs["port"] == \
        "\"dygraph var 'fc_0.w_0' not found for mul.Y\""


def test_parameterless_layers_run_through_the_dispatch():
    """reshape -> transpose -> flash_attention (T < 128: the plain path)
    -> reduce_mean through layers.*, then backward, in both."""
    rng = np.random.RandomState(8)
    qkv = rng.randn(2, 16, 3, 2, 8).astype(np.float32)
    outs = {}
    for pkg in ("jax", "port"):
        fluid, dg, place = PKGS[pkg]
        L = fluid.layers
        with dg.guard(place):
            x = dg.to_variable(qkv)
            x.stop_gradient = False
            t = L.transpose(L.reshape(x, [2, 16, 3, 2, 8]), [2, 0, 3, 1, 4])
            q, k, v = (L.reshape(L.slice(t, [0], [i], [i + 1]),
                                 [2, 2, 16, 8]) for i in range(3))
            o = L.flash_attention(q, k, v, causal=True)
            loss = L.reduce_mean(o * o)
            loss.backward()
            outs[pkg] = (o.numpy(), x.gradient())
    _close(outs["port"][0], outs["jax"][0])
    _close(outs["port"][1], outs["jax"][1])


# -- the three faults the port repairs ------------------------------------

def test_save_load_dygraph_round_trips(tmp_path):
    """The JAX package writes <path>.pdparams.npz and reads
    <path>.pdparams: its load raises FileNotFoundError. The port's
    round-trips, and reads the JAX package's file, whose state carries
    into a port layer."""
    xb = np.random.RandomState(9).randn(2, 3, 4, 4).astype(np.float32)
    with jdg.guard():
        bn = jdg.BatchNorm(num_channels=3)
        bn(jdg.to_variable(xb))
        jstate = bn.state_dict()
        jdg.save_dygraph(jstate, str(tmp_path / "jax" / "m"))
        with pytest.raises(FileNotFoundError):
            jdg.load_dygraph(str(tmp_path / "jax" / "m"))
        bn.eval()
        want = bn(jdg.to_variable(xb)).numpy()
    with tdg.guard(CPU):
        bn = tdg.BatchNorm(num_channels=3)
        bn(tdg.to_variable(xb))
        tdg.save_dygraph(bn.state_dict(), str(tmp_path / "port" / "m"))
        state, opt_state = tdg.load_dygraph(str(tmp_path / "port" / "m"))
        assert opt_state is None
        for k, v in bn.state_dict().items():
            np.testing.assert_array_equal(state[k], v)
        loaded, _ = tdg.load_dygraph(str(tmp_path / "jax" / "m"))
        assert set(loaded) == set(jstate) == {"weight", "bias", "_mean",
                                              "_variance"}
        bn2 = layer_from_numpy(loaded, tdg.BatchNorm(num_channels=3))
        bn2.eval()
        _close(bn2(tdg.to_variable(xb)).numpy(), want)


def _traced_stale(pkg):
    fluid, dg, place = PKGS[pkg]
    rng = np.random.RandomState(10)
    x1, x2 = (rng.randn(3, 4).astype(np.float32) for _ in range(2))
    with dg.guard(place):
        lin = dg.Linear(4, 2)
        _carry(pkg, _linear_state(4, 2), lin)

        def f(x):
            return lin(fluid.layers.scale(x, scale=2.0))

        _, traced = dg.TracedLayer.trace(f, [dg.to_variable(x1)])
        got, = traced([dg.to_variable(x2)])
        eager = f(dg.to_variable(x2)).numpy()
        ops = [op.type for op in traced.program.global_block().ops]
    return np.asarray(got), eager, ops


def test_traced_layer_keeps_ops_on_the_input_alone():
    """The JAX package leaves `scale` (its input needs no gradient) out
    of the captured Program and freezes its first output: a second input
    gets the first one's answer. The port captures every op."""
    got, eager, ops = _traced_stale("jax")
    assert ops == ["mul", "elementwise_add"]
    assert not np.allclose(got, eager, atol=1e-3)
    got, eager, ops = _traced_stale("port")
    assert ops == ["scale", "mul", "elementwise_add"]
    _close(got, eager)


def _canonical(traced):
    """The captured Program with var names replaced by their order of
    first use: ops (type, slots, attrs), vars (shape, dtype,
    persistable), feeds, fetches and the parameters' values."""
    block = traced.program.global_block()
    order = {}

    def c(n):
        return order.setdefault(n, f"v{len(order)}")

    for n in traced._feed_names:
        c(n)
    ops = [(op.type,
            {s: [c(n) for n in ns] for s, ns in op.inputs.items()},
            {s: [c(n) for n in ns] for s, ns in op.outputs.items()},
            op.attrs) for op in block.ops]
    dtypes = {"int64": "int32"}
    vs = {c(n): (tuple(v.shape), dtypes.get(v.dtype, v.dtype),
                 v.persistable) for n, v in block.vars.items()}
    params = {c(n): np.asarray(traced._scope.get_numpy(n)
                               if hasattr(traced._scope, "get_numpy")
                               else traced._scope.get(n))
              for n, v in block.vars.items() if v.persistable}
    return ops, vs, [c(n) for n in traced._feed_names], \
        [c(n) for n in traced._fetch_names], params


def _trace_mlp(pkg, tmp_path):
    fluid, dg, place = PKGS[pkg]
    xb = np.random.RandomState(11).randn(3, 4).astype(np.float32)
    with dg.guard(place):
        l1, l2 = dg.Linear(4, 5, act="relu"), dg.Linear(5, 2)
        _carry(pkg, _linear_state(4, 5), l1)
        _carry(pkg, _linear_state(5, 2, 1), l2)

        def f(x):
            h = l1(x)
            return fluid.layers.reshape(l2(h) * 0.5 + h.mean(), [6])

        eager, traced = dg.TracedLayer.trace(f, [dg.to_variable(xb)])
        got, = traced([dg.to_variable(xb)])
        d = str(tmp_path / pkg)
        traced.save_inference_model(d)
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(place) if place is not None else \
            fluid.Executor()
        prog, feeds, fetches = fluid.io.load_inference_model(d, exe)
        reloaded, = exe.run(prog, feed={feeds[0]: xb}, fetch_list=fetches)
    return _canonical(traced), eager.numpy(), np.asarray(got), \
        np.asarray(reloaded)


def test_traced_program_equals_jax(tmp_path):
    """Where every op needs a gradient, the captured Program is the JAX
    package's, names replaced by their order of first use (eager
    counters in both); it runs on the Executor and reloads through
    save/load_inference_model to the eager answer."""
    (jops, jvars, jfeed, jfetch, jparams), *jouts = _trace_mlp(
        "jax", tmp_path)
    (tops, tvars, tfeed, tfetch, tparams), *touts = _trace_mlp(
        "port", tmp_path)
    assert tops == jops and tvars == jvars
    assert (tfeed, tfetch) == (jfeed, jfetch)
    assert set(tparams) == set(jparams)
    for k in jparams:
        _close(tparams[k], jparams[k])
    for t, j in zip(touts, jouts):
        _close(t, j)
    _close(touts[1], touts[0])
    _close(touts[2], touts[0])


def _activation_refs(pkg, steps=3):
    fluid, dg, place = PKGS[pkg]
    xb = np.random.RandomState(12).randn(8, 4).astype(np.float32)
    refs = []
    with dg.guard(place):
        lin = dg.Linear(4, 4)
        opt = fluid.optimizer.SGD(0.01)

        def step():
            h = lin(dg.to_variable(xb))
            refs.append(weakref.ref(h.value if pkg == "port" else h))
            loss = (h * h).mean()
            loss.backward()
            opt.minimize(loss, parameter_list=lin.parameters())
            lin.clear_gradients()

        for _ in range(steps):
            step()
        gc.collect()
        return [r() is not None for r in refs]


def test_steps_do_not_pin_activations():
    """The JAX package's tape keeps every step's activations for the
    life of the guard; the port keeps none once a step's loss is
    dropped."""
    assert _activation_refs("jax") == [True, True, True]
    assert _activation_refs("port") == [False, False, False]
