"""Datasets, metrics, checkpoints and the host I/O ops of the static-graph
basics slice, through both packages on the CPU.

- Every split of every dataset yields the JAX package's first 64 samples
  byte for byte (same types, dtypes and values), and the vocabularies
  and id tables are equal.
- Every metric class gives the JAX package's result within 1e-12 on the
  same seeded updates.
- io.save by either package loads in the other (both ways, and the
  older `<path>.pdparams.npz` name), as do save_params / load_params and
  save_persistables with and without one combined file; arrays equal.
- The save, save_combine, load and load_combine ops: files written by
  one package's program are read by the other's, with equal values.
"""
import os

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu import datasets as jds
from paddle_tpu import metrics as jmet
from paddle_tpu_torch import datasets as tds
from paddle_tpu_torch import metrics as tmet

N_SAMPLES = 64
SPLITS = [("mnist", "train"), ("mnist", "test"), ("cifar", "train10"),
          ("cifar", "test10"), ("cifar", "train100"), ("cifar", "test100"),
          ("imdb", "train"), ("imdb", "test"), ("movielens", "train"),
          ("movielens", "test"), ("uci_housing", "train"),
          ("uci_housing", "test"), ("wmt16", "train"), ("wmt16", "test")]


def _same_value(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_value(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("name,split", SPLITS)
def test_dataset_split_is_byte_equal(name, split, monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_DATA_HOME", raising=False)
    rj = getattr(getattr(jds, name), split)()
    rt = getattr(getattr(tds, name), split)()
    got_j = [s for _, s in zip(range(N_SAMPLES), rj())]
    got_t = [s for _, s in zip(range(N_SAMPLES), rt())]
    assert len(got_t) == N_SAMPLES
    _same_value(got_t, got_j)


def test_dataset_tables_are_equal():
    assert tds.imdb.word_dict() == jds.imdb.word_dict()
    assert tds.wmt16.get_dict("en", 50) == jds.wmt16.get_dict("en", 50)
    assert tds.wmt16.get_dict("de", 50, reverse=True) == \
        jds.wmt16.get_dict("de", 50, reverse=True)
    for f in ("max_user_id", "max_movie_id", "max_job_id"):
        assert getattr(tds.movielens, f)() == getattr(jds.movielens, f)()
    assert tds.movielens.age_table == jds.movielens.age_table
    assert tds.mnist.TRAIN_SIZE == jds.mnist.TRAIN_SIZE == 8192


def test_real_data_override(tmp_path, monkeypatch):
    xs = np.arange(12, dtype=np.float32).reshape(3, 4)
    ys = np.array([1, 2, 3], np.int64)
    np.savez(tmp_path / "mnist_train.npz", x=xs, y=ys)
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    _same_value(list(tds.mnist.train()()), list(jds.mnist.train()()))
    assert tds.real_data("cifar10", "train") is None


# -- metrics ---------------------------------------------------------------

def _metric_runs(m, rng):
    """Seeded updates for metric class `m` (the same for both
    packages)."""
    out = []
    for _ in range(5):
        if m in ("Precision", "Recall"):
            out.append(((rng.rand(16, 1),), {"labels": rng.randint(0, 2, 16)}))
        elif m == "Accuracy":
            out.append(((rng.rand(), rng.randint(1, 64)), {}))
        elif m == "Auc":
            p = rng.rand(32, 2)
            out.append(((p / p.sum(1, keepdims=True),
                         rng.randint(0, 2, (32, 1))), {}))
        elif m == "ChunkEvaluator":
            c = rng.randint(1, 9)
            out.append(((rng.randint(c, 12), rng.randint(c, 12), c), {}))
        elif m == "EditDistance":
            out.append(((rng.randint(0, 3, (8, 1)).astype(np.float32), 8),
                        {}))
        elif m == "DetectionMAP":
            n = rng.randint(1, 5)
            lo = rng.rand(n, 2) * 0.5
            gt = np.concatenate([lo, lo + 0.2 + rng.rand(n, 2) * 0.3], 1)
            lab = rng.randint(1, 4, (n, 1))
            det = []
            for i in range(n + 2):
                j = i % n
                box = gt[j] + rng.randn(4) * 0.05
                det.append([lab[j, 0] if i < n else rng.randint(1, 4),
                            rng.rand(), *box])
            out.append(((np.array(det), lab, gt,
                         rng.randint(0, 2, (n, 1))), {}))
    return out


METRICS = ["Accuracy", "Precision", "Recall", "Auc", "ChunkEvaluator",
           "EditDistance", "DetectionMAP", "DetectionMAP-11point",
           "DetectionMAP-no-difficult", "Composite"]


def _make(mod, case):
    if case == "Composite":
        m = mod.CompositeMetric()
        m.add_metric(mod.Precision())
        m.add_metric(mod.Recall())
        return m, "Precision"
    if case == "DetectionMAP-11point":
        return mod.DetectionMAP(ap_version="11point"), "DetectionMAP"
    if case == "DetectionMAP-no-difficult":
        return mod.DetectionMAP(evaluate_difficult=False), "DetectionMAP"
    return getattr(mod, case)(), case


def _flat(x):
    return np.asarray(x, np.float64).reshape(-1)


@pytest.mark.parametrize("case", METRICS)
def test_metric_matches_jax(case):
    results = {}
    for name, mod in (("jax", jmet), ("torch", tmet)):
        m, kind = _make(mod, case)
        vals = []
        for args, kw in _metric_runs(kind, np.random.RandomState(5)):
            if kind in ("Precision", "Recall"):
                m.update(args[0], kw["labels"])
            else:
                m.update(*args)
            vals.append(_flat(m.eval()))
        m.reset()
        results[name] = (vals, m.get_config() if case != "Composite"
                         else None)
    for t, j in zip(results["torch"][0], results["jax"][0]):
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-12)
    assert results["torch"][1] == results["jax"][1]


def test_metric_errors_match():
    for mod in (jmet, tmet):
        with pytest.raises(ValueError, match="no data"):
            mod.Accuracy().eval()
        with pytest.raises(ValueError, match="no data"):
            mod.EditDistance().eval()
        with pytest.raises(ValueError, match="ap_version"):
            mod.DetectionMAP(ap_version="bad")


# -- checkpoints -----------------------------------------------------------

def _train_program(f):
    main, startup = f.Program(), f.Program()
    startup.random_seed = 9
    with f.program_guard(main, startup), f.unique_name.guard():
        x = f.layers.data("x", [6])
        y = f.layers.fc(f.layers.fc(x, 5, act="relu"), 2)
        loss = f.layers.mean(y)
        f.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


FEED = {"x": np.random.RandomState(2).randn(4, 6).astype(np.float32)}


def _jax_state():
    """A JAX scope after startup and one step, and the program."""
    main, startup, loss = _train_program(fj)
    scope = fj.Scope()
    with fj.scope_guard(scope):
        exe = fj.Executor(fj.CPUPlace())
        exe.run(startup)
        exe.run(main, feed=FEED, fetch_list=[loss])
    return main, scope


def _torch_state():
    main, startup, loss = _train_program(ft)
    scope = ft.Scope()
    exe = ft.Executor(ft.CPUPlace())
    exe.run(startup, scope=scope)
    exe.run(main, feed=FEED, fetch_list=[loss], scope=scope)
    return main, scope, exe


def _arrays(scope, names):
    return {n: np.asarray(scope.get_numpy(n) if hasattr(scope, "get_numpy")
                          else scope.get(n)) for n in names}


def _persistables(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _assert_scopes(got, want, names):
    assert names
    for n in names:
        a, b = np.asarray(got[n]), np.asarray(want[n])
        assert a.shape == b.shape, n
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=n)


def test_io_save_by_jax_loads_in_the_port(tmp_path):
    mj, scope_j = _jax_state()
    path = str(tmp_path / "ckpt" / "model")
    with fj.scope_guard(scope_j):
        fj.io.save(mj, path)
    mt, _, _ = _train_program(ft)
    scope_t = ft.Scope()
    with ft.scope_guard(scope_t):
        ft.io.load(mt, path, ft.Executor(ft.CPUPlace()))
    names = _persistables(mt)
    _assert_scopes(_arrays(scope_t, names), _arrays(scope_j, names), names)
    # each tensor in its declared dtype, on the executor's device
    from paddle_tpu_torch.core.dtypes import as_torch_dtype
    blk = mt.global_block()
    for n in names:
        t = scope_t.get(n)
        assert t.device.type == "cpu"
        assert t.dtype == as_torch_dtype(blk.var(n).dtype), n
    assert ft.Program.from_json(open(path + ".pdmodel").read()).to_json() \
        == mt.to_json()


def test_io_save_by_the_port_loads_in_jax(tmp_path):
    mt, scope_t, _ = _torch_state()
    path = str(tmp_path / "model")
    with ft.scope_guard(scope_t):
        ft.io.save(mt, path)
    assert os.path.exists(path + ".pdparams") and \
        os.path.exists(path + ".pdmodel")
    mj, _, _ = _train_program(fj)
    scope_j = fj.Scope()
    with fj.scope_guard(scope_j):
        fj.io.load(mj, path)
    names = _persistables(mt)
    _assert_scopes(_arrays(scope_j, names), _arrays(scope_t, names), names)
    assert fj.Program.from_json(open(path + ".pdmodel").read()).to_json() \
        == mj.to_json()


def test_io_load_reads_the_older_npz_name(tmp_path):
    mt, scope_t, exe = _torch_state()
    path = str(tmp_path / "old")
    with ft.scope_guard(scope_t):
        ft.io.save(mt, path)
    os.rename(path + ".pdparams", path + ".pdparams.npz")
    scope2 = ft.Scope()
    with ft.scope_guard(scope2):
        ft.io.load(mt, path, exe)
    names = _persistables(mt)
    _assert_scopes(_arrays(scope2, names), _arrays(scope_t, names), names)


@pytest.mark.parametrize("filename", [None, "params.npz"])
@pytest.mark.parametrize("kind", ["params", "persistables"])
def test_save_params_both_ways(tmp_path, kind, filename):
    mt, scope_t, exe = _torch_state()
    mj, scope_j = _jax_state()
    d_t, d_j = str(tmp_path / "t"), str(tmp_path / "j")
    with ft.scope_guard(scope_t):
        getattr(ft.io, f"save_{kind}")(exe, d_t, mt, filename=filename)
    with fj.scope_guard(scope_j):
        getattr(fj.io, f"save_{kind}")(None, d_j, mj, filename=filename)
    if filename is None:
        assert sorted(os.listdir(d_t)) == sorted(os.listdir(d_j))
    names = sorted(p.name for p in mt.all_parameters()) \
        if kind == "params" else \
        sorted(v.name for v in mt.list_vars()
               if v.persistable and not v.is_data)
    # port <- JAX files, JAX <- port files
    into_t, into_j = ft.Scope(), fj.Scope()
    with ft.scope_guard(into_t):
        getattr(ft.io, f"load_{kind}")(exe, d_j, mt, filename=filename)
    with fj.scope_guard(into_j):
        getattr(fj.io, f"load_{kind}")(None, d_t, mj, filename=filename)
    _assert_scopes(_arrays(into_t, names), _arrays(scope_j, names), names)
    _assert_scopes(_arrays(into_j, names), _arrays(scope_t, names), names)
    if kind == "params":
        assert not any("moment" in n for n in into_t.names())


# -- the host I/O ops ------------------------------------------------------

def _save_program(f, d):
    main = f.Program()
    blk = main.global_block()
    with f.program_guard(main, f.Program()):
        a = f.layers.data("a", [3, 4], append_batch_size=False)
        b = f.layers.data("b", [5], dtype="int64", append_batch_size=False)
    for name, op, ins, attrs in (
            ("t0", "save", [a.name], {"file_path": os.path.join(d, "a")}),
            ("t1", "save_combine", [a.name, b.name],
             {"file_path": os.path.join(d, "ab"),
              "var_names": ["a", "b"]})):
        blk.create_var(name=name, shape=[], dtype="int32")
        blk.append_op(op, inputs={"X": ins}, outputs={"Out": [name]},
                      attrs=attrs, infer_shape=False)
    return main


def _load_program(f, d):
    main = f.Program()
    blk = main.global_block()
    with f.program_guard(main, f.Program()):
        a = blk.create_var(name="la", shape=[3, 4], dtype="float32")
        f.layers.load(a, os.path.join(d, "a"))
    # int32: the JAX package's load_combine refuses 64-bit types
    for n, s, t in (("ca", [3, 4], "float32"), ("cb", [5], "int32")):
        blk.create_var(name=n, shape=s, dtype=t)
    blk.append_op("load_combine", inputs={},
                  outputs={"Out": ["ca", "cb"]},
                  attrs={"file_path": os.path.join(d, "ab"),
                         "var_names": ["a", "b"], "shapes": [[3, 4], [5]],
                         "dtypes": ["float32", "int32"]},
                  infer_shape=False)
    return main


def _run(f, main, feed, fetch):
    if f is fj:
        scope = fj.Scope()
        with fj.scope_guard(scope):
            out = fj.Executor(fj.CPUPlace()).run(main, feed=feed,
                                                 fetch_list=fetch)
        return [np.asarray(o) for o in out]
    return ft.Executor(ft.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                          scope=ft.Scope())


@pytest.mark.parametrize("writer,reader", [(fj, ft), (ft, fj), (ft, ft)])
def test_save_and_load_ops_cross_packages(tmp_path, writer, reader):
    d = str(tmp_path)
    feed = {"a": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
            "b": np.arange(5, dtype=np.int64) * 3 - 4}
    tokens = _run(writer, _save_program(writer, d), feed, ["t0", "t1"])
    assert [int(t) for t in tokens] == [0, 0]
    assert sorted(os.listdir(d)) == ["a.npy", "ab.npz"]
    la, ca, cb = _run(reader, _load_program(reader, d), {},
                      ["la", "ca", "cb"])
    np.testing.assert_array_equal(la, feed["a"])
    np.testing.assert_array_equal(ca, feed["a"])
    np.testing.assert_array_equal(cb, feed["b"])
    assert la.dtype == np.float32 and cb.dtype.kind == "i"


def test_load_op_checks_the_declared_shape(tmp_path):
    np.save(tmp_path / "a.npy", np.zeros((2, 2), np.float32))
    main = ft.Program()
    with ft.program_guard(main, ft.Program()):
        v = main.global_block().create_var(name="v", shape=[3, 4],
                                           dtype="float32")
        ft.layers.load(v, str(tmp_path / "a"))
    with pytest.raises(ValueError, match="declares"):
        ft.Executor(ft.CPUPlace()).run(main, fetch_list=["v"],
                                       scope=ft.Scope())
