"""The input pipeline (reader_decorator, DataFeeder, DataLoader, PyReader,
the in-program readers of layers.io) through both packages on the CPU.

- Every decorator gives the JAX package's samples in the JAX package's
  order (shuffle under one `random` seed; an unordered xmap compared as
  a multiset), and a worker's exception re-raises in the consumer in
  both: buffered, xmap's source and mapper, a DataLoader generator and a
  multiprocess_reader worker. A SIGKILLed multiprocess_reader worker
  raises ReaderWorkerDied instead of hanging.
- DataFeeder and every DataLoader/PyReader configuration yield the JAX
  package's feed dicts (equal arrays and dtypes) over the same reader,
  with the same reader.* stats, and under an injected reader stall
  (FLAGS_fault_spec slow_step:site=reader) the same goodput input_wait
  verdict: every batch starved, the stall inside the measured wait.
- The slice as a whole: a small fc model on datasets.mnist, fed through
  each package's DataLoader, the port from the JAX startup carried by
  convert.py: the losses of 3 Adam steps within rtol 1e-5.
"""
import random

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
import torch_reader_helpers as helpers
from paddle_tpu import goodput as jgood
from paddle_tpu import monitor as jmon
from paddle_tpu import reader_decorator as jrd
from paddle_tpu.core import flags as jflags
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu_torch import goodput as tgood
from paddle_tpu_torch import monitor as tmon
from paddle_tpu_torch import reader_decorator as trd
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.resilience import faults as tfaults

PKGS = {"jax": (fj, jrd, jmon, jgood, jflags, jfaults),
        "torch": (ft, trd, tmon, tgood, tflags, tfaults)}
FLAGS_USED = ("enable_monitor", "enable_goodput", "goodput_starved_ms",
              "fault_spec", "reader_queue_depth")


def _reset():
    for _, _, mon, good, flags, faults in PKGS.values():
        for name in FLAGS_USED:
            h = flags.flag_handle(name)
            h.value = h.default
        mon.reset_stats()
        good.reset()
        faults.reset_injector()


@pytest.fixture(autouse=True)
def _hygiene():
    _reset()
    yield
    _reset()


def _set(name, value):
    for _, _, _, _, flags, _ in PKGS.values():
        flags.flag_handle(name).value = value


def r10():
    return iter(range(10))


def r1020():
    return iter(range(10, 20))


DECORATOR_CASES = {
    "chain": lambda rd: rd.chain(r10, r1020),
    "firstn": lambda rd: rd.firstn(r10, 3),
    "map_readers": lambda rd: rd.map_readers(lambda a, b: a * 100 + b,
                                             r10, r1020),
    "shuffle": lambda rd: rd.shuffle(r10, 4),
    "shuffle_all": lambda rd: rd.shuffle(r10, 100),
    "buffered": lambda rd: rd.buffered(r10, 2),
    "compose": lambda rd: rd.compose(r10, r1020),
    "compose_unchecked": lambda rd: rd.compose(
        r10, lambda: iter(range(4)), check_alignment=False),
    "xmap_ordered": lambda rd: rd.xmap_readers(lambda x: x * 2, r10, 3, 4,
                                               order=True),
    "batch": lambda rd: rd.batch(r10, 4),
    "batch_drop_last": lambda rd: rd.batch(r10, 4, drop_last=True),
    "cache": lambda rd: rd.cache(rd.map_readers(lambda x: x + 1, r10)),
    "io_batch": lambda rd: (fj if rd is jrd else ft).io.batch(r10, 3),
}


@pytest.mark.parametrize("case", sorted(DECORATOR_CASES))
def test_decorator_matches_jax(case):
    got = {}
    for name, (_, rd, _, _, _, _) in PKGS.items():
        random.seed(3)
        reader = DECORATOR_CASES[case](rd)
        got[name] = [list(reader()), list(reader())]
    assert got["torch"] == got["jax"]
    assert got["torch"][0]


def test_xmap_unordered_gives_the_same_samples():
    got = {name: sorted(rd.xmap_readers(lambda x: x * 3, r10, 4, 2)())
           for name, (_, rd, _, _, _, _) in PKGS.items()}
    assert got["torch"] == got["jax"] == [3 * i for i in range(10)]


def test_compose_not_aligned():
    for _, rd, _, _, _, _ in PKGS.values():
        with pytest.raises(rd.ComposeNotAligned):
            list(rd.compose(r10, lambda: iter(range(5)))())
        assert issubclass(rd.ComposeNotAligned, ValueError)


def _bad_source():
    yield 1
    yield 2
    raise ValueError("source failed")


def _bad_mapper(x):
    if x == 5:
        raise ValueError("mapper failed")
    return x


WORKER_ERRORS = {
    "buffered": lambda rd: rd.buffered(_bad_source, 1),
    "xmap_source": lambda rd: rd.xmap_readers(lambda x: x, _bad_source, 2,
                                              2),
    "xmap_mapper": lambda rd: rd.xmap_readers(_bad_mapper, r10, 2, 2,
                                              order=True),
}


@pytest.mark.parametrize("case", sorted(WORKER_ERRORS))
def test_worker_errors_reraise_in_the_consumer(case):
    for _, rd, _, _, _, _ in PKGS.values():
        with pytest.raises(ValueError, match="failed"):
            list(WORKER_ERRORS[case](rd)())


def test_multiprocess_reader_streams_and_worker_errors():
    for _, rd, _, _, _, _ in PKGS.values():
        got = list(rd.multiprocess_reader(
            [helpers.range_reader, helpers.tens_reader], queue_size=8,
            get_timeout_s=0.5)())
        assert sorted(got) == [0, 1, 2, 3, 10, 11, 12, 13]
        with pytest.raises(ValueError, match="on purpose"):
            list(rd.multiprocess_reader([helpers.failing_reader],
                                        get_timeout_s=0.5)())
        with pytest.raises(ValueError, match="at least one"):
            rd.multiprocess_reader([])


def test_multiprocess_reader_detects_a_killed_worker():
    import os
    import signal
    tflags.flag_handle("enable_monitor").value = True
    it = trd.multiprocess_reader([helpers.pid_then_hang_reader],
                                 queue_size=4, get_timeout_s=0.3)()
    pid = next(it)
    assert isinstance(pid, int) and pid != os.getpid()
    os.kill(pid, signal.SIGKILL)
    with pytest.raises(trd.ReaderWorkerDied, match="exit code"):
        next(it)
    assert tmon.get_stats_snapshot()["counters"]["reader.worker_deaths"] == 1


# -- DataFeeder, DataLoader, PyReader --------------------------------------

def _samples(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.uniform(-1, 1, 784).astype(np.float32),
             int(rng.randint(0, 10)), rng.randn(3).tolist())
            for _ in range(n)]


def _vars(f):
    img = f.layers.data("img", shape=[1, 28, 28], dtype="float32")
    label = f.layers.data("label", shape=[1], dtype="int64")
    aux = f.layers.data("aux", shape=[3], dtype="float64")
    return [img, label, aux]


def _in_program(f, fn):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        return fn(f, _vars(f)), main


def assert_feeds_equal(got_t, got_j):
    assert len(got_t) == len(got_j) > 0
    for ft_, fj_ in zip(got_t, got_j):
        assert sorted(ft_) == sorted(fj_)
        for k in fj_:
            t, j = np.asarray(ft_[k]), np.asarray(fj_[k])
            assert t.dtype == j.dtype and t.shape == j.shape, k
            np.testing.assert_array_equal(t, j)


def test_data_feeder_matches_jax():
    samples = _samples()
    got = {name: _in_program(f, lambda f, vs: [
        f.DataFeeder(vs).feed(samples),
        f.DataFeeder(["img", "label"], program=f.default_main_program())
        .feed([s[:2] for s in samples])])[0]
        for name, (f, *_) in PKGS.items()}
    assert_feeds_equal(got["torch"], got["jax"])
    assert got["torch"][0]["img"].shape == (10, 1, 28, 28)
    assert got["torch"][0]["label"].shape == (10, 1)


def _batches(n=12, bs=4):
    rng = np.random.RandomState(1)
    return [(rng.randn(bs, 1, 28, 28).astype(np.float32),
             rng.randint(0, 10, (bs, 1)).astype(np.int64),
             rng.randn(bs, 3)) for _ in range(n)]


LOADER_CASES = {
    "sample_generator": lambda f, vs: f.io.DataLoader.from_generator(
        feed_list=vs, capacity=2).set_sample_generator(
            lambda: iter(_samples(11)), 4, drop_last=False),
    "sample_list_generator": lambda f, vs: f.DataLoader.from_generator(
        feed_list=vs, capacity=3).set_sample_list_generator(
            f.io.batch(lambda: iter(_samples(11)), 4, drop_last=True)),
    "batch_generator": lambda f, vs: f.DataLoader.from_generator(
        feed_list=vs).set_batch_generator(lambda: iter(_batches())),
    "batch_dicts": lambda f, vs: f.DataLoader.from_generator(
        feed_list=vs).set_batch_generator(
            lambda: ({"img": b[0], "label": b[1]} for b in _batches())),
    "py_reader_samples": lambda f, vs: f.PyReader(
        feed_list=vs, capacity=2).decorate_sample_generator(
            lambda: iter(_samples(9)), 3),
    "py_reader_lists": lambda f, vs: f.io.PyReader(
        feed_list=vs).decorate_sample_list_generator(
            f.io.batch(lambda: iter(_samples(9)), 2)),
    "py_reader_batches": lambda f, vs: f.PyReader(
        feed_list=vs).decorate_batch_generator(lambda: iter(_batches(5))),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_feeds_and_stats_match_jax(case):
    _set("enable_monitor", True)
    got, stats = {}, {}
    for name, (f, _, mon, _, _, _) in PKGS.items():
        loader, _ = _in_program(f, LOADER_CASES[case])
        got[name] = [list(loader), list(loader())]
        snap = mon.get_stats_snapshot()
        stats[name] = (snap["counters"].get("reader.batches"),
                       snap["histograms"]["reader.batch_wait_seconds"]
                       ["count"], "reader.queue_depth" in snap["gauges"])
    for t, j in zip(got["torch"], got["jax"]):
        assert_feeds_equal(t, j)
    assert stats["torch"] == stats["jax"]
    assert stats["torch"][0] == 2 * len(got["torch"][0])


def test_injected_reader_stall_is_input_wait():
    """Every batch waits on the injected 30 ms stall, above the 10 ms
    starvation bar, in both packages."""
    _set("enable_monitor", True)
    _set("enable_goodput", True)
    _set("goodput_starved_ms", 10.0)
    _set("fault_spec", "slow_step:ms=30:site=reader")
    verdicts = {}
    for name, (f, _, mon, good, _, _) in PKGS.items():
        loader, _ = _in_program(f, LOADER_CASES["batch_generator"])
        good.start_run("reader")
        n = sum(1 for _ in loader)
        snap = good.end_run()
        stats = mon.get_stats_snapshot()
        wait = snap["categories"]["input_wait"]
        assert wait >= n * 0.030
        assert stats["histograms"]["reader.batch_wait_seconds"]["sum"] >= \
            n * 0.030
        verdicts[name] = (n, snap["input_batches"], snap["starved_steps"],
                          stats["counters"]["goodput.input_starved_steps"],
                          stats["counters"]["reader.batches"])
        good.reset()
    assert verdicts["torch"] == verdicts["jax"] == (12,) * 5


def test_loader_generator_error_reraises():
    def bad():
        yield _batches(1)[0]
        raise ValueError("generator failed")

    for f, *_ in PKGS.values():
        loader, _ = _in_program(f, lambda f, vs: f.DataLoader.from_generator(
            feed_list=vs).set_batch_generator(bad))
        with pytest.raises(ValueError, match="generator failed"):
            list(loader)


def test_queue_depth_flag_and_from_dataset():
    assert tflags.FLAGS.reader_queue_depth == \
        jflags.FLAGS.reader_queue_depth == 2
    _set("reader_queue_depth", 1)
    loader, _ = _in_program(ft, LOADER_CASES["batch_generator"])
    assert loader.capacity is None and len(list(loader)) == 12
    with pytest.raises(NotImplementedError, match="A8"):
        ft.io.DataLoader.from_dataset(object())


def test_lod_feeds_match_jax():
    """data(lod_level=2) raises in both packages; DataFeeder over a
    lod_level=1 var gives the JAX package's LoDTensor (offsets and
    data)."""
    rows = [(np.arange(n).reshape(n, 1) + 3 * n, [n % 2])
            for n in (3, 1, 5)]
    got = []
    for f in (fj, ft):
        main = f.Program()
        with f.program_guard(main, f.Program()):
            with pytest.raises(NotImplementedError, match="lod_level>=2"):
                f.layers.data("deep", [1], dtype="int64", lod_level=2)
            words = f.layers.data("words", [1], dtype="int64", lod_level=1)
            label = f.layers.data("label", [1], dtype="int64")
        assert main.lod_link == {"words": "words.lengths"}
        got.append(f.DataFeeder([words, label], program=main).feed(rows))
    (jw, jl), (tw, tl) = [(g["words"], g["label"]) for g in got]
    assert type(tw).__name__ == "LoDTensor"
    assert tw.lod() == jw.lod() == [[0, 3, 4, 9]]
    assert tw.recursive_sequence_lengths() == [[3, 1, 5]]
    np.testing.assert_array_equal(tw.numpy_value(), jw.numpy_value())
    np.testing.assert_array_equal(tl, jl)


def _in_program_readers(f):
    main, startup = f.Program(), f.Program()
    with f.program_guard(main, startup), f.unique_name.guard():
        r = f.layers.py_reader(capacity=4, shapes=[[-1, 784], [-1, 1]],
                               dtypes=["float32", "int64"], name="train")
        img, label = f.layers.read_file(f.layers.double_buffer(r))
        x = f.layers.data("x", [3])
        r2 = f.layers.create_py_reader_by_data(2, [x])
        assert f.layers.read_file(r2) is x
        pred = f.layers.fc(img, 10, act="softmax")
        loss = f.layers.mean(f.layers.cross_entropy(pred, label))
    r.decorate_sample_list_generator(
        f.io.batch(lambda: ((s[0], s[1]) for s in _samples(8)), 4))
    return main, r, loss


def test_py_reader_program_and_feeds_match_jax():
    (mj, rj, _), (mt, rt, _) = [_in_program_readers(f) for f in (fj, ft)]
    assert mt.to_json() == mj.to_json()
    assert [v.name for v in rt.feed_list] == \
        ["train_slot0_0", "train_slot1_0"]
    assert_feeds_equal(list(rt), list(rj))


# -- the slice as a whole --------------------------------------------------

def _mnist_fc(f):
    main, startup = f.Program(), f.Program()
    startup.random_seed = 11
    with f.program_guard(main, startup), f.unique_name.guard():
        img = f.layers.data("img", shape=[1, 28, 28], dtype="float32")
        label = f.layers.data("label", shape=[1], dtype="int64")
        hidden = f.layers.fc(img, 32, act="relu")
        pred = f.layers.fc(hidden, 10, act="softmax")
        loss = f.layers.mean(f.layers.cross_entropy(pred, label))
        acc = f.layers.accuracy(pred, label)
        f.optimizer.Adam(1e-3).minimize(loss)
    loader = f.io.DataLoader.from_generator(feed_list=[img, label],
                                            capacity=4)
    loader.set_sample_list_generator(
        f.io.batch(f.datasets.mnist.train(), 32, drop_last=True))
    return main, startup, loader, loss, acc


def test_mnist_fc_through_both_loaders():
    mj, sj, lj, loss_j, acc_j = _mnist_fc(fj)
    mt, st, lt, loss_t, acc_t = _mnist_fc(ft)
    assert mt.to_json() == mj.to_json() and st.to_json() == sj.to_json()
    scope_j = fj.Scope()
    got_j = []
    with fj.scope_guard(scope_j):
        exe = fj.Executor(fj.CPUPlace())
        exe.run(sj)
        params = {n: np.asarray(scope_j.get(n)) for n in scope_j.names()
                  if scope_j.find_var(n) is not None}
        for step, feed in zip(range(3), lj):
            got_j.append(exe.run(mj, feed=feed, fetch_list=[loss_j, acc_j]))
    scope_t = scope_from_numpy(params, ft.Scope(), ft.CPUPlace(), program=mt)
    exe_t = ft.Executor(ft.CPUPlace())
    got_t = [exe_t.run(mt, feed=feed, fetch_list=[loss_t, acc_t],
                       scope=scope_t)
             for _, feed in zip(range(3), lt)]
    loss = np.array([[float(np.asarray(o[0]).reshape(-1)[0])
                      for o in g] for g in (got_t, got_j)])
    np.testing.assert_allclose(loss[0], loss[1], rtol=1e-5)
    np.testing.assert_array_equal(
        [float(np.asarray(o[1]).reshape(-1)[0]) for o in got_t],
        [float(np.asarray(o[1]).reshape(-1)[0]) for o in got_j])
    assert np.isfinite(loss).all()
