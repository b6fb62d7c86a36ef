"""The port's ragged sequences against the JAX package's, on the CPU.

- LoDTensor: offsets, lengths, to_padded (also to a multiple of 8).
- The ragged feed path of Executor.run: a LoDTensor is padded to a
  multiple of 8 and its lengths go to the var's companion without the
  caller naming it; a plain array fed to a ragged var gets full lengths;
  a LoDTensor fed to a var with no companion warns; the rank check skips
  ragged vars. DataFeeder makes LoDTensors of ragged fields.
- The 29 op types of ops/sequence_ops.py and ops/sequence_extra.py one
  by one on seeded inputs, with gradients where they differentiate
  (floats within 1e-6 of max(1, |JAX|), the rest exact).
- The sequence layers and nets.sequence_conv_pool through programs fed
  ragged batches: JSON and fingerprint equal to the JAX package's (for
  sequence_conv_pool, which raises there, to the program of its
  sequence_conv and sequence_pool), fetches within 1e-5.
"""
import warnings

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from torch_dense_helpers import compare_op
from torch_seq_helpers import assert_close, build, build_both, run_both

TOL = 1e-5


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


LENS = np.asarray([3, 5, 1], np.int64)


def test_lod_tensor_against_jax():
    rows = [np.arange(n * 2, dtype=np.float32).reshape(n, 2) for n in LENS]
    tj = fj.LoDTensor.from_ragged(rows)
    tt = ft.LoDTensor.from_ragged(rows)
    assert tt.lod() == tj.lod() == [[0, 3, 8, 9]]
    assert tt.recursive_sequence_lengths() == [[3, 5, 1]]
    assert tt.has_valid_recursive_sequence_lengths()
    assert tt.shape() == [9, 2]
    for mult in (1, 8):
        pj, lj = tj.to_padded(multiple=mult)
        pt, lt = tt.to_padded(multiple=mult)
        assert pt.shape == (3, 5 if mult == 1 else 8, 2)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(lt, lj)
    t2 = ft.LoDTensor()
    t2.set(np.zeros((4, 1)), ft.CPUPlace())
    t2.set_recursive_sequence_lengths([[1, 3]])
    assert t2.lod() == [[0, 1, 4]]
    assert ft.LoDTensor(np.ones(3)).to_padded()[1] is None
    assert isinstance(ft.LoDTensorArray(), list)


def _pool_prog(f):
    L = f.layers
    w = L.data("w", shape=[1], dtype="int64", lod_level=1)
    emb = L.embedding(w, size=[20, 6])
    return [L.sequence_pool(emb, "sum"), emb]


def _ragged(n=(3, 5, 1), vocab=20, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (k, 1)).astype(np.int64) for k in n]


def test_feed_pads_to_eight_and_feeds_the_companion():
    bj, bt = build_both(_pool_prog)
    feed_t = {"w": ft.LoDTensor.from_ragged(_ragged(), "int64")}
    feed_j = {"w": fj.LoDTensor.from_ragged(_ragged(), "int64")}
    fetch = [bt[2][0].name, bt[2][1].name, "w.lengths"]
    got_j, got_t, _, _ = run_both(bj, bt, [feed_j], fetch)
    assert got_t[0][1].shape == (3, 8, 6)
    np.testing.assert_array_equal(got_t[0][2], LENS)
    assert_close(got_t[0], got_j[0], TOL)
    # the same fetches from a feed that names the companion itself
    _, got_t2, _, _ = run_both(bj, bt, [{"w": feed_t["w"],
                                         "w.lengths": LENS}], fetch)
    assert_close(got_t2[0], got_j[0], TOL)


def test_dense_feed_of_a_ragged_var_gets_full_lengths():
    bj, bt = build_both(_pool_prog)
    ids = np.random.RandomState(1).randint(0, 20, (2, 4, 1))
    got_j, got_t, _, _ = run_both(bj, bt, [{"w": ids}],
                                  [bt[2][0].name, "w.lengths"])
    np.testing.assert_array_equal(got_t[0][1], [4, 4])
    assert_close(got_t[0], got_j[0], TOL)


def test_lod_feed_without_a_companion_warns():
    def prog(f):
        x = f.layers.data("x", shape=[-1, 2], dtype="float32")
        return [f.layers.scale(x, scale=2.0)]

    _, (mt, _, outs) = build_both(prog)
    t = ft.LoDTensor.from_ragged([np.ones((2, 2)), np.ones((3, 2))])
    with pytest.warns(UserWarning, match="declares no lengths var"):
        out = ft.Executor(ft.CPUPlace()).run(
            mt, feed={"x": t}, fetch_list=[outs[0].name], scope=ft.Scope())
    assert out[0].shape == (2, 8, 2)


def test_data_feeder_ragged_fields_against_jax():
    rows = [(r, [i % 2]) for i, r in enumerate(_ragged())]
    out = []
    for f in (fj, ft):
        main = f.Program()
        with f.program_guard(main, f.Program()):
            w = f.layers.data("w", [1], dtype="int64", lod_level=1)
            y = f.layers.data("y", [1], dtype="int64")
        out.append(f.DataFeeder([w, y], program=main).feed(rows))
    assert out[1]["w"].lod() == out[0]["w"].lod()
    np.testing.assert_array_equal(out[1]["w"].numpy_value(),
                                  out[0]["w"].numpy_value())
    np.testing.assert_array_equal(out[1]["y"], out[0]["y"])


X3 = _rand(3, 6, 4)
L3 = np.asarray([4, 6, 2], np.int64)
IDS = np.random.RandomState(2).randint(0, 9, (3, 6)).astype(np.int64)

OP_CASES = {
    "sequence_mask": ("sequence_mask", {"X": [L3]},
                      {"maxlen": 7, "out_dtype": "float32"}, {"Y": 1}, []),
    "sequence_pool_sum": ("sequence_pool", {"X": [X3], "Lengths": [L3]},
                          {"pooltype": "SUM"}, {"Out": 1, "MaxIndex": 1},
                          ["X"]),
    "sequence_pool_avg": ("sequence_pool", {"X": [X3], "Lengths": [L3]},
                          {"pooltype": "AVERAGE"}, {"Out": 1}, ["X"]),
    "sequence_pool_sqrt": ("sequence_pool", {"X": [X3]},
                           {"pooltype": "SQRT"}, {"Out": 1}, ["X"]),
    "sequence_pool_max": ("sequence_pool", {"X": [X3], "Lengths": [L3]},
                          {"pooltype": "MAX"}, {"Out": 1}, ["X"]),
    "sequence_pool_last": ("sequence_pool", {"X": [X3], "Lengths": [L3]},
                           {"pooltype": "LAST"}, {"Out": 1}, ["X"]),
    "sequence_pool_first": ("sequence_pool", {"X": [X3]},
                            {"pooltype": "FIRST"}, {"Out": 1}, ["X"]),
    "sequence_softmax": ("sequence_softmax",
                         {"X": [X3[:, :, 0]], "Lengths": [L3]}, {},
                         {"Out": 1}, ["X"]),
    "sequence_reverse": ("sequence_reverse", {"X": [X3], "Lengths": [L3]},
                         {}, {"Y": 1}, ["X"]),
    "sequence_reverse_full": ("sequence_reverse", {"X": [X3]}, {},
                              {"Y": 1}, ["X"]),
    "sequence_pad": ("sequence_pad",
                     {"X": [X3], "PadValue": [np.asarray([0.5], np.float32)],
                      "Lengths": [L3]}, {"padded_length": 9},
                     {"Out": 1, "Length": 1}, ["X"]),
    "sequence_unpad": ("sequence_unpad", {"X": [X3], "Length": [L3]}, {},
                       {"Out": 1}, ["X"]),
    "sequence_expand_as": ("sequence_expand_as",
                           {"X": [X3[:, 0]], "Y": [X3]}, {}, {"Out": 1},
                           ["X"]),
    "im2sequence": ("im2sequence", {"X": [_rand(2, 3, 7, 6, seed=3)]},
                    {"kernels": [3, 2], "strides": [2, 1],
                     "paddings": [1, 0, 0, 1]}, {"Out": 1}, ["X"]),
    "sequence_concat": ("sequence_concat", {"X": [X3, X3[:, :2]]}, {},
                        {"Out": 1}, ["X"]),
    "sequence_conv": ("sequence_conv",
                      {"X": [X3], "Filter": [_rand(12, 5, seed=4)]},
                      {"contextLength": 3, "contextStart": -1}, {"Out": 1},
                      ["X", "Filter"]),
    "sequence_enumerate": ("sequence_enumerate", {"X": [IDS]},
                           {"win_size": 3, "pad_value": 7}, {"Out": 1}, []),
    "sequence_erase": ("sequence_erase", {"X": [IDS]}, {"tokens": [2, 5]},
                       {"Out": 1}, []),
    "sequence_expand": ("sequence_expand",
                        {"X": [X3[:, 0]], "Y": [_rand(6, 2)]}, {},
                        {"Out": 1}, ["X"]),
    "sequence_reshape": ("sequence_reshape", {"X": [X3]}, {"new_dim": 8},
                         {"Out": 1}, ["X"]),
    "sequence_scatter": ("sequence_scatter",
                         {"X": [X3[:, :, 0]], "Ids": [IDS[:, :3] % 6],
                          "Updates": [_rand(3, 3, seed=5)]}, {},
                         {"Out": 1}, ["X", "Updates"]),
    "sequence_slice": ("sequence_slice",
                       {"X": [X3], "Offset": [np.asarray([1, 0, 2])],
                        "Length": [np.asarray([2, 4, 3])]}, {}, {"Out": 1},
                       ["X"]),
    "sequence_topk_avg_pooling": ("sequence_topk_avg_pooling",
                                  {"X": [X3]}, {"topks": [1, 3]},
                                  {"Out": 1}, ["X"]),
    "match_matrix_tensor": ("match_matrix_tensor",
                            {"X": [X3], "Y": [_rand(3, 5, 4, seed=6)],
                             "W": [_rand(4, 2, 4, seed=7)]}, {}, {"Out": 1},
                            ["X", "Y", "W"]),
    "filter_by_instag": ("filter_by_instag",
                         {"Ins": [X3[:, 0]], "Ins_tag": [IDS[:, :2]],
                          "Filter_tag": [np.asarray([2, 3])]}, {},
                         {"Out": 1, "LossWeight": 1, "IndexMap": 1},
                         ["Ins"]),
    "lod_reset": ("lod_reset", {"X": [X3]}, {}, {"Out": 1}, ["X"]),
    "lod_rank_table": ("lod_rank_table", {"X": [X3]}, {}, {"Out": 1}, []),
    "max_sequence_len": ("max_sequence_len",
                         {"RankTable": [np.arange(3)]}, {}, {"Out": 1}, []),
    "lod_tensor_to_array": ("lod_tensor_to_array", {"X": [X3]}, {},
                            {"Out": 1}, ["X"]),
    "array_to_lod_tensor": ("array_to_lod_tensor", {"X": [X3]}, {},
                            {"Out": 1}, ["X"]),
    "reorder_lod_tensor_by_rank": ("reorder_lod_tensor_by_rank",
                                   {"X": [X3],
                                    "RankTable": [np.asarray([2, 0, 1])]},
                                   {}, {"Out": 1}, ["X"]),
    "split_lod_tensor": ("split_lod_tensor",
                         {"X": [X3], "Mask": [np.asarray([[1], [0], [1]])]},
                         {}, {"OutTrue": 1, "OutFalse": 1}, ["X"]),
    "merge_lod_tensor": ("merge_lod_tensor",
                         {"InTrue": [X3], "InFalse": [-X3],
                          "Mask": [np.asarray([[1], [0], [1]])]}, {},
                         {"Out": 1}, ["InTrue", "InFalse"]),
    "shrink_rnn_memory": ("shrink_rnn_memory",
                          {"X": [X3], "I": [np.asarray([1])],
                           "RankTable": [np.arange(3)]}, {}, {"Out": 1},
                          ["X"]),
    "rnn_memory_helper": ("rnn_memory_helper", {"X": [X3]}, {}, {"Out": 1},
                          ["X"]),
}


def test_op_cases_cover_the_29_op_types():
    assert len({c[0] for c in OP_CASES.values()}) == 29


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_against_jax(case):
    op_type, ins, attrs, outs, grads = OP_CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        compare_op(op_type, ins, attrs, outs, grads)


def _layers_prog(f):
    L = f.layers
    w = L.data("w", shape=[1], dtype="int64", lod_level=1)
    emb = L.embedding(w, size=[20, 6])
    h = L.fc(emb, size=6, num_flatten_dims=2, act="tanh")
    pooled = [L.sequence_pool(h, t) for t in
              ("sum", "average", "sqrt", "max", "last", "first")]
    sm = L.sequence_softmax(L.reduce_sum(h, dim=2))
    rev = L.sequence_reverse(h)
    conv = L.sequence_conv(h, num_filters=5, filter_size=3, act="relu")
    pad_v = L.fill_constant([1], "float32", 0.0)
    padded, length = L.sequence_pad(h, pad_v, maxlen=10)
    unpadded = L.sequence_unpad(padded, length)
    un_pool = L.sequence_pool(unpadded, "sum")
    first = L.sequence_first_step(h)
    last = L.sequence_last_step(h)
    exp_as = L.sequence_expand_as(first, h)
    cat = L.sequence_concat([h, rev])
    resh = L.sequence_reshape(h, new_dim=3)
    mask = L.sequence_mask(f.default_main_program().global_block().var(
        "w.lengths"), maxlen=8, dtype="float32")
    loss = L.mean(L.concat(pooled + [un_pool, first, last], axis=1))
    f.optimizer.SGD(0.3).minimize(loss)
    return [loss, sm, rev, conv, padded, length, unpadded, exp_as, cat,
            resh, mask] + pooled


def _conv_pool(f):
    L = f.layers
    w = L.data("w", shape=[1], dtype="int64", lod_level=1)
    emb = L.embedding(w, size=[20, 6])
    if f is ft:
        out = ft.nets.sequence_conv_pool(emb, num_filters=4, filter_size=3,
                                         act="tanh", pool_type="max")
    else:
        conv = L.sequence_conv(emb, 4, filter_size=3, act="tanh")
        out = L.sequence_pool(conv, "max", lengths=f.default_main_program()
                              .global_block().var("w.lengths"))
    loss = L.mean(out)
    f.optimizer.SGD(0.3).minimize(loss)
    return [loss, out]


@pytest.mark.parametrize("name", ["layers", "sequence_conv_pool"])
def test_sequence_layers_against_jax(name):
    fn = {"layers": _layers_prog, "sequence_conv_pool": _conv_pool}[name]
    bj, bt = build_both(fn)
    assert bt[0].lod_link == bj[0].lod_link
    feeds_j = [{"w": fj.LoDTensor.from_ragged(_ragged(seed=s), "int64")}
               for s in (0, 1)]
    feeds_t = [{"w": ft.LoDTensor.from_ragged(_ragged(seed=s), "int64")}
               for s in (0, 1)]
    fetch = [v.name for v in bt[2]]
    got_j, _, after_j, _ = run_both(bj, bt, feeds_j, fetch)
    _, got_t, _, after_t = run_both(bj, bt, feeds_t, fetch)
    for gj, gt in zip(got_j, got_t):
        assert_close(gt, gj, TOL)
    for n in after_j:
        assert_close([after_t[n]], [after_j[n]], TOL)


def test_sequence_conv_pool_raises_in_jax_only():
    with pytest.raises(NotImplementedError):
        build(fj, lambda f: fj.nets.sequence_conv_pool(
            f.layers.data("w", [4], lod_level=1), 4, 3))
