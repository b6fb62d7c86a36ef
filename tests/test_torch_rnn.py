"""The port's RNN ops and layers against the JAX package's, on the CPU.

- The op types of ops/rnn_ops.py with data inputs one by one on seeded
  inputs, with gradients (floats within 1e-5 of max(1, |JAX|), the rest
  exact): gru and lstm (lengths, reverse, initial states, peepholes, the
  projection of dynamic_lstmp), lstm_unit, beam_search (a finished beam
  among them), beam_reorder, gather_tree, beam_search_decode; recurrent
  through the layers that emit it.
- Every layer of layers/rnn.py through programs trained two SGD steps:
  dynamic_gru, dynamic_lstm, dynamic_lstmp, gru_unit, lstm_unit, lstm
  (two layers, bidirectional), rnn over GRUCell and LSTMCell (with
  sequence_length, reversed, time-major), birnn. JSON and fingerprint
  equal to the JAX package's; losses and parameters within 1e-5.
- Beam search: the seq2seq encoder, the attention decoder cell over a
  beam-tiled encoder output and dynamic_decode (beam 4, 12 steps) from
  one state give the JAX package's ids exactly and its scores within
  1e-5.
- The JAX package's book models at tests/test_models.py's sizes, three
  Adam steps from its startup state: the seq2seq translator (hidden 32,
  vocab 200, T 12; losses within 1e-5, parameters within 1e-4 Frobenius
  over norm) and the ragged sentiment LSTM fed through DataFeeder
  (losses within 1e-5).
"""
import warnings

import numpy as np
import pytest

import paddle_tpu as fj
import paddle_tpu_torch as ft
from torch_dense_helpers import compare_op
from torch_seq_helpers import (assert_close, build_both, fro, run_both)

TOL = 1e-5


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.RandomState(seed).randn(*shape)).astype(
        np.float32)


LENS = np.asarray([5, 2, 4], np.int64)

OP_CASES = {
    "gru": ("gru", {"Input": [_rand(3, 5, 12)], "Weight": [_rand(4, 12, seed=1,
                                                                 scale=0.5)],
                    "Bias": [_rand(1, 12, seed=2)], "Lengths": [LENS]},
            {}, {"Hidden": 1}, ["Input", "Weight", "Bias"]),
    "gru_reverse_h0": ("gru", {"Input": [_rand(3, 5, 12)],
                               "Weight": [_rand(4, 12, seed=1, scale=0.5)],
                               "H0": [_rand(3, 4, seed=3)]},
                       {"is_reverse": True, "origin_mode": True,
                        "activation": "relu"}, {"Hidden": 1},
                       ["Input", "Weight", "H0"]),
    "lstm_peepholes": ("lstm", {"Input": [_rand(3, 5, 16)],
                                "Weight": [_rand(4, 16, seed=1, scale=0.5)],
                                "Bias": [_rand(1, 28, seed=2)],
                                "Lengths": [LENS]}, {},
                       {"Hidden": 1, "Cell": 1}, ["Input", "Weight", "Bias"]),
    "lstm_reverse_states": ("lstm", {"Input": [_rand(3, 5, 16)],
                                     "Weight": [_rand(4, 16, seed=1,
                                                      scale=0.5)],
                                     "Bias": [_rand(1, 16, seed=2)],
                                     "H0": [_rand(3, 4, seed=3)],
                                     "C0": [_rand(3, 4, seed=4)]},
                            {"use_peepholes": False, "is_reverse": True},
                            {"Hidden": 1, "Cell": 1},
                            ["Input", "Weight", "H0", "C0"]),
    "lstmp": ("lstm", {"Input": [_rand(3, 5, 16)],
                       "Weight": [_rand(3, 16, seed=1, scale=0.5)],
                       "Bias": [_rand(1, 28, seed=2)],
                       "ProjWeight": [_rand(4, 3, seed=5)],
                       "Lengths": [LENS]}, {"proj_activation": "tanh"},
              {"Hidden": 1, "Cell": 1},
              ["Input", "Weight", "Bias", "ProjWeight"]),
    "lstm_unit": ("lstm_unit", {"X": [_rand(3, 16)],
                                "C_prev": [_rand(3, 4, seed=1)]},
                  {"forget_bias": 0.5}, {"C": 1, "H": 1}, ["X", "C_prev"]),
    "beam_search": ("beam_search",
                    {"pre_ids": [np.asarray([[3, 1, 4], [2, 2, 0]])],
                     "pre_scores": [_rand(2, 3, seed=1)],
                     "scores": [_rand(2, 3, 7, seed=2)]},
                    {"end_id": 1, "beam_size": 3},
                    {"selected_ids": 1, "selected_scores": 1,
                     "parent_idx": 1}, ["scores"]),
    "beam_reorder": ("beam_reorder",
                     {"X": [_rand(2, 3, 4)],
                      "Index": [np.asarray([[2, 2, 0], [1, 0, 1]],
                                           np.int32)]}, {}, {"Out": 1},
                     ["X"]),
    "gather_tree": ("gather_tree",
                    {"Ids": [np.random.RandomState(1).randint(
                        0, 9, (4, 2, 3))],
                     "Parents": [np.random.RandomState(2).randint(
                         0, 3, (4, 2, 3))]}, {}, {"Out": 1}, []),
    "beam_search_decode": ("beam_search_decode",
                           {"Ids": [np.arange(24).reshape(4, 2, 3)],
                            "Scores": [_rand(4, 2, 3)]},
                           {"beam_size": 3, "end_id": 1},
                           {"SentenceIds": 1, "SentenceScores": 1}, []),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_against_jax(case):
    op_type, ins, attrs, outs, grads = OP_CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        compare_op(op_type, ins, attrs, outs, grads, tol=TOL)


def _train(body):
    def fn(f):
        L = f.layers
        x = L.data("x", shape=[6, 5], dtype="float32")
        outs = body(f, L, x)
        loss = L.mean(L.concat([L.reduce_mean(o, dim=list(range(
            1, len(o.shape)))) for o in outs], axis=0))
        f.optimizer.SGD(0.5).minimize(loss)
        return [loss] + outs
    return fn


def _lens(f):
    return f.layers.data("lens", shape=[], dtype="int64")


def _dyn_gru(f, L, x):
    proj = L.fc(x, size=12, num_flatten_dims=2)
    return [L.dynamic_gru(proj, 4, sequence_length=_lens(f)),
            L.dynamic_gru(proj, 4, is_reverse=True, origin_mode=True)]


def _dyn_lstm(f, L, x):
    proj = L.fc(x, size=16, num_flatten_dims=2)
    h, c = L.dynamic_lstm(proj, 16, sequence_length=_lens(f))
    h2, _ = L.dynamic_lstm(proj, 16, use_peepholes=False, is_reverse=True)
    hp, cp = L.dynamic_lstmp(proj, 16, proj_size=3)
    return [h, c, h2, hp, cp]


def _units(f, L, x):
    first = L.slice(x, axes=[1], starts=[0], ends=[1])
    x0 = L.reshape(first, [-1, 5])
    h0 = L.fc(x0, size=4, act="tanh")
    h, _, gate = L.gru_unit(L.fc(x0, size=12), h0, 12)
    h2, c2 = L.lstm_unit(x0, h0, h0, forget_bias=1.0)
    return [h, gate, h2, c2]


def _stacked_lstm(f, L, x):
    out, last_h, last_c = L.lstm(x, None, None, max_len=6, hidden_size=4,
                                 num_layers=2, is_bidirec=True)
    return [out, last_h, last_c]


def _cells(f, L, x):
    out_g, h_g = L.rnn_fn(L.GRUCell(4), x, sequence_length=_lens(f))
    out_l, (h_l, c_l) = L.rnn_fn(L.LSTMCell(4), x, is_reverse=True)
    xt = L.transpose(x, [1, 0, 2])
    h0 = L.fill_constant_batch_size_like(x, [-1, 3], "float32", 0.0)
    out_t, _ = L.rnn_fn(L.GRUCell(3, name="tm"), xt, initial_states=h0,
                        time_major=True)
    out_b, _ = L.birnn(L.GRUCell(3, name="fw"), L.GRUCell(3, name="bw"), x)
    return [out_g, h_g, out_l, h_l, c_l, out_t, out_b]


LAYERS = {"dynamic_gru": _dyn_gru, "dynamic_lstm": _dyn_lstm,
          "units": _units, "lstm": _stacked_lstm, "cells": _cells}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layers_against_jax(name):
    bj, bt = build_both(_train(LAYERS[name]))
    feed = {"x": _rand(3, 6, 5, seed=9), "lens": np.asarray([6, 3, 4])}
    fetch = [v.name for v in bt[2]]
    got_j, got_t, after_j, after_t = run_both(bj, bt, [feed] * 2, fetch)
    for gj, gt in zip(got_j, got_t):
        assert_close(gt, gj, TOL)
    for n in after_j:
        assert_close([after_t[n]], [after_j[n]], TOL)


def _beam(f):
    from importlib import import_module
    s2s = import_module(f.__name__ + ".models.seq2seq")
    L = f.layers
    src = L.data("src_ids", shape=[3, 12], dtype="int64",
                 append_batch_size=False)
    enc = s2s.encoder(src, 50, hidden=16, emb_dim=16)
    rnn = L.rnn
    enc_b = rnn.BeamSearchDecoder.tile_beam_merge_with_batch(enc, 4)
    proj = L.fc(enc_b, size=16, num_flatten_dims=2)
    cell = s2s.AttentionDecoderCell(16, enc_b, proj)
    emb_w = L.create_parameter([50, 16], "float32", name="trg_emb")

    def embed(ids):
        return L.embedding(L.unsqueeze(ids, [1]), size=[50, 16],
                           param_attr=f.ParamAttr(name="trg_emb"))

    dec = rnn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                                beam_size=4, embedding_fn=embed,
                                output_fn=lambda h: L.fc(h, size=50))
    init = L.fc(L.reduce_mean(enc, dim=1), size=16, act="tanh")
    ids, scores, lens = rnn.dynamic_decode(dec, inits=init,
                                           max_step_num=12,
                                           return_length=True)
    assert emb_w is not None
    return [ids, scores, lens]


def test_beam_search_decode_against_jax():
    bj, bt = build_both(_beam)
    src = np.random.RandomState(4).randint(2, 50, (3, 12))
    fetch = [v.name for v in bt[2]]
    got_j, got_t, _, _ = run_both(bj, bt, [{"src_ids": src}], fetch)
    np.testing.assert_array_equal(got_t[0][0], got_j[0][0])
    np.testing.assert_array_equal(got_t[0][2], got_j[0][2])
    assert_close([got_t[0][1]], [got_j[0][1]], TOL)
    assert got_t[0][0].shape == (3, 12, 4)


def _seq2seq(f):
    from importlib import import_module
    s2s = import_module(f.__name__ + ".models.seq2seq")
    loss, _ = s2s.build_train(src_vocab=200, trg_vocab=200, src_len=12,
                              trg_len=12, hidden=32, emb_dim=32, lr=0.02)
    return [loss]


def test_seq2seq_three_steps_against_jax():
    bj, bt = build_both(_seq2seq)
    rng = np.random.RandomState(0)
    feed = {k: rng.randint(0, 200, (8, 12)).astype(np.int64)
            for k in ("src_ids", "trg_in", "trg_next")}
    got_j, got_t, after_j, after_t = run_both(bj, bt, [feed] * 3,
                                              [bt[2][0].name])
    for gj, gt in zip(got_j, got_t):
        assert_close(gt, gj, TOL)
    assert got_t[2][0] < got_t[0][0]
    for p in bt[0].all_parameters():
        assert fro(after_t[p.name], after_j[p.name]) < 1e-4, p.name


def _sentiment(f):
    L = f.layers
    words = L.data("sent_words", shape=[1], dtype="int64", lod_level=1)
    label = L.data("sent_label", shape=[1], dtype="int64")
    emb = L.embedding(words, size=[64, 16])
    proj = L.fc(emb, size=64, num_flatten_dims=2)
    h, _ = L.dynamic_lstm(proj, size=64)
    feat = L.concat([L.sequence_pool(h, "max"), L.sequence_last_step(h)],
                    axis=1)
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(feat, size=2), label))
    f.optimizer.Adam(learning_rate=5e-3).minimize(loss)
    return [loss, words, label]


def test_sentiment_lstm_ragged_three_steps_against_jax():
    bj, bt = build_both(_sentiment)
    rng = np.random.RandomState(7)
    rows = [(rng.randint(0, 64, (rng.randint(3, 12), 1)), [i % 2])
            for i in range(16)]
    feeds = [f.DataFeeder(feed_list=b[2][1:], program=b[0]).feed(rows)
             for f, b in ((fj, bj), (ft, bt))]
    got_j, _, after_j, _ = run_both(bj, bt, [feeds[0]] * 3,
                                    [bt[2][0].name])
    _, got_t, _, after_t = run_both(bj, bt, [feeds[1]] * 3,
                                    [bt[2][0].name])
    for gj, gt in zip(got_j, got_t):
        assert_close(gt, gj, TOL)
    for p in bt[0].all_parameters():
        assert fro(after_t[p.name], after_j[p.name]) < 1e-4, p.name


def test_chip_smoke_beam_program_reads_the_trained_parameters(monkeypatch):
    """chip_smoke's [seq2seq_beam] program, built from public entry
    points after [seq2seq_train]'s, names only parameters the training
    program made, each of the training program's shape."""
    from torch_dense_helpers import chip_smoke as c
    for k, v in {"S2S_VOCAB": 60, "S2S_LEN": 6, "S2S_HIDDEN": 8,
                 "S2S_EMB": 4, "S2S_BEAM": 3}.items():
        monkeypatch.setattr(c, k, v)
    train, _, _ = c.build_seq2seq(ft)
    beam, fetch = c.build_seq2seq_beam(ft, 2)
    shapes = {p.name: p.shape for p in train.all_parameters()}
    used = {p.name: p.shape for p in beam.all_parameters()}
    assert used and all(shapes.get(n) == s for n, s in used.items())
    assert len(fetch) == 5


def test_chip_smoke_beam_flip_rule():
    """beam_flips: equal beams give none; a first differing step is a
    flip with the largest gap of that step's selected scores."""
    from torch_dense_helpers import chip_smoke as c
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 9, (2, 5, 3))
    scores = rng.randn(2, 5, 3)
    par = rng.randint(0, 3, (2, 5, 3))
    out = [ids, scores, None, ids, par]
    assert c.beam_flips(out, out) == []
    sel2, sc2 = ids.copy(), scores.copy()
    sel2[1, 3, 0] += 1
    sc2[1, 3, 1] += 5e-5
    flips = c.beam_flips(out, [ids, sc2, None, sel2, par])
    assert [(b, t) for b, t, _ in flips] == [(1, 3)]
    assert abs(flips[0][2] - 5e-5) < 1e-9
