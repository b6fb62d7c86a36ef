"""The CRF and CTC family (paddle_tpu_torch/ops/loss_extra.py, the
layers of layers/parity.py and layers.warpctc) against the JAX package.

Each op type runs through both packages' lowerings on the cases of
chip_smoke.crf_ctc_op_cases (lengths shorter than T, -1-padded labels,
CTC with a repeated label and a label longer than T/2, Viterbi ties),
forward and gradients: floats within 1e-6 of max(1, max|JAX|), the
recursions (warpctc, linear_chain_crf) within 1e-5, integers exactly.
sample_logits draws its classes (the JAX package draws with
jax.random): it is held to its formula on its own draws. The layers
build byte-identical programs in both packages, and the toy
label_semantic_roles of tests/test_models.py trains alike from the JAX
startup state.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.core.registry import REGISTRY as TREG
from torch_dense_helpers import chip_smoke, compare_op, torch_lower

CASES = chip_smoke.crf_ctc_op_cases()
RECURSION_TOL = 1e-5
SRL_RTOL = 1e-4


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if c != "sample_logits"))
def test_op_matches_jax(case):
    op_type, ins, attrs, outs, grads = CASES[case]
    tol = RECURSION_TOL if op_type in ("warpctc", "linear_chain_crf") \
        else 1e-6
    # cvm's gradient is its manual one (cvm_op.h): jax.grad of the JAX
    # lowering differentiates the forward instead, so the program-level
    # gradient, which runs the JAX package's manual_grad, holds it
    # (test_layers_build_equal_programs_and_run_alike)
    compare_op(op_type, ins, attrs, outs, () if op_type == "cvm" else grads,
               tol=tol)


def test_every_op_type_is_registered_alike():
    """The 12 op types in both registries with equal non-differentiable
    slots and flags, and every one of them has a case."""
    assert len(chip_smoke.CRF_CTC_OP_TYPES) == 12
    assert {c[0] for c in CASES.values()} == \
        set(chip_smoke.CRF_CTC_OP_TYPES)
    for op in chip_smoke.CRF_CTC_OP_TYPES:
        j, t = JREG.get(op), TREG.get(op)
        assert (j.nondiff_inputs, j.nondiff_outputs, j.stateful,
                j.inplace, j.version) == (
            t.nondiff_inputs, t.nondiff_outputs, t.stateful, t.inplace,
            t.version), op


def test_sample_logits_follows_its_formula():
    """The port's draws: true labels first, every draw in range, a drawn
    true class at -1e30, the rest Logits[row, id] - log(ns / N) (exact
    to 1e-6); the gradient reaches Logits at the kept ids only."""
    op_type, ins, attrs, outs, _ = CASES["sample_logits"]
    logits = torch.from_numpy(ins["Logits"][0].copy()).requires_grad_()
    out = torch_lower(op_type, {"Logits": [logits], "Labels": [
        torch.from_numpy(ins["Labels"][0])]}, attrs)
    got = [out[k][0].detach().numpy() for k in
           ("SampledLogits", "SampledLabels", "Samples", "Probabilities")]
    assert chip_smoke.sample_logits_gap(got, ins, attrs) <= 1e-6
    picked = out["SampledLogits"][0]
    keep = picked > -1e29
    (picked * keep).sum().backward()
    want = np.zeros_like(ins["Logits"][0])
    ids, kept = got[2], keep.numpy()
    for r in range(len(ids)):
        for j in np.nonzero(kept[r])[0]:
            want[r, ids[r, j]] += 1.0
    np.testing.assert_array_equal(logits.grad.numpy(), want)
    assert list(out["LogitsDim"][0].numpy()) == [4, 12]


def test_chunk_eval_counts_are_exact():
    """IOB, two chunk types (B-0 0, I-0 1, B-1 2, I-1 3, O 4): the
    case's chunks counted by hand. Row 0 (10 steps): label chunks
    (0-1, 0), (3-5, 1), (7, 0); the inference breaks (3-5) into (3),
    (4-5): 4 inferred, 2 correct. Row 1 (9 steps): label (0-1, 1),
    (3-5, 0), (7, 1), (8, 1); the inference has (4-5, 0) for (3-5, 0):
    3 correct of 4. Row 2 (7 steps): label (1-2, 0), (4-5, 1), (6, 0);
    the inference's I-0 at step 6 opens the same (6, 0) chunk after an
    I-1: 3 of 3. So 11 inferred, 10 labelled, 8 correct."""
    _, ins, attrs, outs, _ = CASES["chunk_eval"]
    out = torch_lower("chunk_eval", {k: [torch.from_numpy(v[0])]
                                     for k, v in ins.items()}, attrs)
    n_inf, n_lab, n_cor = (int(out[k][0]) for k in (
        "NumInferChunks", "NumLabelChunks", "NumCorrectChunks"))
    assert (n_inf, n_lab, n_cor) == (11, 10, 8)
    p, r = 8 / 11, 8 / 10
    assert float(out["Precision"][0]) == pytest.approx(p, abs=1e-7)
    assert float(out["Recall"][0]) == pytest.approx(r, abs=1e-7)
    assert float(out["F1-Score"][0]) == pytest.approx(
        2 * p * r / (p + r), abs=1e-7)
    assert out["NumInferChunks"][0].dtype == torch.int32


# -- the layers ---------------------------------------------------------------

B, T, N_TAGS, C = 3, 8, 4, 6


def _crf_layers(f):
    """Every new layer over data vars: the fetches."""
    L = f.layers
    emission = L.data("emission", [B, T, N_TAGS], append_batch_size=False)
    emission.stop_gradient = False
    label = L.data("label", [B, T], dtype="int64", append_batch_size=False)
    length = L.data("length", [B], dtype="int64", append_batch_size=False)
    logits = L.data("logits", [B, T, C], append_batch_size=False)
    logits.stop_gradient = False
    ctc_label = L.data("ctc_label", [B, 3], dtype="int64",
                       append_batch_size=False)
    x = L.data("x", [B, 5], append_batch_size=False)
    x.stop_gradient = False
    cvm = L.data("cvm", [B, 2], append_batch_size=False)
    ts_label = L.data("ts_label", [B, 1], append_batch_size=False)
    attr = f.ParamAttr(name="crfw")
    ll = L.linear_chain_crf(emission, label, param_attr=attr, length=length)
    path = L.crf_decoding(emission, param_attr=attr, length=length)
    chunks = L.chunk_eval(path, label, chunk_scheme="IOB",
                          num_chunk_types=2, seq_length=length)
    dist, seqs = L.edit_distance(path, label)
    ctc = L.warpctc(logits, ctc_label, blank=0, input_length=length)
    greedy = L.ctc_greedy_decoder(logits, blank=0)
    ts = L.teacher_student_sigmoid_loss(
        L.slice(x, axes=[1], starts=[0], ends=[1]), ts_label)
    cv = L.continuous_value_model(L.square(x), cvm, use_cvm=True)
    loss = L.mean(ll) + L.mean(ctc) + L.mean(ts) + L.mean(cv)
    f.backward.append_backward(loss)
    return [ll, path, *chunks, dist, seqs, ctc, greedy, ts, cv, loss]


def _crf_feed():
    rng = np.random.RandomState(3)
    label = rng.randint(0, N_TAGS, (B, T)).astype(np.int64)
    return {"emission": rng.randn(B, T, N_TAGS).astype(np.float32),
            "label": label, "length": np.array([8, 6, 4], np.int64),
            "logits": rng.randn(B, T, C).astype(np.float32),
            "ctc_label": np.array([[1, 2, -1], [3, 3, 1], [2, -1, -1]],
                                  np.int64),
            "x": rng.randn(B, 5).astype(np.float32),
            "cvm": rng.uniform(0.1, 2, (B, 2)).astype(np.float32),
            "ts_label": np.array([[-2.0], [0.4], [1.5]], np.float32)}


def test_layers_build_equal_programs_and_run_alike():
    """linear_chain_crf, crf_decoding, chunk_eval, edit_distance,
    warpctc, ctc_greedy_decoder, teacher_student_sigmoid_loss and
    continuous_value_model: equal programs (main and startup, backward
    included), and the port run from the JAX startup fetches what the
    JAX package does (floats within 1e-5 of max(1, max|JAX|), integers
    exactly), the emission's and transition's gradients too."""
    from test_torch_dense_layers import run_both
    from torch_dense_helpers import assert_same
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got_j, got_t = run_both(_crf_layers, _crf_feed(),
                                ("emission", "crfw", "logits", "x"))
    assert_same(got_t, got_j, tol=RECURSION_TOL)


def test_sampled_softmax_layer_builds_the_jax_program():
    """sampled_softmax_with_cross_entropy: the same program (sample_logits
    then softmax_with_cross_entropy); its loss is finite and each row's
    equals the cross-entropy of its sampled logits (the draws differ)."""
    def build(f):
        logits = f.layers.data("logits", [4, 12], append_batch_size=False)
        label = f.layers.data("label", [4, 1], dtype="int64",
                              append_batch_size=False)
        return [f.layers.sampled_softmax_with_cross_entropy(
            logits, label, num_samples=5)]

    progs = {}
    for f in (fj, ft):
        main, startup = f.Program(), f.Program()
        with f.program_guard(main, startup), f.unique_name.guard():
            loss, = build(f)
        progs[f] = (main, loss)
    assert progs[fj][0].to_json() == progs[ft][0].to_json()
    main, loss = progs[ft]
    rng = np.random.RandomState(1)
    feed = {"logits": rng.randn(4, 12).astype(np.float32),
            "label": rng.randint(0, 12, (4, 1)).astype(np.int64)}
    sampled = [op for op in main.global_block().ops
               if op.type == "sample_logits"][0].outputs["SampledLogits"][0]
    exe = ft.Executor(ft.CPUPlace())
    out, picked = exe.run(main, feed=feed, fetch_list=[loss, sampled])
    want = -picked[:, 0] + np.log(np.exp(picked).sum(1))
    np.testing.assert_allclose(out.reshape(-1), want, rtol=1e-5)


# -- the toy label_semantic_roles (tests/test_models.py:481) ----------------

def _toy_srl(f, vocab=24, n_tags=4, b=8, t=10, hid=16):
    from importlib import import_module
    ParamAttr = import_module(f"{f.__name__}.framework").ParamAttr
    L = f.layers
    w = L.data("words", shape=[b, t], dtype="int64",
               append_batch_size=False)
    lab = L.data("tags", shape=[b, t], dtype="int64",
                 append_batch_size=False)
    emb = L.embedding(w, size=[vocab, hid])
    proj = L.fc(emb, size=4 * hid, num_flatten_dims=2)
    fwd, _ = L.dynamic_lstm(proj, size=4 * hid)
    rev, _ = L.dynamic_lstm(proj, size=4 * hid, is_reverse=True)
    feat = L.concat([fwd, rev], axis=2)
    scores = L.fc(feat, size=n_tags, num_flatten_dims=2)
    crf_attr = ParamAttr(name="crf_w")
    loss = L.mean(L.linear_chain_crf(scores, lab, param_attr=crf_attr))
    f.optimizer.SGD(learning_rate=0.2).minimize(loss)
    decoded = L.crf_decoding(scores, param_attr=crf_attr)
    return loss, decoded


def test_toy_label_semantic_roles_trains_alike():
    """Embeddings, a bidirectional LSTM and the CRF, SGD 0.2: the same
    programs; from the JAX startup state, 5 steps' losses within 1e-4
    relative of the JAX package's and falling, then equal decoded
    paths."""
    rng = np.random.RandomState(0)
    words = rng.randint(0, 24, (8, 10)).astype(np.int64)
    feed = {"words": words, "tags": (words % 4).astype(np.int64)}
    built = {}
    for f in (fj, ft):
        main, startup = f.Program(), f.Program()
        startup.random_seed = 7
        with f.program_guard(main, startup), f.unique_name.guard():
            built[f] = (main, startup, *_toy_srl(f))
    assert built[fj][0].to_json() == built[ft][0].to_json()
    mj, sj, loss_j, dec_j = built[fj]
    scope = fj.Scope()
    with fj.scope_guard(scope), warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        exe = fj.Executor(fj.CPUPlace())
        exe.run(sj)
        init = {n: np.asarray(scope.get(n)) for n in scope.names()
                if scope.find_var(n) is not None}
        j_losses = [float(np.asarray(exe.run(mj, feed=feed,
                                             fetch_list=[loss_j])[0]))
                    for _ in range(5)]
        j_path = np.asarray(exe.run(mj.clone(for_test=True), feed=feed,
                                    fetch_list=[dec_j])[0])
    mt, _, loss_t, dec_t = built[ft]
    exe = ft.Executor(ft.CPUPlace())
    tscope = scope_from_numpy(init, ft.Scope(), ft.CPUPlace(), program=mt)
    t_losses = [float(exe.run(mt, feed=feed, fetch_list=[loss_t],
                              scope=tscope)[0]) for _ in range(5)]
    t_path = exe.run(mt.clone(for_test=True), feed=feed,
                     fetch_list=[dec_t], scope=tscope)[0]
    np.testing.assert_allclose(t_losses, j_losses, rtol=SRL_RTOL)
    assert t_losses[-1] < t_losses[0]
    np.testing.assert_array_equal(t_path, j_path)
