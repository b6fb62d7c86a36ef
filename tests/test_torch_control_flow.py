"""The port's control flow against the JAX package's, on the CPU.

- The ten op types of ops/controlflow.py: the eight without a sub-block
  one by one on seeded inputs (floats within 1e-6, the rest exact, and
  the gradients of select_input and the array ops), `while` and
  `conditional_block` through programs.
- The layers: a While that counts to 10 and writes a tensor array,
  IfElse, Switch (first match; a var no case wrote is the NaN sentinel,
  with one warning), StaticRNN and DynamicRNN trained two SGD steps, and
  Print. Each program's JSON and fingerprint equal the JAX package's; its
  fetches equal the JAX package's (integers exactly, floats within 1e-5
  of max(1, |JAX|)) from the JAX startup state.
- Gradients through a While: in both packages the while op's grad op
  writes no gradient (its X slot holds the bool condition, so no slot is
  differentiable) and the ops before the loop read the carried var's
  gradient as if the loop were the identity. The port must not
  differentiate the loop where the JAX package does not: the parameter
  gradients equal the JAX package's (1/8 each here, not the loop's 8x).
- The analysis: each program verifies to the JAX package's findings.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.analysis import verify_program as jverify
from paddle_tpu_torch.analysis import verify_program as tverify
from paddle_tpu_torch.ops import controlflow as tcf
from torch_analysis_helpers import finding_keys
from torch_dense_helpers import compare_op
from torch_seq_helpers import assert_close, build_both, run_both

TOL = 1e-5


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("case", ["select_input", "write_new", "write_into",
                                  "write_clamped", "read", "read_clamped",
                                  "length", "to_tensor_concat",
                                  "to_tensor_stack", "feed", "fetch"])
def test_op_against_jax(case):
    x, arr = _rand(3, 4), _rand(6, 3, 4, seed=1)
    i = np.asarray([2], np.int32)
    table = {
        "select_input": ("select_input", {"X": [x, _rand(3, 4, seed=2)],
                                          "Mask": [np.asarray([1], np.int32)]},
                         {}, {"Out": 1}, ["X"]),
        "write_new": ("write_to_array", {"X": [x], "I": [i]},
                      {"max_len": 5}, {"Out": 1}, ["X"]),
        "write_into": ("write_to_array", {"X": [x], "I": [i], "Array": [arr]},
                       {}, {"Out": 1}, ["X", "Array"]),
        "write_clamped": ("write_to_array",
                          {"X": [x], "I": [np.asarray([9], np.int32)],
                           "Array": [arr]}, {}, {"Out": 1}, ["X"]),
        "read": ("read_from_array", {"X": [arr], "I": [i]}, {}, {"Out": 1},
                 ["X"]),
        "read_clamped": ("read_from_array",
                         {"X": [arr], "I": [np.asarray([40], np.int32)]},
                         {}, {"Out": 1}, ["X"]),
        "length": ("lod_array_length", {"X": [arr]}, {}, {"Out": 1}, []),
        "to_tensor_concat": ("tensor_array_to_tensor", {"X": [arr]},
                             {"axis": 1}, {"Out": 1, "OutIndex": 1}, ["X"]),
        "to_tensor_stack": ("tensor_array_to_tensor", {"X": [arr]},
                            {"axis": 2, "use_stack": True},
                            {"Out": 1, "OutIndex": 1}, ["X"]),
        "feed": ("feed", {"X": [x, arr]}, {"col": 1}, {"Out": 1}, []),
        "fetch": ("fetch", {"X": [x]}, {}, {"Out": 1}, ["X"]),
    }
    op_type, ins, attrs, outs, grads = table[case]
    compare_op(op_type, ins, attrs, outs, grads)


def test_print_op_prints_and_passes_through(capsys):
    x = _rand(2, 3)
    out = compare_op("print", {"In": [x]}, {"message": "hello"}, {"Out": 1},
                     [])
    assert np.array_equal(out["Out"][0].detach().numpy(), x)
    assert "hello" in capsys.readouterr().out


def _while_array(f):
    L = f.layers
    x = L.data("x", shape=[4], dtype="float32")
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 10)
    arr = L.create_array("float32")
    L.array_write(x, i, array=arr)
    acc = L.scale(x, scale=1.0)
    cond = L.less_than(i, n)
    loop = L.While(cond)
    with loop.block():
        L.increment(i, in_place=True)
        nxt = L.scale(acc, scale=0.5, bias=1.0)
        L.assign(nxt, acc)
        L.array_write(nxt, i, array=arr)
        L.less_than(i, n, cond=cond)
    third = L.array_read(arr, L.fill_constant([1], "int64", 3))
    length = L.array_length(arr)
    flat, idx = L.tensor_array_to_tensor(arr, axis=0)
    return [i, acc, third, length, flat, idx, cond]


def _if_else(f):
    L = f.layers
    x = L.data("x", shape=[4], dtype="float32")
    cond = L.greater_than(L.reduce_sum(x, dim=1, keep_dim=True),
                          L.fill_constant([1], "float32", 0.0))
    ie = L.IfElse(cond)
    with ie.true_block():
        ie.output(L.scale(ie.input(x), scale=2.0))
    with ie.false_block():
        ie.output(L.scale(ie.input(x), scale=-1.0, bias=0.5))
    return ie()


def _switch(f):
    L = f.layers
    v = L.data("v", shape=[1], dtype="float32", append_batch_size=False)
    out = L.fill_constant([1], "float32", -1.0)
    sw = L.Switch()
    with sw.case(L.less_than(v, L.fill_constant([1], "float32", 1.0))):
        L.assign(L.fill_constant([1], "float32", 1.0), out)
    with sw.case(L.less_than(v, L.fill_constant([1], "float32", 2.0))):
        L.assign(L.fill_constant([1], "float32", 2.0), out)
    with sw.default():
        L.assign(L.fill_constant([1], "float32", 3.0), out)
    return [out]


def _unset_branch(f):
    L = f.layers
    v = L.data("v", shape=[1], dtype="float32", append_batch_size=False)
    res = f.default_main_program().global_block().create_var(
        name="cf_unset", shape=[1], dtype="float32")
    sw = L.Switch()
    with sw.case(L.less_than(v, L.fill_constant([1], "float32", 0.0))):
        L.assign(L.scale(v, scale=3.0), res)
    return [res]


def _static_rnn(f):
    L = f.layers
    x = L.data("x", shape=[5, 3, 4], dtype="float32",
               append_batch_size=False)
    h0 = L.fill_constant([3, 8], "float32", 0.1)
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h = rnn.memory(init=h0)
        nh = L.fc([xt, h], size=8, act="tanh")
        rnn.update_memory(h, nh)
        rnn.step_output(nh)
    out = rnn()
    loss = L.mean(out)
    f.optimizer.SGD(0.5).minimize(loss)
    return [loss, out]


def _dynamic_rnn(f):
    L = f.layers
    x = L.data("x", shape=[5, 4], dtype="float32")
    h0 = L.fill_constant_batch_size_like(x, [-1, 8], "float32", 0.0)
    drnn = L.DynamicRNN()
    with drnn.block():
        xt = drnn.step_input(x)
        h = drnn.memory(init=h0)
        nh = L.fc([xt, h], size=8, act="sigmoid")
        drnn.update_memory(h, nh)
        drnn.output(nh)
    out = drnn()
    loss = L.mean(out)
    f.optimizer.SGD(0.5).minimize(loss)
    return [loss, out]


def _while_grad(f):
    L = f.layers
    x = L.data("x", shape=[4], dtype="float32")
    h = L.fc(x, size=4)
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 3)
    cond = L.less_than(i, n)
    loop = L.While(cond)
    with loop.block():
        L.assign(L.scale(h, scale=2.0), h)
        L.increment(i, in_place=True)
        L.less_than(i, n, cond=cond)
    loss = L.mean(h)
    f.optimizer.SGD(0.1).minimize(loss)
    return [loss]


PROGRAMS = {
    "while_array": (_while_array, [{"x": _rand(2, 4)}]),
    "if_else": (_if_else, [{"x": _rand(6, 4, seed=3)}]),
    "switch": (_switch, [{"v": np.asarray([v], np.float32)}
                         for v in (0.5, 1.5, 5.0)]),
    "static_rnn": (_static_rnn, [{"x": _rand(5, 3, 4, seed=4)}] * 2),
    "dynamic_rnn": (_dynamic_rnn, [{"x": _rand(3, 5, 4, seed=5)}] * 2),
    "while_grad": (_while_grad, [{"x": np.ones((2, 4), np.float32)}] * 2),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_against_jax(name):
    fn, feeds = PROGRAMS[name]
    bj, bt = build_both(fn)
    fetch = [v.name for v in bt[2]]
    got_j, got_t, after_j, after_t = run_both(bj, bt, feeds, fetch)
    for gj, gt in zip(got_j, got_t):
        assert_close(gt, gj, TOL)
    for n in after_j:
        assert_close([after_t[n]], [after_j[n]], TOL)
    rj = jverify(bj[0], feed_names=list(feeds[0]), fetch_names=fetch)
    rt = tverify(bt[0], feed_names=list(feeds[0]), fetch_names=fetch)
    assert finding_keys(rt) == finding_keys(rj)


def test_while_counts_and_syncs_once_an_iteration():
    bj, bt = build_both(_while_array)
    before = dict(tcf.HOST_SYNCS)
    _, got_t, _, _ = run_both(bj, bt, [{"x": _rand(2, 4)}],
                              [bt[2][0].name, bt[2][3].name])
    assert int(got_t[0][0][0]) == 10 and int(got_t[0][1][0]) == 64
    assert tcf.HOST_SYNCS["while_iterations"] - \
        before["while_iterations"] == 10
    assert tcf.HOST_SYNCS["while"] - before["while"] == 11


def test_while_gradient_treats_the_loop_as_identity():
    bj, bt = build_both(_while_grad)
    params = [p.name for p in bt[0].all_parameters()]
    fetch = [p + "@GRAD" for p in params]
    got_j, got_t, _, _ = run_both(bj, bt, [{"x": np.ones((2, 4),
                                                         np.float32)}],
                                  fetch)
    assert_close(got_t[0], got_j[0], TOL)
    np.testing.assert_allclose(got_t[0][1], np.full(4, 0.25, np.float32))


def test_skipped_branch_gives_the_sentinel_and_warns_once():
    bj, bt = build_both(_unset_branch)
    tcf._WARNED_UNSET.discard("cf_unset")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        exe = ft.Executor(ft.CPUPlace())
        outs = [exe.run(bt[0], feed={"v": np.asarray([v], np.float32)},
                        fetch_list=["cf_unset"], scope=ft.Scope())[0]
                for v in (1.0, 2.0, -1.0)]
    hits = [x for x in w if "cf_unset" in str(x.message)]
    assert len(hits) == 1
    assert np.isnan(outs[0]).all() and np.isnan(outs[1]).all()
    np.testing.assert_allclose(outs[2], [-3.0])
    scope = fj.Scope()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with fj.scope_guard(scope):
            got = fj.Executor(fj.CPUPlace()).run(
                bj[0], feed={"v": np.asarray([1.0], np.float32)},
                fetch_list=["cf_unset"])[0]
    assert np.isnan(np.asarray(got)).all()


def test_while_body_that_changes_a_carried_shape_raises():
    def grow(f):
        L = f.layers
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 2)
        acc = L.fill_constant([2], "float32", 1.0)
        cond = L.less_than(i, n)
        loop = L.While(cond)
        with loop.block():
            L.assign(L.concat([acc, acc], axis=0), acc)
            L.increment(i, in_place=True)
            L.less_than(i, n, cond=cond)
        return [acc]

    _, (mt, st, outs) = build_both(grow)
    exe = ft.Executor(ft.CPUPlace())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="carried var"):
            exe.run(mt, fetch_list=[outs[0].name], scope=ft.Scope())


def test_conditional_block_on_meta_tensors_raises():
    cond = torch.ones(1, dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError, match="meta"):
        tcf._host_bool(cond, "conditional_block")


def test_check_nan_inf_raises_inside_a_sub_block():
    """FLAGS_check_nan_inf inside a While body: the port raises naming
    the body's op (block 1), as at top level; the JAX package can only
    print there (a deliberate difference, ROADMAP §C)."""
    def prog(f):
        L = f.layers
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 2)
        acc = L.fill_constant([2], "float32", 0.0)
        cond = L.less_than(i, n)
        loop = L.While(cond)
        with loop.block():
            L.assign(L.log(acc), acc)
            L.increment(i, in_place=True)
            L.less_than(i, n, cond=cond)
        return [acc]

    _, (mt, _, outs) = build_both(prog)
    ft.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(FloatingPointError, match="block 1"):
                ft.Executor(ft.CPUPlace()).run(
                    mt, fetch_list=[outs[0].name], scope=ft.Scope())
    finally:
        ft.set_flags({"FLAGS_check_nan_inf": False})
