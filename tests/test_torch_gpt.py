"""GPT training on the CPU, and the ops the GPT programs add, against the
JAX package.

A tiny GPT (2 layers, d 64, 2 heads, d_ff 128, vocab 100, use_flash=True,
dropout 0) at batch 2 and seq_len 130: the in-graph shift leaves T 129,
at least 128, so the port's flash op takes FlashAttentionFunction with
the plain causal versions at a ragged length (the card runs the kernels
there).

- The training programs and their startups (AMP off and on) serialize
  byte-identically to the JAX package's.
- From the JAX startup scope, carried over with convert.scope_from_numpy,
  5 AdamW steps (lr 1e-3) give the same losses within rtol 1e-4, and the
  step-1 gradients of every parameter pass test_torch_train.py's
  tolerances: float32 rtol 1e-4, atol 1e-6; AMP each parameter's
  Frobenius gap within 2e-2 of its norm + 1e-6.
- Each op the GPT programs add (slice, scale, matmul, softmax,
  elementwise_mul, less_equal, reduce_mean, one_hot, range, assign,
  lookup_table) matches its JAX lowering on seeded random inputs within
  1e-6 (paged_attention: tests/test_torch_generate.py).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.core import lowering as jlow
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu.models import gpt as gj
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.core import lowering as tlow
from paddle_tpu_torch.core.registry import REGISTRY as TREG
from paddle_tpu_torch.models import gpt as gt
from paddle_tpu_torch.ops.cuda import flash_attention as fa

B, SEQ, V, STEPS = 2, 130, 100, 5
OP_ATOL = 1e-6


def tiny_cfg(g):
    return g.gpt_small(vocab_size=V, d_model=64, n_heads=2, n_layers=2,
                       d_ff=128, max_seq_len=SEQ, use_flash=True,
                       dropout=0.0, attn_dropout=0.0)


def _build(f, g, amp):
    main, startup = f.Program(), f.Program()
    startup.random_seed = 11
    with f.program_guard(main, startup), f.unique_name.guard():
        loss, logits, tokens = g.build_train(tiny_cfg(g), B, SEQ, lr=1e-3,
                                             amp=amp)
    return main, startup, loss


def _tokens():
    return np.random.RandomState(0).randint(0, V, (B, SEQ)).astype(np.int64)


@pytest.mark.parametrize("name,kw", [
    ("gpt_small", {}), ("gpt_medium", {}),
    ("gpt_small", {"dropout": 0.1, "attn_dropout": 0.0, "use_flash": True,
                   "max_seq_len": 512})])
def test_configs_match_jax(name, kw):
    """Every field of the port's config equals the JAX package's (whose
    config also names the mesh axes of the parallel paths, not ported)."""
    cj, ct = getattr(gj, name)(**kw), getattr(gt, name)(**kw)
    assert vars(ct) == {k: getattr(cj, k) for k in vars(ct)}
    assert ct.causal


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_training_programs_identical(amp):
    mj, sj, _ = _build(fj, gj, amp)
    mt, st, _ = _build(ft, gt, amp)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    assert mt.fingerprint() == mj.fingerprint()
    assert st.fingerprint() == sj.fingerprint()
    ops = mt.global_block().ops
    slices = [op for op in ops if op.type == "slice"]
    assert [(op.attrs["starts"], op.attrs["ends"]) for op in slices] == \
        [([0], [SEQ - 1]), ([1], [SEQ])]
    flash = [op for op in ops if op.type == "flash_attention"]
    assert len(flash) == 2 and all(op.attrs["causal"] for op in flash)
    assert ("cast" in {op.type for op in ops}) == amp


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_losses_and_gradients_match_jax(amp, monkeypatch):
    mj, sj, loss_j = _build(fj, gj, amp)
    mt, _, loss_t = _build(ft, gt, amp)
    scope_j = fj.Scope()
    with fj.scope_guard(scope_j):
        exe_j = fj.Executor(fj.CPUPlace())
        exe_j.run(sj)
    params = {n: np.asarray(scope_j.get(n)) for n in scope_j.names()
              if scope_j.find_var(n) is not None}
    scope_t = scope_from_numpy(params, ft.Scope(), ft.CPUPlace())
    exe_t = ft.Executor(ft.CPUPlace())
    pnames = sorted(p.name for p in mt.all_parameters())
    fetch = [loss_t.name] + [f"{p}@GRAD" for p in pnames]
    feed = {"tokens": _tokens()}
    # the causal attention takes the autograd Function (T 129 >= 128),
    # not the exact path under autograd
    shapes = []
    fwd = fa.FlashAttentionFunction.forward

    def spy(ctx, q, k, v, causal, sm_scale):
        shapes.append((tuple(q.shape), causal))
        return fwd(ctx, q, k, v, causal, sm_scale)

    monkeypatch.setattr(fa.FlashAttentionFunction, "forward",
                        staticmethod(spy))
    losses_j, losses_t = [], []
    for step in range(STEPS):
        with fj.scope_guard(scope_j):
            out_j = exe_j.run(mj, feed=feed, fetch_list=fetch)
        out_t = exe_t.run(mt, feed=feed, fetch_list=fetch, scope=scope_t)
        losses_j.append(float(np.asarray(out_j[0])))
        losses_t.append(float(out_t[0]))
        if step == 0:
            for name, a, b in zip(fetch[1:], out_j[1:], out_t[1:]):
                a = np.asarray(a, np.float32)
                if not amp:
                    np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6,
                                               err_msg=name)
                    continue
                gap = float(np.linalg.norm(b - a))
                assert gap <= 2e-2 * float(np.linalg.norm(a)) + 1e-6, \
                    (name, gap, float(np.linalg.norm(a)))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    assert losses_t[-1] < losses_t[0]
    assert exe_t.cache_stats()["misses"] == 1
    assert shapes == [((B * 2, SEQ - 1, 32), True)] * (2 * STEPS)


# --- the ops the GPT programs add ------------------------------------------

def _op(attrs):
    return types.SimpleNamespace(attrs=dict(attrs), id=7, block=None,
                                 type="op")


def run_jax(op_type, ins, attrs):
    ctx = jlow._OpCtx(jlow.LowerCtx(jax.random.PRNGKey(0)), _op(attrs))
    jins = {s: [jnp.asarray(a) for a in vs] for s, vs in ins.items()}
    outs = JREG.get(op_type).lower(ctx, jins, attrs)
    return {s: [np.asarray(o) for o in vs] for s, vs in outs.items()}


def run_torch(op_type, ins, attrs):
    ctx = tlow._OpCtx(tlow.LowerCtx("cpu"), _op(attrs))
    tins = {s: [torch.from_numpy(np.array(a)) for a in vs]
            for s, vs in ins.items()}
    outs = TREG.get(op_type).lower(ctx, tins, attrs)
    return {s: [o.numpy() for o in vs] for s, vs in outs.items()}


def compare(op_type, ins, attrs, slots=("Out",)):
    """Both lowerings on the same inputs: equal shapes, values within
    OP_ATOL, and the same kind of dtype (the JAX package narrows 64-bit
    types to 32)."""
    oj, ot = run_jax(op_type, ins, attrs), run_torch(op_type, ins, attrs)
    for s in slots:
        for a, b in zip(oj[s], ot[s]):
            assert a.shape == b.shape, (s, a.shape, b.shape)
            assert a.dtype.kind == b.dtype.kind, (s, a.dtype, b.dtype)
            np.testing.assert_allclose(b.astype(np.float64),
                                       a.astype(np.float64), atol=OP_ATOL,
                                       rtol=0, err_msg=s)
    return oj, ot


def _randn(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("axes,starts,ends,decrease", [
    ([1], [0], [7], None), ([1], [1], [8], None), ([0, 2], [-1, 2], [9, -1],
                                                   None),
    ([0], [1], [2], [0])])
def test_slice(axes, starts, ends, decrease):
    x = np.random.RandomState(1).randint(0, V, (3, 8, 5)).astype(np.int64)
    attrs = {"axes": axes, "starts": starts, "ends": ends}
    if decrease:
        attrs["decrease_axis"] = decrease
    compare("slice", {"Input": [x]}, attrs)
    compare("slice", {"Input": [x.astype(np.float32)]}, attrs)


@pytest.mark.parametrize("bias_after_scale", [True, False])
def test_scale(bias_after_scale):
    x = _randn(np.random.RandomState(2), 4, 6)
    compare("scale", {"X": [x]}, {"scale": -1.5, "bias": 0.25,
                                  "bias_after_scale": bias_after_scale})
    compare("scale", {"X": [x]}, {"scale": 1e30, "bias": -1e30})


@pytest.mark.parametrize("tx,ty,alpha,xs,ys", [
    (False, True, 1.0, (2, 3, 1, 8), (2, 3, 16, 8)),
    (False, False, 1.0, (2, 3, 1, 16), (2, 3, 16, 8)),
    (True, False, 0.5, (2, 8, 5), (2, 8, 4)),
    (False, False, 2.0, (4, 6), (6, 3))])
def test_matmul(tx, ty, alpha, xs, ys):
    rng = np.random.RandomState(3)
    compare("matmul", {"X": [_randn(rng, *xs)], "Y": [_randn(rng, *ys)]},
            {"transpose_X": tx, "transpose_Y": ty, "alpha": alpha})


@pytest.mark.parametrize("axis", [-1, 1])
def test_softmax(axis):
    x = _randn(np.random.RandomState(4), 2, 3, 1, 16) * 3
    # the decode step's additive mask: -1e30 on the masked lanes
    x[..., 9:] += -1e30
    oj, ot = compare("softmax", {"X": [x]}, {"axis": axis})
    if axis == -1:
        assert (ot["Out"][0][..., 9:] == 0).all()


@pytest.mark.parametrize("xs,ys,axis", [
    ((2, 3, 4), (2, 3, 4), -1), ((2, 3, 4), (4,), -1), ((2, 3, 4), (3,), 1),
    ((2, 3, 4), (2, 3), 0), ((4, 1, 8, 1), (4, 1, 1, 1), -1)])
def test_elementwise_mul(xs, ys, axis):
    rng = np.random.RandomState(5)
    compare("elementwise_mul", {"X": [_randn(rng, *xs)],
                                "Y": [_randn(rng, *ys)]}, {"axis": axis})


def test_elementwise_mul_int64():
    x = np.array([3, 5, 7], np.int64)
    compare("elementwise_mul", {"X": [x], "Y": [np.array([1, 0, 1],
                                                         np.int64)]},
            {"axis": -1})


def test_less_equal():
    steps = np.arange(16, dtype=np.float32).reshape(1, 16)
    pos = np.array([[0.0], [5.0], [15.0]], np.float32)
    oj, ot = compare("less_equal", {"X": [steps], "Y": [pos]}, {"axis": -1})
    assert ot["Out"][0].dtype == np.bool_ and ot["Out"][0].shape == (3, 16)


@pytest.mark.parametrize("dim,keep,reduce_all", [
    ([1, 2], False, False), ([-1], True, False), ([0], False, True),
    ([0, 2], True, False)])
def test_reduce_mean(dim, keep, reduce_all):
    x = _randn(np.random.RandomState(6), 3, 4, 5)
    compare("reduce_mean", {"X": [x]}, {"dim": dim, "keep_dim": keep,
                                        "reduce_all": reduce_all})


@pytest.mark.parametrize("shape", [(4, 1), (4,), (2, 3, 1)])
def test_one_hot(shape):
    x = np.random.RandomState(7).randint(-1, 12, shape).astype(np.int64)
    compare("one_hot", {"X": [x]}, {"depth": 10})


@pytest.mark.parametrize("start,step,n,dtype", [
    (0, 1, 16, np.int64), (3, 2, 5, np.int64), (0.5, 0.25, 7, np.float32)])
def test_range(start, step, n, dtype):
    ins = {"Start": [np.array([start], dtype)],
           "End": [np.array([start + step * n], dtype)],
           "Step": [np.array([step], dtype)]}
    compare("range", ins, {"static_len": n})


def test_assign():
    x = _randn(np.random.RandomState(8), 2, 3, 4)
    compare("assign", {"X": [x]}, {})


@pytest.mark.parametrize("ids_shape", [(4, 1), (2, 3), (2, 3, 1)])
@pytest.mark.parametrize("padding_idx", [-1, 3])
def test_lookup_table(ids_shape, padding_idx):
    rng = np.random.RandomState(9)
    ids = rng.randint(0, 10, ids_shape).astype(np.int64)
    ids.reshape(-1)[0] = 3
    oj, ot = compare("lookup_table", {"W": [_randn(rng, 10, 6)],
                                      "Ids": [ids]},
                     {"padding_idx": padding_idx})
    # [..., 1] ids squeeze their trailing 1
    lead = ids_shape[:-1] if ids_shape[-1] == 1 else ids_shape
    assert ot["Out"][0].shape == lead + (6,)
    if padding_idx == 3:
        assert (ot["Out"][0].reshape(-1, 6)[0] == 0).all()


def test_embedding_routes_trailing_one_to_lookup_table():
    """layers.embedding over [B, 1] ids emits lookup_table (the squeeze
    to [B, d]); over [B, T] ids lookup_table_v2, as in the JAX package."""
    for ids_shape, op_type, out_shape in (([4, 1], "lookup_table", (4, 8)),
                                          ([4, 3], "lookup_table_v2",
                                           (4, 3, 8))):
        main, startup = ft.Program(), ft.Program()
        with ft.program_guard(main, startup), ft.unique_name.guard():
            ids = ft.layers.data("ids", shape=ids_shape, dtype="int64",
                                 append_batch_size=False)
            out = ft.layers.embedding(ids, size=[V, 8], padding_idx=3)
        op = main.global_block().ops[-1]
        assert op.type == op_type and op.attrs["padding_idx"] == 3
        assert tuple(out.shape) == out_shape
