"""The dense layers of layers/nn.py, the dense comparisons, auc, the
parity layers and the three nets, each built by both packages and run on
the CPU; and the op types of nn_ops.py, tensor_ops.py and the partial
files (misc_ops.py, vision_extra.py, metrics_ops.py) against their JAX
lowerings.

- Each layer case builds the same program in both packages (byte-equal
  JSON, the startup too), runs the JAX startup, carries its scope over
  with convert.scope_from_numpy and runs both main programs on one
  seeded numpy feed: float outputs within 1e-6 of max(1, max|JAX|),
  integer, index and bool outputs exactly; where the case is
  differentiated, its inputs' gradients (fetched as `<name>@GRAD`)
  within the same 1e-6.
- The op types of the last groups run through both lowerings on
  chip_smoke.dense_op_cases' inputs (tests/test_torch_dense_ops.py
  holds the first groups), with their inputs' gradients for seeded
  cotangents of every float output, within 1e-6.
- Exact cases: hash (XXH64) against the JAX package's, argsort's ties in
  both orders, where's -1 rows, unique's padding; lrn at n 5, k 2, where
  torch's F.local_response_norm would give other numbers.
- auc over three batches with its histogram state carried in the scope.
- The random ops (randint, sampling_id, uniform_random_batch_size_like,
  and the uniform_random and gaussian_random layers) by their range and
  moments: the two frameworks draw other bits by design.
"""
import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fj
import paddle_tpu_torch as ft
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.core.registry import REGISTRY as TREG
from torch_dense_helpers import (jax_lower, torch_lower, assert_same,
                                 chip_smoke, compare_op)

# the op types of nn_ops.py, tensor_ops.py and the partial files
LATE_OPS = chip_smoke.DENSE_OP_TYPES[
    chip_smoke.DENSE_OP_TYPES.index("log_softmax"):]


def _build(f, fn, seed=7):
    main, startup = f.Program(), f.Program()
    startup.random_seed = seed
    with f.program_guard(main, startup), f.unique_name.guard():
        fetch = fn(f)
    return main, startup, fetch


def run_both(fn, feed, grad_of=(), feeds=None, carry=True):
    """(JAX fetches, port fetches) of fn's fetch list plus the gradients
    `<name>@GRAD` of `grad_of`, the port run from the JAX startup (from
    its own without `carry`); with `feeds`, one list a feed, the runs
    sharing their scope."""
    mj, sj, fetch_j = _build(fj, fn)
    mt, st, _ = _build(ft, fn)
    assert mt.to_json() == mj.to_json()
    assert st.to_json() == sj.to_json()
    names = [v.name for v in fetch_j] + [f"{n}@GRAD" for n in grad_of]
    many = feeds is not None
    feeds = feeds if many else [feed]
    scope = fj.Scope()
    with fj.scope_guard(scope):
        exe = fj.Executor(fj.CPUPlace())
        exe.run(sj)
        params = {n: np.asarray(scope.get(n)) for n in scope.names()
                  if scope.find_var(n) is not None}
        got_j = [[np.asarray(o) for o in exe.run(mj, feed=fd,
                                                 fetch_list=names)]
                 for fd in feeds]
    exe_t = ft.Executor(ft.CPUPlace())
    if carry:
        tscope = scope_from_numpy(params, ft.Scope(), ft.CPUPlace(),
                                  program=mt)
    else:
        tscope = ft.Scope()
        exe_t.run(st, scope=tscope)
    got_t = [exe_t.run(mt, feed=fd, fetch_list=names, scope=tscope)
             for fd in feeds]
    return (got_j, got_t) if many else (got_j[0], got_t[0])


def _data(f, name, shape, dtype="float32", grad=True):
    v = f.layers.data(name, list(shape), dtype=dtype,
                      append_batch_size=False)
    v.stop_gradient = not grad
    return v


def _loss(f, *outs):
    loss = f.layers.mean(outs[0])
    for o in outs[1:]:
        loss = loss + f.layers.mean(o)
    f.backward.append_backward(loss)


def _rand(seed, *shape, lo=None, hi=None):
    rng = np.random.RandomState(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


# -- layer cases -------------------------------------------------------------

def _case_activations(f):
    L = f.layers
    x = _data(f, "x", (2, 3, 4, 4))
    outs = [L.sigmoid(x), L.log(L.exp(x)), L.erf(x), L.leaky_relu(x, 0.1),
            L.elu(x, 0.5), L.relu6(L.scale(x, 4.0)), L.stanh(x),
            L.hard_sigmoid(x), L.swish(x, 1.5), L.hard_swish(x),
            L.soft_relu(x, 1.5), L.brelu(x, 0.2, 0.9), L.selu(x),
            L.log_softmax(x, axis=1), L.maxout(x, groups=3),
            L.prelu(x, "channel"), L.prelu(x, "all"), L.prelu(x, "element"),
            L.sign(x), L.cumsum(x, axis=2, exclusive=True)]
    _loss(f, *[o * o for o in outs])
    return outs


def _case_norms(f):
    L = f.layers
    x = _data(f, "x", (2, 4, 6, 6))
    scale = L.create_parameter([4], "float32", name="ac_scale",
                               default_initializer=f.initializer.Constant(
                                   1.5))
    bias = L.create_parameter([4], "float32", name="ac_bias",
                              is_bias=True)
    outs = [L.instance_norm(x), L.group_norm(x, 2, act="relu"),
            L.lrn(x, n=5, k=2.0, alpha=1e-3), L.l2_normalize(x, 1),
            L.affine_channel(x, scale, bias, act="tanh"),
            L.conv2d_transpose(x, 3, filter_size=3, stride=2, padding=1),
            L.conv2d_transpose(x, 4, output_size=[13, 13], stride=2,
                               groups=2),
            L.depthwise_conv2d(x, 4, 3, padding=1),
            L.conv2d(x, 8, 3, groups=4, padding=1, bias_attr=False)]
    _loss(f, *[o * o for o in outs])
    return outs


def _case_3d(f):
    L = f.layers
    x = _data(f, "x", (2, 2, 4, 4, 4))
    outs = [L.conv3d(x, 3, 3, padding=1), L.pool3d(x, 2, "avg", 2),
            L.pool3d(x, 3, "max", 1, 1), L.pool3d(x, 2, "avg", 2, 1,
                                                  exclusive=False),
            L.pool3d(x, 2, "max", global_pooling=True),
            L.adaptive_pool3d(x, 2, "max"), L.adaptive_pool3d(x, [1, 2, 4],
                                                              "avg")]
    _loss(f, *[o * o for o in outs])
    return outs


def _case_shapes(f):
    L = f.layers
    x = _data(f, "x", (2, 6, 4, 4))
    y = _data(f, "y", (2, 1, 4, 1))
    s1 = L.split(x, [1, 2, 3], dim=1)
    s2 = L.split(x, 2, dim=-1)
    outs = [*s1, *s2, L.squeeze(L.unsqueeze(x, [0]), [0]),
            L.squeeze(y, [1, 3]), L.unsqueeze(y, [1, -1]), L.flatten(x, 2),
            L.stack([x, x], 1), *L.unstack(y, 0), L.expand(y, [1, 2, 1, 3]),
            L.expand_as(y, x),
            L.strided_slice(x, [1, 3], [5, 0], [0, 4], [-2, 3]),
            L.pad(y, [0, 1, 2, 0, 1, 1, 0, 2], pad_value=0.5),
            L.pad2d(x, [1, 0, 2, 1], "edge"), L.pad2d(x, [1, 2, 0, 1],
                                                      "reflect"),
            L.pad2d(x, [1, 1, 1, 1], pad_value=-1.0),
            L.pixel_shuffle(L.slice(x, [1], [0], [4]), 2),
            L.space_to_depth(x, 2), L.shuffle_channel(x, 3),
            L.temporal_shift(L.reshape(x, [4, 3, 4, 4]), 2),
            L.unfold(x, [2, 3], strides=[1, 2], paddings=[1, 0, 0, 1]),
            L.unfold(x, 2), L.transpose(x, [0, 2, 3, 1])]
    _loss(f, *[o * o for o in outs])
    return outs + [L.shape(x), L.size(x), L.rank(x)]


def _case_reduce_compare(f):
    L = f.layers
    x = _data(f, "x", (2, 3, 4))
    y = _data(f, "y", (2, 3, 4))
    red = [L.reduce_sum(x, [0, 2]), L.reduce_max(x, 1, keep_dim=True),
           L.reduce_min(x), L.reduce_prod(L.scale(x, 0.1, 1.0), [1, 2]),
           L.reduce_mean(x, -1)]
    lt, gt = L.less_than(x, y), L.greater_than(x, y)
    cmp = [lt, gt, L.greater_equal(x, y), L.not_equal(x, y),
           L.less_equal(x, y), L.equal(x, y)]
    logic = [L.logical_and(lt, gt), L.logical_or(lt, gt),
             L.logical_xor(lt, L.logical_not(gt)), L.logical_not(lt),
             L.reduce_all(lt, 1), L.reduce_any(gt), L.reduce_all(gt),
             L.reduce_any(lt, [0, 2], keep_dim=True), L.is_empty(x)]
    _loss(f, *[o * o for o in red])
    return red + cmp + logic


def _case_index(f):
    L = f.layers
    x = _data(f, "x", (5, 4))
    idx = _data(f, "idx", (3, 2), "int32", grad=False)
    ids = _data(f, "ids", (3,), "int32", grad=False)
    upd = _data(f, "upd", (3, 4))
    upd_nd = _data(f, "upd_nd", (3,))
    tied = _data(f, "tied", (3, 8))
    cond = _data(f, "cond", (2, 3, 2), grad=False)
    u_in = _data(f, "u_in", (12,), "int32", grad=False)
    u_f = _data(f, "u_f", (9,), grad=False)
    sh = _data(f, "sh", (6, 1), "int64", grad=False)
    outs = [L.gather_nd(x, idx), L.scatter(x, ids, upd),
            L.scatter(x, ids, upd, overwrite=False),
            L.scatter_nd_add(x, idx, upd_nd),
            *L.argsort(tied, axis=1), *L.argsort(tied, axis=1,
                                                 descending=True),
            *L.argsort(tied, axis=0, descending=True)]
    _loss(f, *[o * o for o in outs if o.dtype == "float32"])
    return outs + [L.where(cond), *L.unique(u_in), *L.unique(u_f, "int64"),
                   *L.unique_with_counts(u_in), *L.unique_with_counts(u_f),
                   L.shard_index(sh, 20, 3, 1), L.shard_index(sh, 20, 3, 2,
                                                              -5),
                   L.hash(sh, 1000, 3)]


def _case_losses(f):
    L = f.layers
    p = _data(f, "p", (6, 1))
    q = _data(f, "q", (6, 1))
    lbl01 = _data(f, "lbl01", (6, 1), grad=False)
    sgn = _data(f, "sgn", (6, 1), grad=False)
    logits = _data(f, "logits", (6, 5))
    probs = L.softmax(logits)
    cls = _data(f, "cls", (6, 1), "int64", grad=False)
    multi = _data(f, "multi", (6, 5), grad=False)
    prob01 = L.sigmoid(p)
    outs = [L.sigmoid_cross_entropy_with_logits(logits, multi),
            L.sigmoid_cross_entropy_with_logits(logits, multi,
                                                normalize=True),
            L.square_error_cost(p, q), L.huber_loss(p, q, 0.5),
            L.smooth_l1(logits, L.scale(logits, 0.5), sigma=2.0),
            L.smooth_l1(logits, multi, inside_weight=multi,
                        outside_weight=multi),
            L.log_loss(prob01, lbl01),
            L.kldiv_loss(L.log(probs), multi, "batchmean"),
            L.kldiv_loss(L.log(probs), multi, "sum"),
            L.kldiv_loss(L.log(probs), multi, "none"),
            L.rank_loss(lbl01, p, q), L.margin_rank_loss(sgn, p, q, 0.1),
            L.bpr_loss(logits, cls),
            L.npair_loss(logits, L.scale(logits, -1.0, 0.5),
                         L.reshape(lbl01, [-1])),
            L.dice_loss(probs, multi), L.mse_loss(p, q),
            L.center_loss(logits, cls, 4, 0.1),
            L.cos_sim(logits, L.scale(logits, 2.0, 0.3)),
            L.mul(logits, L.reshape(logits, [5, 6])),
            L.bilinear_tensor_product(logits, L.scale(logits, 0.5), 3)]
    _loss(f, *outs)
    return outs


def _case_maps(f):
    L = f.layers
    x = _data(f, "x", (2, 3, 4, 5))
    y = _data(f, "y", (2, 2, 4, 5))
    grid = _data(f, "grid", (2, 3, 3, 2))
    outs = [L.fsp_matrix(x, y), L.grid_sampler(x, grid)]
    _loss(f, *[o * o for o in outs])
    return outs


def _case_nets(f):
    L = f.layers
    x = _data(f, "x", (2, 3, 8, 8))
    s = _data(f, "s", (2, 4, 8))
    outs = [f.nets.img_conv_group(x, [4, 4], 2, conv_act="relu",
                                  pool_stride=2),
            f.nets.img_conv_group(x, 4, 2, conv_with_batchnorm=True,
                                  conv_act="relu"),
            f.nets.glu(s), f.nets.glu(s, dim=1),
            f.nets.scaled_dot_product_attention(s, L.scale(s, 0.5), s,
                                                num_heads=2)]
    _loss(f, *[o * o for o in outs])
    return outs


def _feed_common():
    rng = np.random.RandomState(3)
    tied = np.round(rng.randn(3, 8)).astype(np.float32)
    cond = np.round(rng.randn(2, 3, 2)).astype(np.float32)
    return {
        "x": rng.randn(5, 4).astype(np.float32),
        "idx": np.array([[0, 1], [4, 3], [2, 0]], np.int32),
        "ids": np.array([3, 0, 4], np.int32),
        "upd": rng.randn(3, 4).astype(np.float32),
        "upd_nd": rng.randn(3).astype(np.float32),
        "tied": tied, "cond": cond,
        "u_in": rng.randint(-2, 4, 12).astype(np.int32),
        "u_f": np.round(rng.randn(9) * 2).astype(np.float32),
        "sh": rng.randint(0, 20, (6, 1)).astype(np.int64),
    }


def _feed_losses():
    rng = np.random.RandomState(4)
    multi = (rng.rand(6, 5) > 0.5).astype(np.float32)
    return {"p": rng.randn(6, 1).astype(np.float32),
            "q": rng.randn(6, 1).astype(np.float32),
            "lbl01": (rng.rand(6, 1) > 0.5).astype(np.float32),
            "sgn": np.sign(rng.randn(6, 1)).astype(np.float32),
            "logits": rng.randn(6, 5).astype(np.float32),
            "cls": rng.randint(0, 4, (6, 1)).astype(np.int64),
            "multi": multi}


def _feed_xy(xs, ys=None, seed=5):
    rng = np.random.RandomState(seed)
    feed = {"x": rng.randn(*xs).astype(np.float32)}
    if ys:
        feed["y"] = rng.randn(*ys).astype(np.float32)
    return feed


def _feed_maps():
    feed = _feed_xy((2, 3, 4, 5), (2, 2, 4, 5))
    g = np.random.RandomState(6).uniform(-1.2, 1.2, (2, 3, 3, 2))
    g[0, 0, 0] = (-1.0, -1.0)
    g[0, 0, 1] = (1.0, 1.0)
    g[0, 0, 2] = (1.0, -0.5)
    g[1, 2, 2] = (-1.0, 0.25)
    feed["grid"] = g.astype(np.float32)
    return feed


def _feed_nets():
    rng = np.random.RandomState(8)
    return {"x": rng.randn(2, 3, 8, 8).astype(np.float32),
            "s": rng.randn(2, 4, 8).astype(np.float32)}


def _feed_reduce():
    feed = _feed_xy((2, 3, 4), (2, 3, 4))
    feed["y"][0] = feed["x"][0]  # equal values for the comparisons
    return feed


LAYER_CASES = {
    "activations": (_case_activations, lambda: _feed_xy((2, 3, 4, 4)),
                    ("x",)),
    "norms": (_case_norms, lambda: _feed_xy((2, 4, 6, 6)), ("x",)),
    "3d": (_case_3d, lambda: _feed_xy((2, 2, 4, 4, 4)), ("x",)),
    "shapes": (_case_shapes, lambda: _feed_xy((2, 6, 4, 4), (2, 1, 4, 1)),
               ("x", "y")),
    "reduce_compare": (_case_reduce_compare, _feed_reduce, ("x",)),
    "index": (_case_index, _feed_common, ("x", "upd", "upd_nd", "tied")),
    "losses": (_case_losses, _feed_losses, ("p", "q", "logits")),
    "maps": (_case_maps, _feed_maps, ("x", "y", "grid")),
    "nets": (_case_nets, _feed_nets, ("x", "s")),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(case):
    fn, feed, grads = LAYER_CASES[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        got_j, got_t = run_both(fn, feed(), grads)
    assert_same(got_t, got_j)


# -- the op types of the late groups, against the JAX lowering ---------------

@pytest.mark.parametrize("op_type", [t for t in LATE_OPS
                                     if t not in chip_smoke.DENSE_RANDOM_OPS
                                     and t != "unique"])
def test_late_op_matches_jax(op_type):
    ins, attrs, outs, grads = chip_smoke.dense_op_cases()[op_type]
    compare_op(op_type, ins, attrs, outs, grads)


def test_every_new_op_type_is_registered_in_both():
    assert len(chip_smoke.DENSE_OP_TYPES) == 109
    assert len(set(chip_smoke.DENSE_OP_TYPES)) == 109
    for op in chip_smoke.DENSE_OP_TYPES:
        assert JREG.has(op) and TREG.has(op), op
        j, t = JREG.get(op), TREG.get(op)
        assert (j.nondiff_inputs, j.nondiff_outputs, j.stateful,
                j.inplace, j.version) == (
            t.nondiff_inputs, t.nondiff_outputs, t.stateful, t.inplace,
            t.version), op
    assert len(TREG.types()) >= 222


def test_every_nn_layer_but_warpctc_is_in_the_port():
    import paddle_tpu.layers.nn as jnn
    names = [n for n, v in vars(jnn).items() if callable(v)
             and not n.startswith("_")
             and getattr(v, "__module__", "") == jnn.__name__]
    # warpctc came with the CRF and CTC slice: none is missing now
    missing = [n for n in names if not hasattr(ft.layers, n)]
    assert missing == []
    for n in ("less_than", "greater_than", "greater_equal", "not_equal",
              "is_empty", "auc", "pool3d", "adaptive_pool3d",
              "unique_with_counts"):
        assert hasattr(ft.layers, n), n
    for n in ("img_conv_group", "glu", "scaled_dot_product_attention"):
        assert hasattr(ft.nets, n), n


# -- exact cases -------------------------------------------------------------

@pytest.mark.parametrize("width,num_hash,mod_by,dtype", [
    (1, 1, 100000, np.int64), (2, 3, 1000, np.int64),
    (5, 2, 2 ** 31, np.int64), (3, 4, 97, np.int32)])
def test_hash_is_exact(width, num_hash, mod_by, dtype):
    x = np.random.RandomState(width).randint(-10 ** 9, 10 ** 9,
                                             (7, width)).astype(dtype)
    attrs = {"num_hash": num_hash, "mod_by": mod_by}
    got = compare_op("hash", {"X": [x]}, attrs, {"Out": 1}, ())
    out = got["Out"][0].numpy()
    assert out.shape == (7, num_hash, 1) and out.dtype == dtype
    assert (out >= 0).all() and (out < mod_by).all()
    # the port's own XXH64 against the JAX package's on odd lengths
    from paddle_tpu.ops.misc_ops import xxh64 as jxxh64
    from paddle_tpu_torch.ops.misc_ops import xxh64
    for n in (0, 3, 4, 7, 8, 31, 32, 33, 64, 100):
        data = bytes(range(n))
        assert xxh64(data, n) == jxxh64(data, n)


def test_hash_refuses_a_bucket_range_past_int32():
    x = {"X": [torch.zeros((2, 1), dtype=torch.int64)]}
    with pytest.raises(NotImplementedError, match="2\\*\\*31"):
        torch_lower("hash", x, {"num_hash": 1, "mod_by": 2 ** 31 + 1})


def test_argsort_ties_in_both_orders():
    """Ties come out in index order ascending, and in reverse index order
    descending (the JAX lowering flips its stable ascending sort)."""
    x = np.array([[1.0, 0.0, 1.0, 1.0, -2.0, 0.0]], np.float32)
    for desc in (False, True):
        got = compare_op("argsort", {"X": [x]},
                         {"axis": -1, "descending": desc},
                         {"Out": 1, "Indices": 1}, ("X",))
        idx = got["Indices"][0].numpy()[0].tolist()
        assert idx == ([3, 2, 0, 5, 1, 4] if desc else [4, 1, 5, 0, 2, 3])


def test_where_pads_with_minus_one_rows():
    cond = np.array([[0, 2, 0], [1, 0, -1]], np.float32)
    for op in ("where", "where_index"):
        got = compare_op(op, {"Condition": [cond]}, {}, {"Out": 1}, ())
        np.testing.assert_array_equal(
            got["Out"][0].numpy(),
            [[0, 1], [1, 0], [1, 2], [-1, -1], [-1, -1], [-1, -1]])
    none = compare_op("where", {"Condition": [np.zeros((2, 2), bool)]}, {},
                      {"Out": 1}, ())
    assert (none["Out"][0].numpy() == -1).all()


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_])
def test_unique_pads_past_the_unique_count(dtype):
    x = np.array([3, 1, 3, 0, 1, 3, 2], dtype)
    for op, outs in (("unique", {"Out": 1, "Index": 1}),
                     ("unique_with_counts", {"Out": 1, "Index": 1,
                                             "Count": 1})):
        got = compare_op(op, {"X": [x]}, {}, outs, ())
        u = got["Out"][0].numpy()
        n = len(np.unique(x))
        np.testing.assert_array_equal(u[:n], np.unique(x))
        pad = (np.inf if dtype == np.float32 else True if dtype == np.bool_
               else np.iinfo(dtype).max)
        assert (u[n:] == pad).all() and len(u) == len(x)
        np.testing.assert_array_equal(u[got["Index"][0].numpy()], x)
        if "Count" in outs:
            np.testing.assert_array_equal(
                got["Count"][0].numpy(),
                [*np.unique(x, return_counts=True)[1], *[0] * (7 - n)])


def test_unique_of_int64_pads_with_the_int64_max():
    """The JAX package computes int64 ids as int32 (x64 off) and pads
    with the int32 max; the port keeps int64 and pads with its max
    (ROADMAP §C: int64 stays int64). The values and indices agree."""
    x = np.array([5, -2, 5, 7], np.int64)
    oj = jax_lower("unique", {"X": [jnp.asarray(x)]}, {})
    ot = torch_lower("unique", {"X": [torch.from_numpy(x)]}, {})
    np.testing.assert_array_equal(ot["Index"][0].numpy(), oj["Index"][0])
    np.testing.assert_array_equal(ot["Out"][0].numpy()[:3], oj["Out"][0][:3])
    assert int(oj["Out"][0][3]) == np.iinfo(np.int32).max
    assert int(ot["Out"][0][3]) == np.iinfo(np.int64).max


def test_where_and_unique_warn_as_in_jax():
    import paddle_tpu.layers.nn as jnn
    import paddle_tpu_torch.layers.nn as tnn
    msgs = {}
    for f, mod in ((fj, jnn), (ft, tnn)):
        mod._PADDED_CONTRACT_WARNED.clear()
        with pytest.warns(UserWarning) as rec:
            _build(f, lambda f: [f.layers.where(_data(f, "c", (3,))),
                                 *f.layers.unique(_data(f, "u", (3,)))])
            _build(f, lambda f: [f.layers.where(_data(f, "c", (3,)))])
        msgs[f.__name__] = [str(w.message) for w in rec
                            if str(w.message).startswith("layers.")]
        assert len(msgs[f.__name__]) == 2
    assert msgs["paddle_tpu"] == msgs["paddle_tpu_torch"]


def test_lrn_is_not_torch_local_response_norm():
    x = _rand(11, 2, 7, 3, 3)
    attrs = {"n": 5, "k": 2.0, "alpha": 1e-1, "beta": 0.75}
    got = compare_op("lrn", {"X": [x]}, attrs, {"Out": 1, "MidOut": 1},
                     ("X",))["Out"][0].detach().numpy()
    # the formula: k + alpha * the sum of squares over 5 channels
    sq = np.pad(x.astype(np.float64) ** 2, [(0, 0), (2, 2), (0, 0), (0, 0)])
    mid = 2.0 + 1e-1 * sum(sq[:, i:i + 7] for i in range(5))
    np.testing.assert_allclose(got, x / mid ** 0.75, rtol=1e-6)
    lib = torch.nn.functional.local_response_norm(
        torch.from_numpy(x), 5, alpha=1e-1, beta=0.75, k=2.0).numpy()
    assert np.abs(lib - got).max() > 1e-2


def test_grid_sampler_at_the_borders():
    """Corners, edges and points outside [-1, 1]: F.grid_sample
    (align_corners, zero padding) against the JAX lowering, and the
    corners read the corner pixels."""
    x = _rand(12, 1, 2, 3, 4)
    pts = [(-1.0, -1.0), (1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (0.0, 1.0),
           (1.0, 0.3), (-1.0001, 0.0), (1.5, 0.5), (-2.0, -2.0),
           (0.999, -0.999), (0.25, -1.0), (1.0, 1.2)]
    grid = np.array(pts, np.float32).reshape(1, 3, 4, 2)
    got = compare_op("grid_sampler", {"X": [x], "Grid": [grid]}, {},
                     {"Output": 1}, ("X",))["Output"][0].detach().numpy()
    np.testing.assert_allclose(got[0, :, 0, 0], x[0, :, 0, 0], rtol=1e-6)
    np.testing.assert_allclose(got[0, :, 0, 1], x[0, :, 2, 3], rtol=1e-6)
    assert (got[0, :, 2, 0] == 0).all()  # wholly outside


def _case_auc(f):
    L = f.layers
    pred = _data(f, "pred", (16, 2), grad=False)
    label = _data(f, "label", (16, 1), "int64", grad=False)
    auc, _, (pos, neg) = L.auc(pred, label, num_thresholds=31)
    return [auc, pos, neg]


def test_auc_carries_its_state_over_three_batches():
    """Three batches through one scope: the histograms accumulate in
    place, and AUC reads all three. The JAX package's state is int32 and
    its AUC float32 (x64 off); the port's int64 and float64 (ROADMAP §C):
    the values agree."""
    rng = np.random.RandomState(13)
    feeds = []
    for _ in range(3):
        label = rng.randint(0, 2, (16, 1)).astype(np.int64)
        p = np.clip(0.3 * label[:, 0] + rng.rand(16) * 0.7, 0, 1)
        feeds.append({"pred": np.stack([1 - p, p], 1).astype(np.float32),
                      "label": label})
    got_j, got_t = run_both(_case_auc, None, feeds=feeds, carry=False)
    for step, (j, t) in enumerate(zip(got_j, got_t)):
        assert t[0].dtype == np.float64 and t[1].dtype == np.int64
        np.testing.assert_allclose(t[0], j[0], rtol=1e-6)
        np.testing.assert_array_equal(t[1], j[1])
        np.testing.assert_array_equal(t[2], j[2])
        assert int(t[1].sum() + t[2].sum()) == 16 * (step + 1)
    # the closed form over all 48 rows, ties in a bucket counted half
    p = np.concatenate([fd["pred"][:, 1] for fd in feeds])
    y = np.concatenate([fd["label"][:, 0] for fd in feeds])
    b = np.clip((p * 31).astype(np.int64), 0, 31)
    pos, neg = b[y == 1], b[y == 0]
    want = np.mean([(pp > nn) + 0.5 * (pp == nn) for pp in pos
                    for nn in neg])
    np.testing.assert_allclose(got_t[-1][0], want, rtol=1e-12)


# -- random ops, by distribution ---------------------------------------------

def test_randint_by_range_and_frequency():
    got = torch_lower("randint", {}, {"shape": [200, 100], "low": -3,
                                       "high": 7})["Out"][0].numpy()
    assert got.dtype == np.int64 and got.shape == (200, 100)
    assert got.min() == -3 and got.max() == 6
    freq = np.bincount(got.reshape(-1) + 3) / got.size
    assert np.abs(freq - 0.1).max() < 0.01
    jax_got = np.asarray(jax_lower("randint", {}, {
        "shape": [200, 100], "low": -3, "high": 7})["Out"][0])
    assert abs(got.mean() - jax_got.mean()) < 0.05


def test_sampling_id_by_frequency():
    p = np.array([0.1, 0.6, 0.0, 0.3], np.float32)
    x = np.tile(p, (20000, 1))
    got = torch_lower("sampling_id", {"X": [torch.from_numpy(x)]},
                       {})["Out"][0].numpy()
    assert got.dtype == np.int64 and got.shape == (20000,)
    freq = np.bincount(got, minlength=4) / len(got)
    assert freq[2] == 0 and np.abs(freq - p).max() < 0.015
    jfreq = np.bincount(np.asarray(jax_lower(
        "sampling_id", {"X": [jnp.asarray(x)]}, {})["Out"][0]),
        minlength=4) / len(got)
    assert np.abs(freq - jfreq).max() < 0.02


def test_uniform_random_batch_size_like_by_range_and_moments():
    ref = torch.zeros((6, 3))
    got = torch_lower("uniform_random_batch_size_like", {"Input": [ref]},
                       {"shape": [-1, 5000], "min": -2.0, "max": 3.0,
                        "dtype": "float32"})["Out"][0].numpy()
    assert got.shape == (6, 5000) and got.dtype == np.float32
    assert got.min() >= -2.0 and got.max() < 3.0
    assert abs(got.mean() - 0.5) < 0.03
    assert abs(got.std() - 5 / math.sqrt(12)) < 0.02


def test_random_layers_by_moments():
    def build(f):
        p = _data(f, "p", (5000, 3), grad=False)
        return [f.layers.uniform_random([400, 300], min=-1.0, max=2.0),
                f.layers.gaussian_random([400, 300], mean=0.5, std=2.0),
                f.layers.sampling_id(p)]
    mj, _, fetch = _build(fj, build)
    mt, _, _ = _build(ft, build)
    assert mt.to_json() == mj.to_json()
    p = np.tile(np.array([0.2, 0.0, 0.8], np.float32), (5000, 1))
    u, g, ids = ft.Executor(ft.CPUPlace()).run(
        mt, feed={"p": p}, fetch_list=[v.name for v in fetch],
        scope=ft.Scope())
    assert u.min() >= -1.0 and u.max() < 2.0
    assert abs(u.mean() - 0.5) < 0.02 and abs(u.std() - 3 / 12 ** .5) < 0.01
    assert abs(g.mean() - 0.5) < 0.03 and abs(g.std() - 2.0) < 0.02
    assert ids.shape == (5000,) and not (ids == 1).any()
    assert abs((ids == 2).mean() - 0.8) < 0.03
