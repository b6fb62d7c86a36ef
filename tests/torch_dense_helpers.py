"""Shared by the dense-layer slice's CPU tests: chip_smoke.py loaded by
path (its dense_op_cases table), and both packages' lowerings of one op
run side by side with their gradients."""
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu  # noqa: F401  — registers the JAX lowerings
import paddle_tpu_torch  # noqa: F401  — registers the port's lowerings
from paddle_tpu.core import lowering as jlow
from paddle_tpu.core.registry import REGISTRY as JREG
from paddle_tpu_torch.core import lowering as tlow
from paddle_tpu_torch.core.registry import REGISTRY as TREG

FLOAT_TOL = 1e-6

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                               "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def assert_same(got_t, got_j, tol=FLOAT_TOL):
    for i, (t, j) in enumerate(zip(got_t, got_j)):
        t, j = np.asarray(t), np.asarray(j)
        assert t.shape == j.shape, (i, t.shape, j.shape)
        if j.dtype.kind == "f":
            scale = max(1.0, float(np.abs(j).max(initial=0.0)))
            np.testing.assert_allclose(t, j, rtol=0, atol=tol * scale,
                                       err_msg=str(i))
        else:
            assert t.dtype.kind == j.dtype.kind, (i, t.dtype, j.dtype)
            np.testing.assert_array_equal(t, j, err_msg=str(i))


def _op(attrs):
    return types.SimpleNamespace(attrs=dict(attrs), id=7, block=None,
                                 type="op", outputs={})


def jax_lower(op_type, ins, attrs):
    ctx = jlow._OpCtx(jlow.LowerCtx(jax.random.PRNGKey(0)), _op(attrs))
    return JREG.get(op_type).lower(ctx, ins, attrs)


def torch_lower(op_type, ins, attrs):
    ctx = tlow._OpCtx(tlow.LowerCtx("cpu", seed=5), _op(attrs))
    return TREG.get(op_type).lower(ctx, ins, attrs)


def compare_op(op_type, ins, attrs, outs, grad_slots, tol=FLOAT_TOL):
    """Both lowerings on `ins`: every output of `outs` (floats within
    `tol` of max(1, max|JAX|), the rest exactly, dtype kinds equal), and
    the gradients of `grad_slots` for seeded cotangents of every float
    output that is not marked non-differentiable. Returns the port's
    outputs."""
    jins = {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}
    tins = {s: [torch.from_numpy(np.array(a)) for a in v]
            for s, v in ins.items()}
    for s in grad_slots:
        tins[s] = [t.requires_grad_() for t in tins[s]]
    oj = jax_lower(op_type, jins, attrs)
    with torch.enable_grad():
        ot = torch_lower(op_type, tins, attrs)
    for s in outs:
        assert len(oj[s]) == len(ot[s]) == outs[s], s
        assert_same([t.detach().numpy() for t in ot[s]],
                    [np.asarray(a) for a in oj[s]], tol)
    if not grad_slots:
        return ot
    rng = np.random.RandomState(9)
    nondiff = JREG.get(op_type).nondiff_outputs
    diff = [(s, i) for s in outs if s not in nondiff
            for i, a in enumerate(oj[s])
            if jnp.issubdtype(a.dtype, jnp.floating)]
    cot = {k: np.asarray(rng.randn(*np.shape(oj[k[0]][k[1]])), np.float32)
           for k in diff}

    def jax_obj(*leaves):
        j, it = dict(jins), iter(leaves)
        for s in grad_slots:
            j[s] = [next(it) for _ in ins[s]]
        o = jax_lower(op_type, j, attrs)
        return sum(jnp.sum(o[s][i] * cot[s, i]) for s, i in diff)

    leaves = [a for s in grad_slots for a in jins[s]]
    gj = jax.grad(jax_obj, argnums=tuple(range(len(leaves))))(*leaves)
    tleaves = [t for s in grad_slots for t in tins[s]]
    obj = sum((ot[s][i] * torch.from_numpy(cot[s, i])).sum()
              for s, i in diff)
    gt = torch.autograd.grad(obj, tleaves, allow_unused=True)
    for a, t in zip(gj, gt):
        a = np.asarray(a)
        t = np.zeros_like(a) if t is None else t.numpy()
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(t, a, rtol=0, atol=tol * scale)
    return ot


