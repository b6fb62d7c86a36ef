"""Control-flow ops: while, conditional_block, select_input, the tensor
array ops, print, feed and fetch.

A sub-block runs op by op in the caller's run (``_OpCtx.
lower_sub_block``) on a copy of the outer env, so a body's temporaries
never leak out; only the vars an op lists as outputs do. Eager PyTorch
has no structured control flow, so the two data-dependent ops read their
predicate on the host:

- ``while`` reads its condition before every iteration (one device sync
  an iteration, counted in ``HOST_SYNCS``). The carried vars keep their
  shapes and dtypes across iterations, as an XLA While demands; a body
  that changes one raises.
- ``conditional_block`` reads its predicate once and runs the body only
  when it holds. A skipped block keeps each output's live value (what an
  earlier Switch case or an earlier step wrote); an output with no value
  gets a NaN (float), False (bool) or dtype-max (integer) sentinel, with
  one warning per var.

Neither lowering can run on ``meta`` tensors (there is no predicate to
read): the analysis takes their output specs from ``_carry_out_specs``,
their registered abstract-eval rule. A tensor array is one stacked tensor
of a static ``max_len`` (``write_to_array``'s attr, 64 by default);
``lod_array_length`` returns that ``max_len``, not the number of writes,
and an index past the end is clamped to the last slot, as XLA's dynamic
slices clamp.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.lowering import LowerCtx, run_op
from ..core.registry import register_abstract_eval, register_op

# predicate reads on the host: "while" (one an iteration, plus the read
# that ends the loop) and "conditional_block" (one a run of the op)
HOST_SYNCS = {"while": 0, "while_iterations": 0, "conditional_block": 0}


def _host_bool(t, kind):
    if t.device.type == "meta":
        raise RuntimeError(
            f"{kind}: the predicate cannot be read on meta tensors; the "
            f"analysis takes this op's shapes from its abstract-eval rule")
    HOST_SYNCS[kind] += 1
    return bool(t.reshape(()))


@register_op("feed")
def _feed(ctx, ins, attrs):
    return {"Out": [ins["X"][attrs.get("col", 0)]]} if "X" in ins else {}


@register_op("fetch")
def _fetch(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}


@register_op("print")
def _print(ctx, ins, attrs):
    """Prints "<message> <value>" on the host (a sync); Out is In."""
    x = ins["In"][0]
    if x.device.type != "meta":
        print(attrs.get("message", "") + " " +
              str(np.asarray(x.detach().cpu())))
    return {"Out": [x]}


@register_op("while")
def _while(ctx, ins, attrs):
    """Run the sub-block while attrs['condition'] holds. The carried state
    is attrs['carried_vars'] (the outer vars the body writes, and the
    condition); the body reads the other inputs as they were."""
    block = ctx.sub_block(attrs["sub_block"])
    cond_name = attrs["condition"]
    carried = attrs["carried_vars"]
    outer_env = dict(zip(attrs["input_vars"], ins["X"]))
    state = {k: outer_env[k] for k in carried}
    if cond_name not in state:
        state[cond_name] = outer_env[cond_name]
    specs = {k: (v.shape, v.dtype) for k, v in state.items()}
    while _host_bool(state[cond_name], "while"):
        HOST_SYNCS["while_iterations"] += 1
        env = dict(outer_env)
        env.update(state)
        ctx.lower_sub_block(block, env)
        state = {k: env[k] for k in state}
        for k, v in state.items():
            if (v.shape, v.dtype) != specs[k]:
                raise ValueError(
                    f"while: carried var {k!r} changed from "
                    f"{tuple(specs[k][0])} {specs[k][1]} to "
                    f"{tuple(v.shape)} {v.dtype} in the body; carried "
                    f"vars keep their shapes and dtypes")
    return {"Out": [state[k] for k in attrs["output_vars"]]}


_WARNED_UNSET = set()  # once-per-var unset-output warnings


def _sentinel(spec, device):
    shape, dtype = spec
    if dtype.is_floating_point:
        return torch.full(shape, float("nan"), dtype=dtype, device=device)
    if dtype == torch.bool:
        return torch.zeros(shape, dtype=dtype, device=device)
    return torch.full(shape, torch.iinfo(dtype).max, dtype=dtype,
                      device=device)


def _branch_specs(ctx, block, env, names):
    """(shape, dtype) of the body's outputs `names`: the body run on meta
    tensors of env's specs."""
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in env.items()}
    mctx = LowerCtx("meta")
    for i, op in enumerate(block.ops):
        run_op(op, meta, mctx, op_idx=i)
    return [(meta[k].shape, meta[k].dtype) for k in names]


@register_op("conditional_block")
def _conditional_block(ctx, ins, attrs):
    block = ctx.sub_block(attrs["sub_block"])
    input_names = attrs.get("input_vars", [])
    outer_env = dict(zip(input_names, ins.get("Input", [])))
    out_names = attrs["output_vars"]
    live = getattr(ctx, "env", None) or {}
    prev = {k: live[k] for k in out_names if k in live}
    env = dict(outer_env)
    env.update(prev)
    if _host_bool(ins["Cond"][0], "conditional_block"):
        ctx.lower_sub_block(block, env)
        return {"Out": [env[k] for k in out_names]}
    outs, specs = [], None
    for i, k in enumerate(out_names):
        if k in env:
            outs.append(env[k])
            continue
        if k not in _WARNED_UNSET:
            _WARNED_UNSET.add(k)
            warnings.warn(
                f"conditional_block output {k!r} has no value when the "
                f"branch is skipped; reads on skipped paths see "
                f"NaN/int-max sentinels. Benign if a complementary "
                f"branch always writes it.")
        if specs is None:
            specs = _branch_specs(ctx, block, env, out_names)
        outs.append(_sentinel(specs[i], ctx.device))
    return {"Out": outs}


@register_op("select_input")
def _select_input(ctx, ins, attrs):
    """Out = X[Mask], the index read on the device (inputs of one
    shape)."""
    mask = ins["Mask"][0].reshape(()).long()
    xs = ins["X"]
    return {"Out": [torch.stack(xs)[mask.clamp(0, len(xs) - 1)]]}


@register_op("write_to_array", nondiff_inputs=("I",))
def _write_to_array(ctx, ins, attrs):
    x = ins["X"][0]
    if "Array" in ins:
        arr = ins["Array"][0]
    else:
        arr = torch.zeros((attrs.get("max_len", 64),) + tuple(x.shape),
                          dtype=x.dtype, device=x.device)
    i = ins["I"][0].reshape(1).long().clamp(0, arr.shape[0] - 1)
    return {"Out": [arr.index_copy(0, i, x.unsqueeze(0).to(arr.dtype))]}


@register_op("read_from_array", nondiff_inputs=("I",))
def _read_from_array(ctx, ins, attrs):
    arr = ins["X"][0]
    i = ins["I"][0].reshape(1).long().clamp(0, arr.shape[0] - 1)
    return {"Out": [arr.index_select(0, i)[0]]}


@register_op("lod_array_length", nondiff_outputs=("Out",))
def _lod_array_length(ctx, ins, attrs):
    arr = ins["X"][0]
    return {"Out": [torch.tensor([arr.shape[0]], dtype=torch.int64,
                                 device=arr.device)]}


@register_op("tensor_array_to_tensor")
def _tensor_array_to_tensor(ctx, ins, attrs):
    arr = ins["X"][0]
    axis = attrs.get("axis", 0)
    parts = list(arr.unbind(0))
    if attrs.get("use_stack", False):
        return {"Out": [torch.stack(parts, dim=axis)],
                "OutIndex": [torch.ones(len(parts), dtype=torch.int32,
                                        device=arr.device)]}
    return {"Out": [torch.cat(parts, dim=axis)],
            "OutIndex": [torch.tensor([p.shape[axis] for p in parts],
                                      dtype=torch.int32,
                                      device=arr.device)]}


# ---------------------------------------------------------------------------
# Static shape rules for the analysis (analysis/shape_infer.py): a
# control-flow output keeps the spec of the var it carries.
# ---------------------------------------------------------------------------

def _sub_block_of(op, block):
    sb = op.attrs.get("sub_block")
    if isinstance(sb, dict):
        sb = sb.get("__block__")
    blocks = block.program.blocks
    if isinstance(sb, int) and 0 < sb < len(blocks):
        return blocks[sb]
    return None


def _carry_out_specs(op, in_specs, block):
    """Out[i] takes the spec of attrs['output_vars'][i], the carried or
    branch-written inner var; else the declared spec of the inner or the
    outer var."""
    from ..analysis.shape_infer import declared_spec

    sub = _sub_block_of(op, block)
    out = {}
    inner_names = op.attrs.get("output_vars", []) or []
    outer_names = op.outputs.get("Out", [])
    for outer, inner in zip(outer_names, inner_names):
        if not outer:
            continue
        spec = in_specs.get(inner)
        if spec is None and sub is not None:
            v = sub._find_var_recursive(inner)
            if v is not None:
                spec = declared_spec(v)
        if spec is None:
            v = block._find_var_recursive(outer)
            if v is not None:
                spec = declared_spec(v)
        if spec is not None:
            out[outer] = spec
    return out


register_abstract_eval("while")(_carry_out_specs)
register_abstract_eval("conditional_block")(_carry_out_specs)
