"""Whole-program shape & dtype propagation with zero device work.

The lowering IS the shape function: each op runs its registered PyTorch
lowering on ``meta`` tensors (shapes and dtypes, no data, no kernel),
the trick ``lowering.infer_op_shapes`` plays when an op is appended,
extended to propagate through a whole Program (ops appended with
infer_shape=False included) and to CHECK the inferred specs against the
declared Variable.shape/dtype instead of writing them back. The JAX
package does the same with ``jax.eval_shape``.

Dtypes are reported in the IR's names, which follow the JAX package's
64-bit-off inference (``lowering.ir_dtype``: an int64 output reads
int32), so PTV020/021 fire where the JAX package's fire.

Ops that cannot run on meta tensors:

- ``grad::generic`` runs autograd over its forward op's record, which
  exists only in a run. Its shape rule is the vjp's: each input gradient
  has its primal's spec.
- `OPAQUE_OPS`: host/RPC/IO/LoD-array/collective ops whose outputs take
  their declared specs unchecked (the spec-band rules do not fire for
  them; the dataflow lints in verifier.py still do).

A spec is `(shape, dtype_name)` with -1 marking dynamic dims. Declared
shapes of `None` or `()` are treated as unknown — `Variable.to_dict`
serializes None as [], so a round-tripped unknown is indistinguishable
from a scalar; treating both as unknown forfeits checking on true
scalars but can never produce a false positive.

Specs are computed once per (program fingerprint, seed): the verifier's
gate and the memory gate of one program and feed signature share them
(`program_specs`).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import threading
from collections import OrderedDict

import torch

from ..core import lowering
from ..core.dtypes import as_torch_dtype
from ..core.registry import REGISTRY


class Spec(NamedTuple):
    """(shape, dtype_name) with -1 marking dynamic dims.

    A NamedTuple so the historical plain-tuple protocol still holds —
    `shape, dtype = spec`, equality against `(shape, dtype)`, and plain
    tuples returned by abstract_eval rules all keep working; consumers
    that need methods normalize with `Spec(*spec)`.
    """

    shape: Tuple[int, ...]
    dtype: str

    def nbytes(self, dyn_defaults: int = 1) -> Tuple[int, bool]:
        """Size in bytes -> (nbytes, dynamic).

        Dynamic dims (-1, or the _DYN_DIM placeholder family) are
        substituted with `dyn_defaults` elements each, so with the
        default of 1 the returned byte count is a documented LOWER
        BOUND whenever `dynamic` is True. Callers doing budget math
        (PTV050) must surface the marker instead of presenting the
        bound as exact; resolving real feed shapes first (the memory
        gate's seed path) clears the marker.
        """
        dynamic = False
        n = 1
        for d in self.shape:
            d = int(d)
            if d < 0 or d >= _DYN:
                dynamic = True
                d = int(dyn_defaults)
            n *= max(d, 0)
        itemsize = as_torch_dtype(self.dtype).itemsize
        return n * itemsize, dynamic


# Dynamic-dim placeholder shared with lowering.infer_op_shapes: dims this
# large (or products thereof) read back as dynamic.
_DYN = lowering._DYN_DIM

# Ops whose lowering needs runtime machinery an abstract env cannot
# supply: TensorArray vars hold Python lists (not tensors),
# host/RPC/IO ops talk to the outside world, mesh collectives need bound
# axis names. Their outputs take declared specs unchecked.
OPAQUE_OPS = frozenset({
    # executor plumbing
    "feed", "fetch",
    # TensorArray / LoD / decode-loop ops (env values are host lists)
    "write_to_array", "read_from_array", "tensor_array_to_tensor",
    "lod_array_length", "array_to_lod_tensor", "lod_tensor_to_array",
    "merge_lod_tensor", "split_lod_tensor", "lod_rank_table",
    "max_sequence_len", "shrink_rnn_memory", "rnn_memory_helper",
    "reorder_lod_tensor_by_rank", "beam_search", "beam_search_decode",
    "beam_reorder", "gather_tree", "select_input",
    # host-side PS/RPC runtime ops
    "listen_and_serv", "fl_listen_and_serv", "send", "recv", "prefetch",
    "fetch_barrier", "send_barrier", "gen_nccl_id", "c_gen_nccl_id",
    "c_comm_init", "c_comm_init_all", "checkpoint_notify",
    "geo_sgd_send", "ref_by_trainer_id", "distributed_lookup_table",
    "lookup_sparse_table", "split_ids", "merge_ids", "split_byref",
    "delete_var", "distributed_notify", "push_box_sparse",
    # host IO / readers
    "save", "save_combine", "load", "load_combine", "read",
    "create_custom_reader",
    # mesh collectives (axis names unbound outside shard_map)
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_allgather", "c_reducescatter", "c_broadcast",
    "c_sync_calc_stream", "c_sync_comm_stream", "allreduce", "broadcast",
    "shard_hint", "ring_attention", "ulysses_attention", "c_alltoall",
    "moe_ffn", "sync_batch_norm",
    # misc host-side
    "py_func", "get_places", "fake_init", "coalesce_tensor",
    "recurrent", "recompute_segment", "conditional_block_infer",
    "split_selected_rows", "merge_selected_rows",
    "get_tensor_from_selected_rows",
})


def declared_spec(var) -> Optional[Spec]:
    """(shape, dtype) from a Variable's declaration, None if unknown."""
    shp = getattr(var, "shape", None)
    if not shp:  # None or () — see module docstring
        return None
    return Spec(tuple(int(d) for d in shp), str(var.dtype))


def _dims_match(inferred, declared) -> bool:
    if len(inferred) != len(declared):
        return False
    for a, b in zip(inferred, declared):
        # -1 and _DYN-derived dims are wildcards on either side
        if a < 0 or b < 0 or a >= _DYN or b >= _DYN:
            continue
        if int(a) != int(b):
            return False
    return True


def _eval_op(op, in_specs: Dict[str, Spec]) -> Dict[str, Spec]:
    """{in name: spec} -> {out name: spec} of one op. Raises whatever its
    lowering raises on meta tensors.

    An op's output specs are a function of its type, its attrs, its
    input specs and which outputs name one of its inputs, so they are
    memoized on exactly that: the layers of a deep model repeat the same
    ops at the same shapes, and a lowering run on meta tensors costs a
    fraction of a millisecond an op (the update ops several)."""
    rule = _SHAPE_RULES.get(op.type)
    if rule is not None:
        return rule(op, in_specs)
    key = _op_key(op, in_specs)
    hit = _OP_MEMO.get(key) if key is not None else None
    if hit is None:
        try:
            specs = _run_on_meta(op, in_specs)
            hit = ("ok", [specs.get(n) if n else None
                          for ns in op.outputs.values() for n in ns])
        except Exception as e:  # noqa: BLE001 — replayed to the caller
            hit = ("error", e)
        if key is not None:
            if len(_OP_MEMO) >= _OP_MEMO_CAP:
                _OP_MEMO.clear()
            _OP_MEMO[key] = hit
    kind, val = hit
    if kind == "error":
        raise val
    names = [n for ns in op.outputs.values() for n in ns]
    return {n: spec for n, spec in zip(names, val)
            if n and spec is not None}


_OP_MEMO: Dict[tuple, tuple] = {}
_OP_MEMO_CAP = 50000


def _op_key(op, in_specs):
    """(type, attrs, input specs by slot, each output's input alias), or
    None when the attrs do not serialize."""
    import json

    from ..framework import _jsonable_attrs
    try:
        attrs = json.dumps(_jsonable_attrs(op.attrs), sort_keys=True)
    except (TypeError, ValueError):
        return None
    flat = [n for ns in op.inputs.values() for n in ns]
    ins = tuple((slot, tuple(in_specs.get(n) if n else None for n in ns))
                for slot, ns in op.inputs.items())
    outs = tuple((slot, tuple(flat.index(n) if n in flat else -1
                              for n in ns))
                 for slot, ns in op.outputs.items())
    return (op.type, attrs, ins, outs)


def _run_on_meta(op, in_specs: Dict[str, Spec]) -> Dict[str, Spec]:
    """Run one op's lowering on meta tensors."""
    env = {}
    for n, (shape, dtype) in in_specs.items():
        shp = tuple(_DYN if d == -1 else int(d) for d in shape)
        env[n] = torch.empty(shp, dtype=as_torch_dtype(dtype),
                             device="meta")
    lowering.run_op(op, env, lowering.LowerCtx("meta"))
    specs = {}
    for name in op.output_names():
        val = env.get(name) if name else None
        if val is None:
            continue
        shape = tuple(-1 if d >= _DYN else int(d) for d in val.shape)
        specs[name] = Spec(shape, lowering.ir_dtype(val.dtype))
    return specs


def _grad_spec(op, in_specs: Dict[str, Spec]) -> Dict[str, Spec]:
    """grad::generic: each input gradient takes its primal's spec (what
    the vjp gives), read from the grad op's own copy of the forward op's
    inputs."""
    specs = {}
    for gslot, names in op.outputs.items():
        primals = op.inputs.get(gslot[:-len(lowering.GRAD_SUFFIX)], [])
        for name, primal in zip(names, primals):
            if name and primal in in_specs:
                specs[name] = Spec(*in_specs[primal])
    return specs


_SHAPE_RULES = {"grad::generic": _grad_spec}


def infer_program_specs(program, result, check=True,
                        seed: Optional[Dict[str, Spec]] = None
                        ) -> Dict[str, Spec]:
    """Propagate specs through every block; append PTV020/021/022
    findings to `result`. Returns the global block's final spec env.

    seed: {var name: (shape, dtype)} pre-loaded into the global block's
    env before propagation — the memory gate seeds the concrete feed
    shapes here so dynamic (-1/_DYN_DIM) dims resolve downstream
    instead of poisoning size arithmetic (Spec.nbytes)."""
    envs: Dict[int, Dict[str, Spec]] = {}
    for block in program.blocks:
        parent = envs.get(block.parent_idx, {}) \
            if block.parent_idx >= 0 else {}
        env = dict(parent)
        if block.idx == 0 and seed:
            for name, spec in seed.items():
                env[str(name)] = Spec(tuple(int(d) for d in spec[0]),
                                      str(spec[1]))
        envs[block.idx] = env
        for op_idx, op in enumerate(block.ops):
            _infer_op(op, op_idx, block, env, result, check)
    return envs.get(0, {})


def _seed_outputs_from_decl(op, block, env):
    for name in op.output_names():
        if not name or name in env:
            continue
        var = block._find_var_recursive(name)
        spec = declared_spec(var) if var is not None else None
        if spec is not None:
            env[name] = spec


def _infer_op(op, op_idx, block, env, result, check):
    opdef = REGISTRY._ops.get(op.type)
    if opdef is None or op.type in OPAQUE_OPS:
        # unregistered is the verifier's PTV001; opaque is by design —
        # either way outputs take declared specs so propagation continues
        _seed_outputs_from_decl(op, block, env)
        return

    in_specs: Dict[str, Spec] = {}
    missing = False
    for name in op.input_names():
        if not name or name in in_specs:
            continue
        spec = env.get(name)
        if spec is None:
            var = block._find_var_recursive(name)
            spec = declared_spec(var) if var is not None else None
        if spec is None:
            missing = True
            break
        in_specs[name] = spec

    if getattr(opdef, "abstract_eval", None) is not None:
        try:
            out = opdef.abstract_eval(op, in_specs, block) or {}
        except Exception as e:  # noqa: BLE001 — a broken rule is a finding
            result.add("PTV022",
                       f"abstract-eval rule for {op.type!r} failed: "
                       f"{type(e).__name__}: {e}",
                       op_type=op.type, block=block.idx, op_idx=op_idx)
            out = {}
        for name, spec in out.items():
            env[name] = spec
            if check:
                _check_against_decl(op, op_idx, block, name, spec, result)
        _seed_outputs_from_decl(op, block, env)
        return

    if missing:
        # an input spec is unknowable (same bail as infer_op_shapes'
        # "cannot infer yet") — not a finding, just lost coverage
        _seed_outputs_from_decl(op, block, env)
        return

    try:
        out = _eval_op(op, in_specs)
    except Exception as e:  # noqa: BLE001 — the whole point: any crash
        # inside the lowering on meta tensors means this program cannot
        # lower, reported with op provenance instead of a jnp traceback
        msg = str(e).split("\n", 1)[0][:300]
        result.add("PTV022",
                   f"lowering failed on meta tensors: "
                   f"{type(e).__name__}: {msg}",
                   op_type=op.type, block=block.idx, op_idx=op_idx)
        _seed_outputs_from_decl(op, block, env)
        return

    for name, spec in out.items():
        env[name] = spec
        if check:
            _check_against_decl(op, op_idx, block, name, spec, result)
    _seed_outputs_from_decl(op, block, env)


def _check_against_decl(op, op_idx, block, name, spec, result):
    var = block._find_var_recursive(name)
    decl = declared_spec(var) if var is not None else None
    if decl is None:
        return
    shape, dtype = spec
    dshape, ddtype = decl
    if not _dims_match(shape, dshape):
        result.add("PTV020",
                   f"output {name!r}: inferred shape {list(shape)} vs "
                   f"declared {list(dshape)}",
                   op_type=op.type, block=block.idx, op_idx=op_idx,
                   var=name)
    try:
        same = lowering.ir_dtype(dtype) == lowering.ir_dtype(ddtype)
    except ValueError:
        same = dtype == ddtype
    if not same:
        result.add("PTV021",
                   f"output {name!r}: inferred dtype {dtype} vs "
                   f"declared {ddtype}",
                   op_type=op.type, block=block.idx, op_idx=op_idx,
                   var=name)


# ---------------------------------------------------------------------------
# specs shared by the verifier's and the memory planner's gates
# ---------------------------------------------------------------------------

_MEMO_LOCK = threading.Lock()
_SPEC_MEMO: "OrderedDict[tuple, tuple]" = OrderedDict()
_MEMO_CAP = 64


def reset_memo():
    """Drop the shared spec memos (tests; after re-registering ops)."""
    with _MEMO_LOCK:
        _SPEC_MEMO.clear()
        _OP_MEMO.clear()


def program_specs(program, seed: Optional[Dict[str, Spec]] = None):
    """(global-block spec env, PTV020/021/022 findings) of `program`
    under `seed`, computed once per (fingerprint, seed) and shared: the
    verifier reads the findings, the memory planner the env. Callers
    must not mutate either."""
    sig = tuple(sorted((str(n), tuple(int(d) for d in s[0]), str(s[1]))
                       for n, s in (seed or {}).items()))
    key = (program.fingerprint(), sig)
    with _MEMO_LOCK:
        hit = _SPEC_MEMO.get(key)
        if hit is not None:
            _SPEC_MEMO.move_to_end(key)
            return hit
    from .diagnostics import VerifyResult
    res = VerifyResult()
    env = infer_program_specs(
        program, res, check=True,
        seed={n: (shp, dt) for n, shp, dt in sig} or None)
    out = (env, tuple(res.findings))
    with _MEMO_LOCK:
        _SPEC_MEMO[key] = out
        while len(_SPEC_MEMO) > _MEMO_CAP:
            _SPEC_MEMO.popitem(last=False)
    return out
