"""Program IR + graph-construction frontend.

The same IR as the JAX package's ``framework.py``: Variables, Operators,
Blocks and Programs are plain Python objects that serialize to a dict
(JSON). The serialized form is byte-identical between the two packages,
so a program built by either loads in the other with the same
``fingerprint()``.

Shape inference is derived from the op lowerings: appending an op runs
its PyTorch lowering on ``meta`` tensors (core/lowering.py).
"""
from __future__ import annotations

import contextlib
import copy
import hashlib
import json
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from .core.dtypes import convert_dtype

__all__ = [
    "Variable", "Parameter", "Operator", "Block", "Program",
    "default_main_program", "default_startup_program", "program_guard",
    "unique_name", "ParamAttr", "WeightNormParamAttr", "grad_var_name",
    "in_dygraph_mode", "name_scope", "cpu_places",
]

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


class UniqueNameGenerator:
    def __init__(self):
        self.ids = defaultdict(int)
        self.prefix = ""

    def __call__(self, key: str) -> str:
        name = f"{self.prefix}{key}_{self.ids[key]}"
        self.ids[key] += 1
        return name


_name_gen = UniqueNameGenerator()


class _UniqueNameModule:
    """unique_name.generate(key) / unique_name.guard(prefix)."""

    @staticmethod
    def generate(key):
        return _name_gen(key)

    @staticmethod
    @contextlib.contextmanager
    def guard(prefix=""):
        global _name_gen
        old = _name_gen
        _name_gen = UniqueNameGenerator()
        _name_gen.prefix = prefix
        try:
            yield
        finally:
            _name_gen = old


unique_name = _UniqueNameModule()

_name_scope_stack: List[str] = []


@contextlib.contextmanager
def name_scope(prefix):
    """A named scope for the ops built inside it. Names are recorded on a
    stack only; they change no var or op name, as in the JAX package."""
    _name_scope_stack.append(prefix)
    try:
        yield
    finally:
        _name_scope_stack.pop()


class Variable:
    """A named tensor in a Block. Static metadata only; values live in a
    Scope at run time."""

    def __init__(self, block, name, shape=None, dtype="float32", lod_level=0,
                 persistable=False, stop_gradient=False, is_data=False,
                 trainable=True, **kw):
        self.block = block
        self.name = name
        self.shape = (tuple(int(s) for s in shape) if shape is not None
                      else None)
        self.dtype = convert_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.trainable = trainable

    @property
    def is_parameter(self):
        return isinstance(self, Parameter)

    # -- operator sugar, so schedules read like fluid: a scalar operand
    # becomes one `scale` op, as in the JAX package --------------------
    def _binary(self, other, op):
        from .layers import math_ops
        return math_ops.elementwise_binary(op, self, other)

    def __add__(self, o):
        return self._binary(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "elementwise_sub")

    def __mul__(self, o):
        return self._binary(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "elementwise_div")

    def __repr__(self):
        p = " persistable" if self.persistable else ""
        return f"Var({self.name}: {self.dtype}{list(self.shape or [])}{p})"

    def to_dict(self):
        return {
            "name": self.name, "shape": list(self.shape or []),
            "dtype": self.dtype, "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient, "is_data": self.is_data,
            "trainable": self.trainable,
            "is_parameter": self.is_parameter,
        }


class Parameter(Variable):
    """Trainable persistable variable."""

    def __init__(self, block, name, shape, dtype, trainable=True,
                 regularizer=None, optimize_attr=None, **kw):
        super().__init__(block, name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=not trainable,
                         trainable=trainable, **kw)
        self.regularizer = regularizer
        self.optimize_attr = optimize_attr or {"learning_rate": 1.0}
        self.do_model_average = kw.get("do_model_average", False)


class Operator:
    """One op in a block. inputs/outputs: {slot: [var names]}; attrs are
    JSON-able values only."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None,
                 op_id=None):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = {
            k: list(v) for k, v in (inputs or {}).items()}
        self.outputs: Dict[str, List[str]] = {
            k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        # stable per-program id: seeds the op's random stream
        self.id = op_id if op_id is not None else block.program._next_op_id()

    def input_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def has_attr(self, name):
        return name in self.attrs

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def __repr__(self):
        return (f"Op({self.type}: " +
                ", ".join(f"{k}={v}" for k, v in self.inputs.items()) +
                " -> " + ", ".join(f"{k}={v}" for k, v in self.outputs.items())
                + ")")

    def to_dict(self):
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": _jsonable_attrs(self.attrs),
                "id": self.id}


def _jsonable_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def _attrs_from_json(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
        else:
            out[k] = v
    return out


class Block:
    """A straight-line list of ops + a symbol table."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    def create_var(self, name=None, **kw):
        name = name or unique_name.generate("tmp")
        var = Variable(self, name, **kw)
        self.vars[name] = var
        self.program._fp_cache = None
        return var

    def create_parameter(self, name, shape, dtype, **kw):
        p = Parameter(self, name, shape, dtype, **kw)
        self.vars[name] = p
        self.program._fp_cache = None
        return p

    def var(self, name) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"var {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = (self.program.blocks[blk.parent_idx]
                   if blk.parent_idx >= 0 else None)
        return None

    @property
    def parent(self):
        return (self.program.blocks[self.parent_idx]
                if self.parent_idx >= 0 else None)

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program._fp_cache = None
        if infer_shape:
            from .core import lowering
            try:
                lowering.infer_op_shapes(op, self)
            except NotImplementedError:
                pass  # op without lowering yet; shapes must be pre-set
        return op

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def to_dict(self):
        return {"idx": self.idx, "parent_idx": self.parent_idx,
                "vars": [v.to_dict() for v in self.vars.values()],
                "ops": [o.to_dict() for o in self.ops]}


class Program:
    """Serializable multi-block program."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.random_seed = 0
        self._current_block_idx = 0
        self._op_counter = 0
        self._version = 1
        self._fp_cache: Optional[str] = None
        # var name -> its sequence-lengths companion var (ragged data);
        # carried through serialization for parity with the JAX package
        self.lod_link: Dict[str, str] = {}

    def _next_op_id(self):
        self._op_counter += 1
        return self._op_counter

    def _create_block(self, parent_idx=None) -> Block:
        """A new block under the current one (or `parent_idx`), made
        current: the body of a While, a conditional block or an RNN
        step. Op ids stay unique across blocks."""
        parent = self._current_block_idx if parent_idx is None \
            else parent_idx
        blk = Block(self, len(self.blocks), parent_idx=parent)
        self.blocks.append(blk)
        self._current_block_idx = blk.idx
        self._fp_cache = None
        return blk

    def _rollback(self):
        """Make the current block's parent current again."""
        self._current_block_idx = self.current_block().parent_idx

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def all_parameters(self):
        return [v for blk in self.blocks for v in blk.all_parameters()]

    def clone(self, for_test=False) -> "Program":
        p = copy.deepcopy(self)
        p._fp_cache = None
        if for_test:
            for blk in p.blocks:
                # drop backward + optimizer ops. Filter, don't truncate:
                # forward ops appended after minimize() must survive.
                # Backward ops produce @GRAD vars; optimizer ops consume
                # them; schedulers mutate only persistable state in place.
                def _mutates_state_only(op, blk):
                    outs = [n for ns in op.outputs.values()
                            for n in ns if n]
                    if not outs:
                        return False
                    ins = {n for ns in op.inputs.values() for n in ns}
                    for n in outs:
                        v = blk._find_var_recursive(n)
                        if v is None or not v.persistable or n not in ins:
                            return False
                    return True

                def _is_train_op(op, blk=blk):
                    if op.type.startswith("grad::"):
                        return True
                    names = [n for ns in list(op.outputs.values()) +
                             list(op.inputs.values()) for n in ns if n]
                    if any(n.endswith(GRAD_SUFFIX) for n in names):
                        return True
                    return _mutates_state_only(op, blk)
                blk.ops = [op for op in blk.ops if not _is_train_op(op)]
                for op in blk.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
                    if op.type in ("dropout", "batch_norm",
                                   "sync_batch_norm"):
                        op.attrs["is_test"] = True
        return p

    # -- serialization ---------------------------------------------------
    def to_dict(self):
        d = {"version": self._version, "random_seed": self.random_seed,
             "op_versions": op_version_map(self),
             "blocks": [b.to_dict() for b in self.blocks]}
        if self.lod_link:
            d["lod_link"] = dict(self.lod_link)
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d) -> "Program":
        check_op_versions(d.get("op_versions", {}))
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p.blocks = []
        for bd in d["blocks"]:
            blk = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                vd = dict(vd)
                is_param = vd.pop("is_parameter", False)
                name = vd.pop("name")
                if is_param:
                    vd.pop("persistable", None)
                    vd.pop("stop_gradient", None)
                    blk.create_parameter(
                        name, vd.pop("shape"), vd.pop("dtype"),
                        trainable=vd.pop("trainable", True), **vd)
                else:
                    vd.pop("trainable", None)
                    blk.create_var(name=name, **vd)
            for od in bd["ops"]:
                blk.ops.append(Operator(
                    blk, od["type"], od["inputs"], od["outputs"],
                    _attrs_from_json(od["attrs"]), op_id=od.get("id")))
            p.blocks.append(blk)
        p._op_counter = max(
            (op.id for b in p.blocks for op in b.ops), default=0)
        p.lod_link = dict(d.get("lod_link", {}))
        return p

    @staticmethod
    def from_json(s) -> "Program":
        return Program.from_dict(json.loads(s))

    def fingerprint(self) -> str:
        """Stable hash of the serialized program. Cached; any
        append_op/create_var invalidates (direct attr mutation on an
        existing op does not — clone first for such rewrites)."""
        if self._fp_cache is None:
            self._fp_cache = hashlib.sha1(self.to_json().encode()).hexdigest()
        return self._fp_cache

    def __repr__(self):
        n_ops = sum(len(b.ops) for b in self.blocks)
        return f"Program({len(self.blocks)} blocks, {n_ops} ops)"


_main_program = Program()
_startup_program = Program()


def op_version_map(program) -> dict:
    """{op type -> registered semantic version} for every op used."""
    from .core.registry import REGISTRY
    out = {}
    for blk in program.blocks:
        for op in blk.ops:
            if op.type not in out:
                out[op.type] = REGISTRY.get(op.type).version \
                    if REGISTRY.has(op.type) else 1
    return out


def check_op_versions(saved: dict):
    """Refuse a saved program whose ops are unknown here or NEWER than
    this package supports."""
    from .core.registry import REGISTRY
    problems = []
    for t, v in (saved or {}).items():
        if not REGISTRY.has(t):
            problems.append(f"{t!r} (not registered in this build)")
        elif int(v) > REGISTRY.get(t).version:
            problems.append(
                f"{t!r} (saved v{v} > supported "
                f"v{REGISTRY.get(t).version})")
    if problems:
        raise RuntimeError(
            "incompatible saved program: " + "; ".join(problems))


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _main_program, _startup_program
    old_main, old_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = old_main, old_startup


def in_dygraph_mode():
    from . import dygraph
    return dygraph.enabled()


def cpu_places(n=1):
    from .core.place import CPUPlace
    return [CPUPlace() for _ in range(n)]


class ParamAttr:
    """Parameter attribute bundle."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False,
                 gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.gradient_clip = gradient_clip

    @staticmethod
    def _to_attr(arg):
        if arg is None or arg is True:
            return ParamAttr()
        if arg is False:
            return False
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        from .initializer import Initializer
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError(f"bad ParamAttr spec {arg!r}")


class WeightNormParamAttr(ParamAttr):
    """Weight-normalized parameter attribute (w = g * v / ||v||). `dim` is
    recorded; the layers treat it as a plain ParamAttr, as the JAX
    package does (no reparameterisation is built)."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, gradient_clip=None):
        super().__init__(name, initializer, learning_rate, regularizer,
                         trainable, do_model_average, gradient_clip)
        self.dim = dim
