"""SpecLayout: program-var -> PartitionSpec table over a Mesh(data, model).

Reference analogue: the distributed transpiler's per-var placement tables
(multi_devices_graph_pass.cc shard assignment + the fleet sharding
strategies). The JAX package hands this table to GSPMD as jit shardings;
the port's sharded executor (executor.py) reads it directly: a feed whose
spec names the data axis is split by rows over the ranks, and an
accumulator whose spec names it on dim 0 is kept as this rank's shard.
This module is host logic, copied from the JAX package with its own
`PartitionSpec` (no jax.sharding).

The ZeRO rule follows "Automatic Cross-Replica Sharding of Weight Update
in Data-Parallel Training" (arxiv 2004.13336): parameters stay replicated
across the data axis (activations/gradients shard on batch), while the
optimizer accumulators — and therefore the weight-update computation that
consumes them — shard their leading dim across the data axis. GSPMD then
emits the reduce-scatter + all-gather decomposition of the gradient
all-reduce automatically; the port's executor issues that reduce-scatter
and all-gather itself. Any dim that does not divide its axis falls back
to replication (SNIPPETS.md [3] naive-sharding rule), so the table always
resolves: every var gets *some* spec.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..monitor import STAT_SET
from ..monitor import enabled as _monitor_on
from .mesh import Mesh, make_mesh

__all__ = ["SpecLayout", "SpecFnLayout", "MeshDims", "PartitionSpec",
           "mesh_from_spec", "DATA_AXIS", "MODEL_AXIS", "FSDP_AXIS"]


class PartitionSpec(tuple):
    """Per-dim mesh axis names (None = not split), as
    jax.sharding.PartitionSpec spells them: PartitionSpec('dp', None)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(repr(p) for p in self) + ")"

    __str__ = __repr__

DATA_AXIS = "dp"
MODEL_AXIS = "tp"
# Weight-sharding (FSDP) axis, SNIPPETS.md [1]: parameters shard their
# leading dim here (ZeRO-3 — weights, not just optimizer state), and
# GSPMD inserts the per-layer all-gather before each use. Third
# positional axis of mesh_from_spec ("dp,tp,fsdp").
FSDP_AXIS = "fsdp"

# Optimizer accumulator name markers. optimizer._add_accumulator names
# accumulators unique_name.generate(f"{param.name}_{acc}") -> e.g.
# "fc_0.w_0_moment1_0"; these substrings identify the param-shaped
# moments/velocities that the ZeRO rule shards over the data axis.
_ZERO_ACC_MARKERS = (
    "_moment1_", "_moment2_", "_moment_", "_velocity_", "_inf_norm_",
    "_avg_squared_grad_", "_avg_squared_update_", "_mean_square_",
    "_momentum_", "_mean_grad_", "_squared_", "_linear_",
)
# Scalar schedule state: always replicated (shape [1] — never divisible,
# but matching by name avoids even attempting the fallback path).
_SCALAR_MARKERS = ("learning_rate", "_beta1_pow_", "_beta2_pow_")


_POSITIONAL_AXES = (DATA_AXIS, MODEL_AXIS, FSDP_AXIS)


def mesh_axes_for(ndims: int):
    """Positional axis names for an n-dim mesh shape: (dp), (dp, tp),
    (dp, tp, fsdp). Shared by mesh_from_spec and MeshDims so the
    device-backed and device-free spellings can never disagree."""
    if not 1 <= ndims <= len(_POSITIONAL_AXES):
        raise ValueError(
            f"mesh rank {ndims}: expected 'dp', 'dp,tp' or "
            f"'dp,tp,fsdp' (1-{len(_POSITIONAL_AXES)} axes)")
    return _POSITIONAL_AXES[:ndims]


def mesh_from_spec(spec: str, devices=None) -> Mesh:
    """Build a Mesh of ranks from a 'dp' / 'dp,tp' / 'dp,tp,fsdp' shape
    string ("8", "4,2", "2,2,2"); `devices` are rank ids (default
    0..size-1).

    Axis names follow position: first axis is the data axis, second the
    model axis — the Mesh(data, model) convention of docs/sharding.md —
    and third the weight-sharding (FSDP) axis from SNIPPETS.md [1].
    """
    dims = tuple(int(d) for d in str(spec).replace("x", ",").split(",")
                 if str(d).strip())
    if not dims or any(d < 1 for d in dims):
        raise ValueError(
            f"mesh spec {spec!r}: expected 'dp'[,'tp'[,'fsdp']] "
            f"positive ints")
    names = mesh_axes_for(len(dims))
    if devices is None:
        devices = np.arange(int(np.prod(dims)))
    return make_mesh(shape=dims, axis_names=names, devices=devices)


class MeshDims:
    """Rank-free stand-in for Mesh: axis names + sizes only. Static
    tooling needs shard counts on hosts that don't HAVE the dp x tp
    ranks; SpecLayout's spec/shard-count queries work over it."""

    def __init__(self, shape, axis_names=None):
        shape = tuple(int(d) for d in shape)
        if axis_names is None:
            axis_names = mesh_axes_for(len(shape)) if shape else ()
        if len(axis_names) != len(shape):
            raise ValueError(f"axis_names {axis_names} vs shape {shape}")
        if any(d < 1 for d in shape):
            raise ValueError(f"mesh shape {shape}: axes must be >= 1")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.size = int(np.prod(shape)) if shape else 1


class SpecLayout:
    """Var-name -> PartitionSpec table for one program under one mesh.

    Resolution is total: `spec_for` returns a PartitionSpec for ANY
    (name, shape) — the fallback is replication (PartitionSpec()), never
    an error. Built once per (program, mesh); the instance is then both
    the `state_spec_fn` for CompiledProgram.with_distributed (callable
    on a var name) and the shard-count oracle for the memory planner.
    """

    def __init__(self, mesh: Mesh, data_axis: str = DATA_AXIS,
                 model_axis: str = MODEL_AXIS, shard_params: bool = True,
                 fsdp_axis: str = FSDP_AXIS):
        self.mesh = mesh
        self.data_axis = data_axis if data_axis in mesh.axis_names else None
        self.model_axis = model_axis if model_axis in mesh.axis_names \
            else None
        # fsdp resolution hook (SNIPPETS.md [1], ROADMAP item 1): when
        # the mesh carries this axis, parameters shard their leading
        # dim over it — full weight sharding, not just optimizer state.
        self.fsdp_axis = fsdp_axis if fsdp_axis in mesh.axis_names \
            else None
        self.dp = int(mesh.shape[self.data_axis]) if self.data_axis else 1
        self.tp = int(mesh.shape[self.model_axis]) if self.model_axis \
            else 1
        self.fsdp = int(mesh.shape[self.fsdp_axis]) if self.fsdp_axis \
            else 1
        self.shard_params = shard_params
        self._table: Dict[str, PartitionSpec] = {}
        # Non-divisibility fallbacks: every time a rule WANTED to shard
        # (name, dim) over axis but the dim did not divide, the decline
        # is recorded here — analysis/sharding.py turns these into
        # PTV062 "silently replicated" findings instead of losing them.
        self.fallbacks: list = []
        self._fallback_seen: set = set()

    def _note_fallback(self, name: str, dim: int, axis: str,
                       dim_size, axis_size: int):
        key = (name, dim, axis)
        if key in self._fallback_seen:
            return
        self._fallback_seen.add(key)
        self.fallbacks.append(
            {"name": str(name), "dim": int(dim), "axis": str(axis),
             "dim_size": int(dim_size), "axis_size": int(axis_size)})

    # -- classification --------------------------------------------------
    @staticmethod
    def _is_scalar_state(name: str) -> bool:
        return any(m in name or name.endswith(m.rstrip("_"))
                   for m in _SCALAR_MARKERS)

    @staticmethod
    def _is_zero_accumulator(name: str) -> bool:
        return any(m in name or name.endswith(m.rstrip("_"))
                   for m in _ZERO_ACC_MARKERS)

    # -- spec rules ------------------------------------------------------
    def _model_parts(self, name, shape) -> list:
        """Per-dim axis assignment for the model (tp) axis: last dim of
        a >=2-D tensor, when divisible. [] when tp doesn't apply."""
        parts = [None] * len(shape)
        if (self.shard_params and self.tp > 1 and len(shape) >= 2
                and shape[-1] is not None and shape[-1] > 0):
            if shape[-1] % self.tp == 0:
                parts[-1] = self.model_axis
            else:
                self._note_fallback(name, len(shape) - 1,
                                    self.model_axis, shape[-1], self.tp)
        return parts

    def _fsdp_dim0(self, name, shape, parts) -> list:
        """The fsdp resolution hook: leading dim over the fsdp axis
        when divisible and not already assigned. Applies to any >=1-D
        parameter — embeddings, qkv/ffn weights, 1-D layer_norm scales
        alike (SNIPPETS.md [1] per-family specs all lead with fsdp)."""
        if (self.shard_params and self.fsdp_axis and self.fsdp > 1
                and shape and shape[0] is not None and shape[0] > 0
                and parts[0] is None):
            if shape[0] % self.fsdp == 0:
                parts[0] = self.fsdp_axis
            else:
                self._note_fallback(name, 0, self.fsdp_axis, shape[0],
                                    self.fsdp)
        return parts

    def param_spec(self, name: str, shape: Tuple[int, ...]) -> \
            PartitionSpec:
        """Parameters: replicated over data (ZeRO keeps weights whole
        for the forward pass), last dim over the model axis when it
        divides — the Megatron-style column split GSPMD propagates
        through matmuls — and, when the mesh has an fsdp axis, leading
        dim over fsdp (full weight sharding; GSPMD all-gathers before
        each use)."""
        shape = tuple(s for s in (shape or ()))
        parts = self._fsdp_dim0(name, shape,
                                self._model_parts(name, shape))
        return PartitionSpec(*parts) if any(parts) else PartitionSpec()

    def zero_spec(self, name: str, shape: Tuple[int, ...]) -> \
            PartitionSpec:
        """Optimizer accumulators (arxiv 2004.13336): leading dim over
        the data axis when divisible (plus the same model split as the
        owning param), else fall back toward replication per-dim. With
        an fsdp axis the accumulators co-shard with the weights (fsdp
        on dim 0) instead — the update math stays local either way."""
        shape = tuple(s for s in (shape or ()))
        if not shape:
            return PartitionSpec()
        parts = self._model_parts(name, shape)
        if self.fsdp_axis and self.fsdp > 1:
            parts = self._fsdp_dim0(name, shape, parts)
        elif (self.data_axis and self.dp > 1 and shape[0] is not None
                and shape[0] > 0 and parts[0] is None):
            if shape[0] % self.dp == 0:
                parts[0] = self.data_axis
            else:
                self._note_fallback(name, 0, self.data_axis, shape[0],
                                    self.dp)
        return PartitionSpec(*parts) if any(parts) else PartitionSpec()

    def feed_spec(self, name: str, shape: Tuple[int, ...]) -> \
            PartitionSpec:
        """Feeds shard dim 0 (batch) across the data axis when it
        divides; otherwise replicate (small/odd batches still run)."""
        shape = tuple(s for s in (shape or ()))
        if (self.data_axis and self.dp > 1 and shape
                and shape[0] is not None and shape[0] > 0):
            if shape[0] % self.dp == 0:
                return PartitionSpec(self.data_axis)
            self._note_fallback(name, 0, self.data_axis, shape[0],
                                self.dp)
        return PartitionSpec()

    def spec_for(self, name: str, shape=None,
                 is_param: bool = False) -> PartitionSpec:
        """Total resolution: scalar state -> replicate; optimizer
        accumulator -> ZeRO rule; params -> param rule; everything else
        (activations live inside the jitted step — GSPMD propagates
        them from feeds/params) -> replicate."""
        shape = tuple(shape or ())
        if self._is_scalar_state(name) or not shape or \
                int(np.prod([s or 1 for s in shape])) <= 1:
            return PartitionSpec()
        if self._is_zero_accumulator(name):
            return self.zero_spec(name, shape)
        if is_param or len(shape) >= 2:
            return self.param_spec(name, shape)
        return PartitionSpec()

    # -- table build -----------------------------------------------------
    def add_program(self, program) -> "SpecLayout":
        """Resolve every persistable var in `program` into the table
        (activations are left to GSPMD propagation inside the jit)."""
        sharded = replicated = 0
        for v in program.list_vars():
            if not getattr(v, "persistable", False):
                continue
            spec = self.spec_for(
                v.name, getattr(v, "shape", None) or (),
                is_param=getattr(v, "is_parameter", False))
            self._table[v.name] = spec
            if any(a is not None for a in spec):
                sharded += 1
            else:
                replicated += 1
        if _monitor_on():
            STAT_SET("parallel.sharded_vars", sharded)
            STAT_SET("parallel.replicated_vars", replicated)
            STAT_SET("parallel.mesh_devices", int(self.mesh.size))
        return self

    # -- consumers -------------------------------------------------------
    def __call__(self, name: str) -> Optional[PartitionSpec]:
        """state_spec_fn signature for CompiledProgram.with_distributed:
        None means 'replicated' there, so unknown names resolve safely."""
        spec = self._table.get(name)
        if spec is not None and any(a is not None for a in spec):
            return spec
        return None

    def shard_count(self, name: str, shape=None) -> int:
        """How many ways the var's bytes split across the mesh — the
        divisor the memory planner applies to a persistable's bytes for
        the per-rank peak (analysis/memory.py)."""
        spec = self._table.get(name)
        if spec is None:
            spec = self.spec_for(name, shape)
        n = 1
        for axes in spec:
            if axes is None:
                continue
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                n *= int(self.mesh.shape[a])
        return n

    def gradient_sync_bytes(self, program) -> int:
        """Closed-form per-step gradient-synchronisation volume: every
        dp-replicated parameter's gradient is all-reduced (2(n-1)/n ~ 2x
        payload in a ring), counted once per step. Sharded-update params
        reduce-scatter + all-gather the same payload, so the estimate
        holds for both layouts (arxiv 2004.13336 §3). Kept as the
        reconciliation reference the per-op cost model must agree with,
        and what the sharded executor's gradient traffic is held
        against."""
        sync_over = self.dp * (self.fsdp
                               if self.fsdp_axis and self.fsdp > 1
                               else 1)
        if sync_over <= 1:
            return 0
        total = 0
        for v in program.list_vars():
            if not getattr(v, "is_parameter", False):
                continue
            shape = tuple(s for s in (getattr(v, "shape", ()) or ())
                          if s and s > 0)
            if not shape:
                continue
            try:
                from ..core.dtypes import as_np_dtype
                itemsize = np.dtype(as_np_dtype(v.dtype)).itemsize
            except Exception:
                itemsize = 4
            nbytes = int(np.prod(shape)) * itemsize
            total += nbytes // self.shard_count(v.name, shape)
        return 2 * total

    def collective_bytes_estimate(self, program) -> int:
        """Static per-step collective-traffic volume — ONE oracle: the
        per-op communication-cost model of analysis/sharding.py (layout
        propagation + priced collectives: gradient all-reduce /
        reduce-scatter+all-gather, explicit c_* ops, implicit
        reshards)."""
        from ..analysis.sharding import analyze_program_sharding
        return int(analyze_program_sharding(
            program, layout=self).collective_bytes_per_step)

    def to_dict(self) -> Dict[str, str]:
        return {n: str(s) for n, s in sorted(self._table.items())}

    def __len__(self) -> int:
        return len(self._table)


class SpecFnLayout:
    """A plain state_spec_fn (var name -> PartitionSpec or None) seen
    through SpecLayout's questions, as the model-parallel rewrite asks
    them: the spec of a parameter, and the mesh's model and fsdp axes."""

    def __init__(self, mesh, fn):
        self.mesh = mesh
        self.fn = fn
        self.model_axis = MODEL_AXIS if MODEL_AXIS in mesh.axis_names \
            else None
        self.fsdp_axis = FSDP_AXIS if FSDP_AXIS in mesh.axis_names \
            else None
        self.data_axis = DATA_AXIS if DATA_AXIS in mesh.axis_names \
            else None
        self.fallbacks: list = []

    def param_spec(self, name, shape=()):
        spec = self.fn(name)
        return PartitionSpec(*spec) if spec is not None \
            else PartitionSpec()

    def __call__(self, name):
        return self.fn(name)
