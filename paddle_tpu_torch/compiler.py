"""CompiledProgram: the execution configuration of a Program.

``fluid.CompiledProgram(main).with_data_parallel(loss_name=...)`` is how
most Fluid training scripts hand a program to ``Executor.run``. The JAX
package jits the step with batch-sharded feeds over a device mesh and
lets GSPMD insert the collectives. The port runs one process per rank, as
the reference's ParallelExecutor did: at one rank a data-parallel program
is the program itself, and over N torch.distributed ranks the executor
splits the batch, broadcasts the parameters on the first run and
all-reduces the gradients (parallel/data_parallel.py). The caller feeds
the global batch on every rank, as in the JAX package.

``with_distributed(mesh, state_spec_fn, batch_axes)`` takes a Mesh of
ranks (parallel/mesh.py) and a SpecLayout (or any function of a var name
to a PartitionSpec) as state_spec_fn: the accumulators its zero_spec
splits are ZeRO-sharded over the data axis, and a mesh with a model
(tp, sp, ep) or fsdp axis above one rank runs this rank's program of the
model-parallel rewrite (parallel/model_parallel.py). A pipeline (pp)
axis is replicated, as GSPMD replicates an axis that neither the batch
axes nor a state spec names: the ranks along it run the program as
replicas of their batch coordinate, and the gradients are synced over
the batch axis only (parallel/pipeline.py holds the GPipe schedule).

The BuildStrategy and ExecutionStrategy knobs are accepted as in the
JAX package; they configure nothing: the graph passes are
FLAGS_graph_opt_level's (analysis/passes), and the gradients are always
averaged over the ranks (GradientScaleStrategy.CoeffNumDevice).
"""
from __future__ import annotations

from typing import Optional

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]


class BuildStrategy:
    """Knob-compatible with fluid.BuildStrategy (build_strategy.h)."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_all_optimizer_ops = True
        self.sync_batch_norm = False
        self.enable_inplace = True
        self.memory_optimize = True
        self.nccl_comm_num = 1
        self.use_hierarchical_allreduce = False
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """fluid.ExecutionStrategy (pybind.cc:1655) — scheduling knobs, kept
    for compatibility."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1
        self.use_experimental_executor = False


class CompiledProgram:
    def __init__(self, program_or_graph, build_strategy: Optional[
            BuildStrategy] = None):
        self.program = program_or_graph
        self.build_strategy = build_strategy or BuildStrategy()
        self.exec_strategy = None
        self._is_data_parallel = False
        self._loss_name = None
        self._places = None
        self._mesh = None
        self._state_spec_fn = None
        self._batch_axes = ("dp",)

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        """Data parallelism over the torch.distributed ranks (one card
        each), or the program itself at one rank. `places` is accepted
        for compatibility: a process drives its own card."""
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self.build_strategy = build_strategy
        self.exec_strategy = exec_strategy
        self._places = places
        return self

    def with_distributed(self, mesh, state_spec_fn=None,
                         batch_axes=("dp",)):
        """Data parallelism over a Mesh of ranks with per-var specs:
        state_spec_fn(var_name) -> PartitionSpec or None (replicated); a
        SpecLayout ZeRO-shards the accumulators it splits over the data
        axis. Feeds split dim 0 over batch_axes; a name not in the mesh
        raises ValueError at the first run."""
        self._is_data_parallel = True
        self._mesh = mesh
        self._state_spec_fn = state_spec_fn
        self._batch_axes = tuple(batch_axes)
        return self

    # -- executor hooks ----------------------------------------------------
    def mesh(self):
        if self._mesh is None:
            from .parallel.mesh import get_mesh
            self._mesh = get_mesh()
        return self._mesh

    def batch_split(self):
        """(ranks on the batch axes, this rank's index among them)."""
        mesh = self.mesh()
        unknown = [a for a in self._batch_axes if a not in mesh.axis_names]
        if unknown:
            raise ValueError(
                f"batch_axes {unknown} not in mesh axes {mesh.axis_names}")
        n, idx = 1, 0
        for a in self._batch_axes:
            idx = idx * mesh.shape[a] + mesh.axis_index(a)
            n *= mesh.shape[a]
        return n, idx

    def feed_rows(self, shape):
        """This rank's rows [start, stop) of a feed of `shape`: dim 0
        split over the batch axes when it divides their ranks, else None
        (the feed is replicated) — the JAX package's feed rule."""
        if not self._is_data_parallel:
            return None
        n, idx = self.batch_split()
        shape = tuple(shape or ())
        if n > 1 and shape and shape[0] % n == 0:
            rows = shape[0] // n
            return idx * rows, (idx + 1) * rows
        return None

    def layout(self):
        """The SpecLayout in scope (state_spec_fn), or None."""
        from .parallel.layout import SpecLayout
        fn = self._state_spec_fn
        return fn if isinstance(fn, SpecLayout) else None

    def spec_layout(self):
        """What the model-parallel rewrite reads the parameters' specs
        from: the SpecLayout, a plain state_spec_fn wrapped as one
        (parallel/layout.SpecFnLayout), or None (every state whole)."""
        fn = self._state_spec_fn
        if fn is None:
            return None
        layout = self.layout()
        if layout is not None:
            return layout
        from .parallel.layout import SpecFnLayout
        return SpecFnLayout(self.mesh(), fn)
