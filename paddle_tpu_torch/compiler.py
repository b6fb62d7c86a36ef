"""CompiledProgram: the execution configuration of a Program.

``fluid.CompiledProgram(main).with_data_parallel(loss_name=...)`` is how
most Fluid training scripts hand a program to ``Executor.run``. The JAX
package jits the step with batch-sharded feeds over a device mesh; the
port runs one rank on one card, where a data-parallel program is the
program itself: ``Executor.run`` unwraps it and runs the same gates, the
same prepared run and the same ops as for the plain program.

Across ranks there is nothing to run yet: ``with_distributed``, and
``with_data_parallel`` over more than one device or more than one
``torch.distributed`` rank, raise NotImplementedError naming ROADMAP.md
§A7 (parallelism). There is no silent one-card run of a multi-rank
request.

The BuildStrategy and ExecutionStrategy knobs are accepted as in the
JAX package; they configure nothing: the graph passes are
FLAGS_graph_opt_level's (analysis/passes).
"""
from __future__ import annotations

from typing import Optional

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]

_MULTI_RANK = ("runs one rank on one card; data parallelism across "
               "devices or ranks waits for the parallel path (ROADMAP.md "
               "§A7)")


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


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() \
        if dist.is_available() and dist.is_initialized() else 1


class CompiledProgram:
    def __init__(self, program_or_graph, build_strategy: Optional[
            BuildStrategy] = None):
        self.program = program_or_graph
        self.build_strategy = build_strategy or BuildStrategy()
        self.exec_strategy = None
        self._is_data_parallel = False
        self._loss_name = None
        self._places = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        """Data parallelism at one rank: the program runs as built on the
        executor's card. More than one place, or more than one
        torch.distributed rank, raises NotImplementedError."""
        if places is not None:
            n = len(places) if isinstance(places, (list, tuple)) else 1
            if n > 1:
                raise NotImplementedError(
                    f"CompiledProgram.with_data_parallel over {n} places: "
                    f"the port {_MULTI_RANK}")
        world = _world_size()
        if world > 1:
            raise NotImplementedError(
                f"CompiledProgram.with_data_parallel under "
                f"torch.distributed with {world} ranks: the port "
                f"{_MULTI_RANK}")
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self.build_strategy = build_strategy
        self.exec_strategy = exec_strategy
        self._places = places
        return self

    def with_distributed(self, mesh=None, state_spec_fn=None,
                         batch_axes=("dp",)):
        """SPMD over a device mesh: not ported."""
        raise NotImplementedError(
            f"CompiledProgram.with_distributed: the port {_MULTI_RANK}")
