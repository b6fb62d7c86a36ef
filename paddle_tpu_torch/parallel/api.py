"""ParallelExecutor: source-compatible facade over the parallel paths.

Reference: fluid.ParallelExecutor (parallel_executor.cc:393) — local scopes
per device, NCCL bcast of params, SSA-graph executor selection. In the port
each process is one rank, and that collapses to
CompiledProgram.with_data_parallel + Executor.run (which broadcasts the
parameters on the first run and all-reduces the gradients); with a `mesh`
whose tp or fsdp axis holds more than one rank, the executor runs this
rank's program of the model-parallel rewrite (model_parallel.py). This
class keeps the constructor/run signature for ported scripts.
"""
from __future__ import annotations

from ..compiler import BuildStrategy, CompiledProgram, ExecutionStrategy
from ..executor import Executor
from ..framework import default_main_program

__all__ = ["ParallelExecutor"]


class ParallelExecutor:
    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None, mesh=None, layout=None):
        program = main_program or default_main_program()
        self._compiled = CompiledProgram(
            program, build_strategy or BuildStrategy()).with_data_parallel(
                loss_name=loss_name,
                exec_strategy=exec_strategy or ExecutionStrategy())
        # Explicit sharded path (the FLAGS_sharded_exec executor gate
        # attaches the same thing automatically for plain instances):
        # a mesh plus an optional SpecLayout for ZeRO sharding.
        if mesh is not None:
            if layout is None:
                from .layout import SpecLayout
                layout = SpecLayout(mesh).add_program(program)
            axes = (layout.data_axis,) if getattr(
                layout, "data_axis", None) else ("dp",)
            self._compiled.with_distributed(mesh, state_spec_fn=layout,
                                            batch_axes=axes)
        from ..core.place import CPUPlace, CUDAPlace
        # the reference's switch: the rank's card, or the host
        self._executor = Executor(CUDAPlace(0) if use_cuda else CPUPlace())
        self._scope = scope

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._executor.run(self._compiled, feed=feed,
                                  fetch_list=fetch_list, scope=self._scope,
                                  return_numpy=return_numpy)
