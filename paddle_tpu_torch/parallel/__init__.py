"""Parallelism: the mesh of ranks, the SpecLayout table and
ParallelExecutor.

Reference scope: ParallelExecutor data parallelism and the collective
transpiler. The port runs one process per rank over torch.distributed:
the executor splits the batch, all-reduces (or, with ZeRO,
reduce-scatters and all-gathers) the gradients itself, and runs this
rank's program of the model-parallel rewrite (tensor, sequence, expert
and weight sharding, model_parallel.py). Ring and Ulysses attention, the
MoE FFN, activation recompute and the GPipe pipeline over a `pp` axis
(pipeline.py) live here too.
"""
from .api import ParallelExecutor  # noqa: F401
from .mesh import get_mesh, set_mesh, mesh_context  # noqa: F401
from .layout import SpecLayout, mesh_from_spec  # noqa: F401
from . import ring_attention, ulysses, moe, recompute  # noqa: F401,E402
from .pipeline import gpipe, stack_stage_params, SectionPipeline  # noqa: F401,E402
