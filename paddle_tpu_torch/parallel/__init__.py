"""Parallelism: the mesh of ranks, the SpecLayout table and
ParallelExecutor.

Reference scope: ParallelExecutor data parallelism and the collective
transpiler. The port runs one process per rank over torch.distributed:
the executor splits the batch, all-reduces (or, with ZeRO,
reduce-scatters and all-gathers) the gradients itself. ring_attention,
recompute, the pipeline, MoE and Ulysses wait for ROADMAP §A7b.
"""
from .api import ParallelExecutor  # noqa: F401
from .mesh import get_mesh, set_mesh, mesh_context  # noqa: F401
from .layout import SpecLayout, mesh_from_spec  # noqa: F401
