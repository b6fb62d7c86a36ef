"""Shared transpiler helpers."""
from __future__ import annotations

from ..core.registry import REGISTRY

__all__ = ["optimize_ops"]


def optimize_ops(block):
    """The block's parameter-update ops: inplace-registered ops carrying
    Param + Grad slots (the reference detects these via op role attrs,
    distribute_transpiler.py _is_opt_role_op)."""
    return [op for op in block.ops
            if REGISTRY.has(op.type) and REGISTRY.get(op.type).inplace
            and "Param" in op.inputs and "Grad" in op.inputs]
