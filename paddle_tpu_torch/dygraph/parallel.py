"""Dygraph data parallelism (reference dygraph/parallel.py DataParallel).

``nranks`` is torch.distributed's world size, or 1 when no process group
is initialized. At one rank DataParallel is the wrapped layer: the loss
is not scaled and there are no gradients to reduce. Above one, the
all-reduce of the gradients is not ported yet (ROADMAP §A10, the
parallelism slice): apply_collective_grads raises.
"""
from __future__ import annotations

import torch.distributed as dist

from .layers import Layer

__all__ = ["DataParallel", "prepare_context", "Env", "ParallelEnv"]


def _world():
    """(world size, rank) of the default process group; (1, 0) when
    there is none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Env:
    def __init__(self):
        self.nranks, self.local_rank = _world()
        self.dev_id = 0
        self.trainer_endpoints = []
        self.current_endpoint = ""


ParallelEnv = Env


def prepare_context(strategy=None):
    return Env()


class DataParallel(Layer):
    def __init__(self, layers, strategy=None):
        super().__init__()
        self._layers = layers
        self.add_sublayer("_layers", layers)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def scale_loss(self, loss):
        n = _world()[0]
        return loss * (1.0 / n) if n > 1 else loss

    def apply_collective_grads(self):
        if _world()[0] > 1:
            raise NotImplementedError(
                "DataParallel.apply_collective_grads over more than one "
                "rank is not ported yet (ROADMAP §A10: parallelism)")

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_dict(self, *a, **kw):
        return self._layers.set_dict(*a, **kw)

    load_dict = set_dict
