"""Dygraph data parallelism (reference dygraph/parallel.py DataParallel
and imperative/nccl_context.cc).

``nranks`` is torch.distributed's world size, or 1 when no process group
is initialized. At one rank DataParallel is the wrapped layer. Above one,
each rank runs the layer on its own rows, and after ``loss.backward()``
``apply_collective_grads`` all-reduces the parameters' gradients in one
flattened buffer per dtype and divides by the ranks: every rank then
holds the gradient of the mean loss over the global batch. The reference
summed instead and expected the loss divided by ``scale_loss``; here the
average does that division, so a loss passed through ``scale_loss`` as
well ends up divided twice.
"""
from __future__ import annotations

from ..parallel.mesh import world as _world
from .layers import Layer

__all__ = ["DataParallel", "prepare_context", "Env", "ParallelEnv"]


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
        """Average every parameter's gradient over the ranks (one
        all-reduce a dtype); at one rank, nothing to do."""
        n = _world()[0]
        if n == 1:
            return
        from ..ops import collective
        grads = [p.grad for p in self.parameters() if p.grad is not None]
        # group None: the default group, every rank
        for g, avg in zip(grads, collective.coalesced(
                grads, lambda f: collective.all_reduce(f, None, "sum")
                .div_(n))):
            g.copy_(avg.view_as(g))

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_dict(self, *a, **kw):
        return self._layers.set_dict(*a, **kw)

    load_dict = set_dict
