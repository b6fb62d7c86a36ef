"""Scope: name -> tensor store for persistable state.

A Scope maps variable names to ``torch.Tensor``s on the executor's
device. The executor writes updated state back by name after each run.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, object] = {}
        self.parent = parent

    def find_var(self, name):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has(self, name):
        return self.find_var(name) is not None

    def set(self, name, value):
        self._vars[name] = value

    def get(self, name):
        v = self.find_var(name)
        if v is None:
            raise KeyError(f"var {name!r} not initialised in scope")
        return v

    def get_numpy(self, name) -> np.ndarray:
        v = self.get(name)
        if isinstance(v, torch.Tensor):
            return tensor_to_numpy(v)
        return np.asarray(v)

    def names(self):
        return list(self._vars)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor, never aliasing it (training updates state
    in place). numpy has no bfloat16, so bfloat16 comes back widened to
    float32 (exactly representable)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    if t.device.type == "cpu":
        return t.numpy().copy()
    return t.cpu().numpy()


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope() -> Scope:
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope: Scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()
