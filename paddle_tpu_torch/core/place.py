"""Places: device selection.

A Place names the device a program runs on and resolves to a
``torch.device``. ``CUDAPlace`` is the card; ``CPUPlace`` is what tests
ask for explicitly. There is no silent fallback between them: a
``CUDAPlace`` on a machine without a CUDA device raises.
"""
from __future__ import annotations

import torch


class Place:
    def __init__(self, device_id=0):
        self.device_id = device_id

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDAPlace: no CUDA device is available; pass "
                "CPUPlace() to run on the CPU")
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError(
                f"CUDAPlace({self.device_id}): only "
                f"{torch.cuda.device_count()} CUDA device(s)")
        return torch.device("cuda", self.device_id)


def default_place() -> Place:
    """The card. Entry points run there unless the caller asks for the
    CPU; resolving the device raises where there is none."""
    return CUDAPlace(0)
