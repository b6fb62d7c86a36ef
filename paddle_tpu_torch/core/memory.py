"""Memory accounting: the card's allocator and a Scope's bytes.

The JAX package surfaces its backend's allocator stats under the same
keys; here they come from torch's CUDA caching allocator
(``torch.cuda.memory_stats``) and ``torch.cuda.mem_get_info``.
``bytes_limit`` is the card's total memory: the static memory gate
(analysis/memory.py) takes it as its default budget. The CPU reports
nothing, so the gate cannot fire there, as in the JAX package.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

__all__ = ["device_memory_stats", "device_bytes_limit",
           "scope_memory_stats", "assert_hbm_within",
           "record_device_memory"]


def _cuda_device(device):
    if device is None:
        return torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def device_memory_stats(device=None) -> Dict[str, int]:
    """Allocator stats of one card: bytes_in_use, peak_bytes_in_use,
    bytes_limit (the card's total memory) and bytes_free (what the
    driver reports free). {} for the CPU, or without a card."""
    dev = _cuda_device(device)
    if dev is None:
        return {}
    stats = torch.cuda.memory_stats(dev)
    free, total = torch.cuda.mem_get_info(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "bytes_limit": int(total), "bytes_free": int(free)}


@functools.lru_cache(maxsize=None)
def _total_memory(index: int) -> int:
    return int(torch.cuda.get_device_properties(index).total_memory)


def device_bytes_limit(device=None) -> int:
    """The card's total memory (device_memory_stats' bytes_limit), read
    once a card: the memory gate asks for it on every run. 0 for the CPU
    or without a card."""
    dev = _cuda_device(device)
    if dev is None:
        return 0
    return _total_memory(dev.index if dev.index is not None
                         else torch.cuda.current_device())


def scope_memory_stats(scope=None) -> Dict[str, int]:
    """Bytes held by a Scope, split host (CPU tensors and arrays) vs
    device (tensors on the card)."""
    from .scope import global_scope
    scope = scope or global_scope()
    host = dev = count = 0
    for name in scope.names():
        v = scope.find_var(name)  # None for declared-but-unset vars
        if v is None:
            continue
        count += 1
        if isinstance(v, torch.Tensor):
            nbytes = v.numel() * v.element_size()
            if v.device.type == "cpu":
                host += nbytes
            else:
                dev += nbytes
        else:
            host += int(getattr(v, "nbytes", 0) or 0)
    return {"vars": count, "host_bytes": host, "device_bytes": dev,
            "total_bytes": host + dev}


def record_device_memory(device=None) -> Dict[str, int]:
    """Sample the card's allocator stats into the monitor as gauges
    (memory.device_bytes_in_use / peak / limit). The executor calls this
    once per step when FLAGS_enable_monitor is set. No-op when the
    monitor is disabled or the device reports no stats (CPU)."""
    from ..monitor import STAT_SET, enabled
    if not enabled():
        return {}
    s = device_memory_stats(device)
    for key, stat in (("bytes_in_use", "memory.device_bytes_in_use"),
                      ("peak_bytes_in_use", "memory.device_peak_bytes"),
                      ("bytes_limit", "memory.device_bytes_limit")):
        if key in s:
            STAT_SET(stat, s[key])
    return s


def assert_hbm_within(fraction: float, device=None) -> Optional[float]:
    """Guard: raise if bytes_in_use exceeds `fraction` of the card's
    memory (FLAGS_fraction_of_gpu_memory_to_use read as a check, not a
    reservation). Returns the current fraction, or None when the device
    reports no stats."""
    s = device_memory_stats(device)
    used = s.get("bytes_in_use")
    limit = s.get("bytes_limit")
    if not used or not limit:
        return None
    frac = used / limit
    if frac > fraction:
        raise MemoryError(
            f"HBM usage {used / 2**30:.2f} GiB is "
            f"{frac:.1%} of the {limit / 2**30:.2f} GiB limit "
            f"(> allowed {fraction:.1%})")
    return frac
