"""Runtime flag registry + environment bootstrap.

The subset of the JAX package's flags that this package reads, with the
same names, defaults and ``FLAGS_<name>=<value>`` environment bootstrap
(read once at import; bools accept 0/1/true/false). The
``flash_attention_block_{q,k}`` flags are not here: they are TPU tile
hints, and the Hopper kernel picks its own tile.

    from paddle_tpu_torch.core.flags import FLAGS
    if FLAGS.check_nan_inf: ...
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

__all__ = ["FLAGS", "get_flags", "set_flags", "reload_from_env"]


class _Flag:
    __slots__ = ("name", "default", "value", "ftype", "help")

    def __init__(self, name, default, ftype, help_):
        self.name = name
        self.default = default
        self.value = default
        self.ftype = ftype
        self.help = help_


_REGISTRY: Dict[str, _Flag] = {}
_LOCK = threading.Lock()


def _define(name, default, ftype, help_):
    with _LOCK:
        if name in _REGISTRY:
            raise ValueError(f"flag {name!r} already defined")
        _REGISTRY[name] = _Flag(name, ftype(default), ftype, help_)
    _load_one_from_env(name)


def _parse(ftype, raw: str):
    if ftype is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return ftype(raw)


def _load_one_from_env(name):
    raw = os.environ.get(f"FLAGS_{name}")
    if raw is None:
        return
    f = _REGISTRY[name]
    try:
        f.value = _parse(f.ftype, raw)
    except (ValueError, TypeError):
        import warnings
        warnings.warn(
            f"ignoring malformed environment variable FLAGS_{name}="
            f"{raw!r} (expected {f.ftype.__name__}); keeping {f.value!r}")


def reload_from_env():
    """Re-read every FLAGS_* environment variable."""
    for name in _REGISTRY:
        _load_one_from_env(name)


class _FlagsNamespace:
    """Attribute access: FLAGS.check_nan_inf. Unknown names raise."""

    def __getattr__(self, name):
        try:
            return _REGISTRY[name].value
        except KeyError:
            raise AttributeError(f"unknown flag {name!r}") from None

    def __setattr__(self, name, value):
        f = _REGISTRY.get(name)
        if f is None:
            raise AttributeError(f"unknown flag {name!r}")
        f.value = _parse(f.ftype, value) if isinstance(value, str) \
            else f.ftype(value)

    def __dir__(self):
        return sorted(_REGISTRY)


FLAGS = _FlagsNamespace()


def get_flags(names) -> Dict[str, Any]:
    """get_flags(["FLAGS_x", ...]) -> {name: value}."""
    if isinstance(names, str):
        names = [names]
    out = {}
    for n in names:
        key = n[6:] if n.startswith("FLAGS_") else n
        if key not in _REGISTRY:
            raise ValueError(f"unknown flag {n!r}")
        out[n] = _REGISTRY[key].value
    return out


def set_flags(kv: Dict[str, Any]):
    """set_flags({"FLAGS_x": v, ...})."""
    for n, v in kv.items():
        key = n[6:] if n.startswith("FLAGS_") else n
        if key not in _REGISTRY:
            raise ValueError(f"unknown flag {n!r}")
        setattr(FLAGS, key, v)


_define("check_nan_inf", False, bool,
        "Debug mode: after every op, verify each floating-point output "
        "is finite; raises naming the op, its block/op index and the "
        "output var. Synchronises with the device on every op.")
_define("executor_cache_capacity", 64, int,
        "Max prepared (program, feed shapes, fetches) entries kept per "
        "Executor, LRU evicted.")
_define("serving_max_batch_size", 8, int,
        "Default EngineConfig.max_batch_size: the most request rows the "
        "serving engine coalesces into one padded batch.")
_define("serving_max_wait_us", 2000, int,
        "Default EngineConfig.max_wait_us: how long a partially-filled "
        "batch may wait for co-batchable requests before it is flushed.")
_define("serving_queue_capacity", 256, int,
        "Default EngineConfig.queue_capacity: max request rows pending "
        "before submissions are rejected with QueueFullError.")
_define("serving_default_timeout_ms", 1000.0, float,
        "Default EngineConfig.default_timeout_ms: per-request deadline; "
        "0 = no deadline.")
