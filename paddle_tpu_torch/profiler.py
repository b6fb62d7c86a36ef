"""Profiler: phase annotations + device timeline, on torch.profiler.

The JAX package's `profiler.py` (jax.profiler traces, XPlane) carried to
torch.profiler, with the same entry points: `start_profiler` /
`stop_profiler` / `profiler` record the host and, on a card, the CUDA
kernels; `record_event` annotates a framework phase in the trace and in
the monitor's host-phase aggregates; `stop_profiler` writes the trace as
chrome://tracing JSON under FLAGS_profiler_trace_dir.

`summarize_profile` is the counterpart of the reference's
`summarize_xplane`: device time by kernel name and by class, the class
of a kernel being that of the op that launched it (flash attention by
its own kernel symbols; conv, norm and matmul by the aten op above the
launch; other; unlinked for launches the profiler links to no op). With
FLAGS_op_trace_scopes the executor runs each Program op under a
'{op.type}:{block}/{op_idx}' scope while a profiler records, and the
summary attributes every kernel to its framework op (`by_framework_op`).
On the CPU, with no device events, the same tables hold the aten ops'
host time.

The reference's `parse_hlo_op_map` has no counterpart: there is no HLO;
the scopes reach the profiler directly. The native C-ABI profiler scope
of the reference is not ported.
"""
from __future__ import annotations

import bisect
import contextlib
import os
import re
from collections import defaultdict

__all__ = ["profiler", "start_profiler", "stop_profiler", "reset_profiler",
           "record_event", "cuda_profiler", "export_chrome_tracing",
           "host_phase_stats", "extract_op_scope", "summarize_profile",
           "last_trace_path", "device_kernels", "op_class",
           "KERNEL_CLASSES", "OP_CLASSES"]

_trace_dir = None
_prof = None          # the recording (or last stopped) torch profiler
_trace_path = None    # the chrome trace the last stop_profiler wrote


def _default_trace_dir():
    from .core.flags import FLAGS
    return FLAGS.profiler_trace_dir or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "paddle_tpu_torch_profile")


def start_profiler(state="All", tracer_option=None, output_dir=None):
    """Start recording the host (and the CUDA kernels when a card is
    present). `state` and `tracer_option` are accepted for source
    compatibility and not read."""
    global _trace_dir, _prof
    import torch
    from torch.profiler import ProfilerActivity, profile

    _trace_dir = output_dir or _default_trace_dir()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    _prof = profile(activities=acts)
    _prof.start()


def stop_profiler(sorted_key=None, profile_path=None):
    """Stop recording and write the trace as chrome://tracing JSON into
    the trace dir; returns its path (None when no profiler ran)."""
    global _trace_path
    if _prof is None:
        return None
    _prof.stop()
    os.makedirs(_trace_dir, exist_ok=True)
    _trace_path = os.path.join(_trace_dir, f"trace_{os.getpid()}.json")
    _prof.export_chrome_trace(_trace_path)
    return _trace_path


def last_trace_path():
    """The chrome trace the last stop_profiler wrote, or None."""
    return _trace_path


def reset_profiler():
    """Reset host-phase aggregates: the monitor's record_event
    accumulators and event ring."""
    from .monitor import reset_phases
    reset_phases()


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None,
             tracer_option=None):
    start_profiler(state, tracer_option, profile_path)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def record_event(name):
    """RecordEvent: a torch.profiler scope (in the trace beside the
    kernels it launches) and a monitor phase aggregate (monitor.phase:
    nested scopes accumulate EXCLUSIVE time per phase), so
    host_phase_stats() answers "where does host step time go" without a
    trace viewer."""
    import torch

    from .monitor import phase as _monitor_phase
    with torch.profiler.record_function(name), _monitor_phase(name):
        yield


def host_phase_stats():
    """Aggregated record_event phases: {name: {count, total_s,
    exclusive_s}} since the last reset_profiler()."""
    from .monitor import get_phase_stats
    return get_phase_stats()


def export_chrome_tracing(path: str) -> bool:
    """Dump the monitor's recorded host-phase events (the record_event
    scopes) as chrome://tracing JSON. The kernels' timeline is the trace
    stop_profiler writes."""
    from .monitor import export_chrome_tracing as _monitor_export
    return _monitor_export(path) >= 0


@contextlib.contextmanager
def cuda_profiler(*a, **kw):  # name kept for source compat
    with profiler():
        yield


# The FLAGS_op_trace_scopes annotation emitted by core/lowering.run_op:
# '{op.type}:{block}/{op_idx}', where op.type may itself contain '::'
# (grad::generic), behind its fusion group's label ('ewfuse0/') for an
# op of a level-2 fusion group. The LAST match in a path is the
# innermost (most specific) op.
_SCOPE_RE = re.compile(
    r"(?:ewfuse\d+/)?((?:[A-Za-z0-9_.]|::)+):(\d+)/(\d+)")


def extract_op_scope(op_name: str):
    """The innermost '{type}:{block}/{idx}' annotation in an op_name
    path, as (op_type, block_idx, op_idx) — or None when the path
    carries no framework scope (e.g. parameter copies, infeed)."""
    m = None
    for m in _SCOPE_RE.finditer(op_name):
        pass
    if m is None:
        return None
    return m.group(1), int(m.group(2)), int(m.group(3))


# Device-time classes. A flash kernel goes by its own symbol; any other
# kernel takes the class of the op that launched it: the innermost aten
# op above the launch that is a convolution, a norm or a matrix product,
# else other. So a cuDNN convolution's GEMM-named kernels and its layout
# transposes count as conv whatever their names say.
KERNEL_CLASSES = {"fwd_kernel": "flash_attention_fwd",
                  "dq_kernel": "flash_attention_bwd_dq",
                  "dkv_kernel": "flash_attention_bwd_dkv"}
OP_CLASSES = {
    "conv": ("aten::conv2d", "aten::convolution", "aten::_convolution",
             "aten::cudnn_convolution", "aten::convolution_backward"),
    "norm": ("aten::batch_norm", "aten::_batch_norm_impl_index",
             "aten::native_batch_norm", "aten::cudnn_batch_norm",
             "aten::native_batch_norm_backward",
             "aten::cudnn_batch_norm_backward", "aten::layer_norm",
             "aten::native_layer_norm", "aten::native_layer_norm_backward"),
    "matmul": ("aten::linear", "aten::matmul", "aten::mm", "aten::addmm",
               "aten::bmm", "aten::baddbmm", "aten::_addmm_activation"),
}


def _flash_class(name):
    for key, cls in KERNEL_CLASSES.items():
        if key in name:
            return cls
    return None


def op_class(ev):
    """The class of the innermost op in OP_CLASSES at or above the
    profiler event `ev`, else other."""
    while ev is not None:
        for cls, ops in OP_CLASSES.items():
            if ev.name in ops:
                return cls
        ev = ev.cpu_parent
    return "other"


def _scope_finder(events):
    """A function from a profiler event to the framework op scope it ran
    in ('{type}:{block}/{idx}'), or None: the innermost scope among its
    CPU parents, else the scope whose host interval holds it. The second
    finds the scope of a backward kernel: on a card the autograd engine
    runs the backward ops on its own thread, while the grad op's scope
    waits for it on the executor's."""
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in events
                   if _is_cpu(ev) and _SCOPE_RE.fullmatch(ev.name))
    starts = [s for s, _, _ in spans]

    def find(ev):
        up = ev
        while up is not None:
            if _SCOPE_RE.fullmatch(up.name):
                return up.name
            up = up.cpu_parent
        i = bisect.bisect_right(starts, ev.time_range.start) - 1
        if i >= 0 and spans[i][1] >= ev.time_range.end:
            return spans[i][2]
        return None
    return find


def _is_device(ev):
    return str(getattr(ev, "device_type", "")).endswith("CUDA")


def _is_cpu(ev):
    return str(getattr(ev, "device_type", "")).endswith("CPU")


def _is_annotation(ev):
    """A record_function scope (an op scope, a record_event phase). On a
    card the profiler also gives each one a device-side span over the
    kernels it launched: counting those would count the kernels twice."""
    return bool(getattr(ev, "is_user_annotation", False)) or \
        _SCOPE_RE.fullmatch(ev.key) is not None


def _launches(events):
    """The CPU ops that launched kernels (scopes excluded)."""
    return [ev for ev in events
            if ev.kernels and _is_cpu(ev) and not _is_annotation(ev)]


def _self_device_us(ev):
    us = getattr(ev, "self_device_time_total", None)
    return getattr(ev, "self_cuda_time_total", 0.0) if us is None else us


def device_kernels(prof):
    """{(class, kernel name): (device milliseconds, launches)} from a
    torch.profiler run: each kernel's launches split by the class of the
    op that launched it (op_class); a flash kernel's class is its own.
    Launches the profiler links to no op count as class "unlinked"."""
    launched, linked = {}, {}
    for ev in prof.key_averages():
        dev_us = _self_device_us(ev)
        if dev_us and _is_device(ev) and not _is_annotation(ev):
            ms, n = launched.get(ev.key, (0.0, 0))
            launched[ev.key] = (ms + dev_us / 1e3, n + ev.count)
    for ev in _launches(prof.events()):
        cls = op_class(ev)
        for k in ev.kernels:
            parts = linked.setdefault(k.name, {})
            ms, n = parts.get(cls, (0.0, 0))
            parts[cls] = (ms + k.duration / 1e3, n + 1)
    out = {}
    for name, (ms, n) in launched.items():
        parts = dict(linked.get(name, {}))
        rest_n = n - sum(k for _, k in parts.values())
        if rest_n > 0:
            parts["unlinked"] = (max(ms - sum(m for m, _ in parts.values()),
                                     0.0), rest_n)
        for cls, (m, k) in parts.items():
            key = (_flash_class(name) or cls, name)
            m0, k0 = out.get(key, (0.0, 0))
            out[key] = (m0 + m, k0 + k)
    return out


def summarize_profile(prof=None, top=25):
    """Aggregate a torch.profiler run (default: the last one
    start_profiler began) by kernel name and class. Returns
    {"total_us", "by_category": {class: us}, "top_ops": [(name, us)]};
    the classes sum to total_us. On a card these are the CUDA kernels'
    device times (device_kernels); with no device event (a CPU run) they
    are the aten ops' self host times, classed by op_class.

    When the run recorded framework op scopes (FLAGS_op_trace_scopes),
    the result gains "by_framework_op": {scope: {op_type, block, op,
    calls, device_us, host_us, total_us, min_us, max_us}}, each kernel
    (or host op) attributed to the innermost scope above it, with an
    "(unattributed)" bucket for work outside any scope."""
    prof = prof if prof is not None else _prof
    if prof is None:
        raise RuntimeError("no torch profiler has run")
    by_cat, by_op = defaultdict(float), defaultdict(float)
    fw = {}
    events = prof.events()
    scope_of = _scope_finder(events)

    def attribute(ev, us, device):
        key = scope_of(ev) or "(unattributed)"
        acc = fw.get(key)
        if acc is None:
            acc = fw[key] = [0, 0.0, 0.0, float("inf"), 0.0]
        acc[0] += 1
        acc[1 if device else 2] += us
        acc[3] = min(acc[3], us)
        acc[4] = max(acc[4], us)

    kernels = device_kernels(prof)
    if kernels:
        for (cls, name), (ms, _) in kernels.items():
            by_cat[cls] += ms * 1e3
            by_op[name] += ms * 1e3
        for ev in _launches(events):
            for k in ev.kernels:
                attribute(ev, k.duration, True)
    else:
        for ev in events:
            us = ev.self_cpu_time_total
            if us and ev.name.startswith("aten::"):
                by_cat[op_class(ev)] += us
                by_op[ev.name] += us
                attribute(ev, us, False)
    total = sum(by_cat.values())
    out = {"total_us": total,
           "by_category": dict(sorted(by_cat.items(),
                                      key=lambda kv: -kv[1])),
           "top_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:top]}
    if any(k != "(unattributed)" for k in fw):
        table = {}
        for key, (calls, dev_us, host_us, mn, mx) in fw.items():
            scope = extract_op_scope(key)
            table[key] = {
                "op_type": scope[0] if scope else key,
                "block": scope[1] if scope else -1,
                "op": scope[2] if scope else -1,
                "calls": calls,
                "device_us": dev_us,
                "host_us": host_us,
                "total_us": dev_us + host_us,
                "min_us": mn,
                "max_us": mx,
            }
        out["by_framework_op"] = dict(sorted(
            table.items(), key=lambda kv: -kv[1]["total_us"]))
    return out
