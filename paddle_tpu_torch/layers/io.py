"""layers.io — data declaration, the in-program readers and `load`."""
from __future__ import annotations

from ..framework import default_main_program

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=None, stop_gradient=True):
    """Declare a feed variable. append_batch_size=True prepends a dynamic
    batch dim (-1). A ragged var (lod_level=1) is padded on the device,
    [batch, T, *shape], with a dynamic T, and gets a lengths companion
    var (`_attach_lengths`); lod_level > 1 raises."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    if lod_level > 1:
        raise NotImplementedError(
            "data(lod_level>=2): nested ragged levels have no padded "
            "feed path yet — only one variable-length (time) dimension "
            "is supported")
    if lod_level == 1:
        shape = shape[:1] + [-1] + shape[1:]
    prog = default_main_program()
    blk = prog.global_block()
    if blk.has_var(name):
        v = blk.var(name)
        if lod_level > 0 and name not in prog.lod_link:
            _attach_lengths(prog, name)
        return v
    v = blk.create_var(name=name, shape=shape, dtype=dtype,
                       lod_level=lod_level, stop_gradient=stop_gradient,
                       is_data=True)
    if lod_level > 0:
        _attach_lengths(prog, name)
    return v


def _attach_lengths(prog, name):
    """Declare the ragged var's lengths companion, "<name>.lengths"
    (int64 [batch]), and link it (program.lod_link): the executor feeds
    it from a LoDTensor, and the sequence layers read it."""
    ln = f"{name}.lengths"
    if not prog.global_block().has_var(ln):
        prog.global_block().create_var(
            name=ln, shape=[-1], dtype="int64", lod_level=0,
            stop_gradient=True, is_data=True)
    prog.lod_link[name] = ln


__all__ += ["read_file", "double_buffer", "py_reader",
            "create_py_reader_by_data", "load"]


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Declare one feed var a slot and return a PyReader over them; the
    vars come back from read_file(reader), and the reader's decorate_*
    generators feed them through its prefetch queue."""
    from ..framework import unique_name
    from ..reader import PyReader
    lod_levels = lod_levels or [0] * len(shapes)
    feed_vars = []
    for i, (shp, dt, ll) in enumerate(zip(shapes, dtypes, lod_levels)):
        feed_vars.append(data(
            unique_name.generate(f"{name or 'py_reader'}_slot{i}"),
            shape=list(shp), dtype=dt, lod_level=ll,
            append_batch_size=False))
    r = PyReader(feed_list=feed_vars, capacity=capacity,
                 use_double_buffer=use_double_buffer)
    r._data_vars = feed_vars
    return r


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    from ..reader import PyReader
    r = PyReader(feed_list=list(feed_list), capacity=capacity,
                 use_double_buffer=use_double_buffer)
    r._data_vars = list(feed_list)
    return r


def read_file(reader):
    """The reader's declared data vars (one var, or a list of them): the
    prefetch queue feeds the same vars every step."""
    vs = getattr(reader, "_data_vars", None) or \
        getattr(reader, "feed_list", None)
    if not vs:
        raise ValueError("read_file: reader has no data vars")
    return vs if len(vs) > 1 else vs[0]


def double_buffer(reader, place=None, name=None):
    """Identity: the reader's prefetch queue already double-buffers
    (FLAGS_reader_queue_depth)."""
    return reader


def load(out, file_path, load_as_fp16=False):
    """Read one saved tensor (`file_path`, .npy) into `out` when the
    program runs: the `load` op."""
    from ..layer_helper import LayerHelper
    helper = LayerHelper("load")
    helper.append_op(type="load", inputs={},
                     outputs={"Out": [out.name]},
                     attrs={"file_path": file_path,
                            "shape": [int(s) for s in (out.shape or [])],
                            "dtype": out.dtype})
    return out
