"""Functional data-pipeline combinators.

Readers are nullary callables returning sample generators; decorators
compose them (shuffle, batch, buffered, map, chain, compose, firstn,
cache, xmap_readers, multiprocess_reader). They feed DataFeeder and
DataLoader, whose batches the executor moves to the card. This is the
JAX package's module, copied: the same samples in the same order, the
same ``reader.*`` stats, and every worker's exception re-raised in the
consumer.
"""
from __future__ import annotations

import itertools
import queue
import random as _random
import threading
import time

from .monitor import STAT_ADD, STAT_OBSERVE, STAT_SET

__all__ = ["cache", "map_readers", "buffered", "compose", "chain",
           "shuffle", "firstn", "xmap_readers", "multiprocess_reader",
           "batch", "ComposeNotAligned", "ReaderWorkerDied"]


class ComposeNotAligned(ValueError):
    pass


class ReaderWorkerDied(RuntimeError):
    """A multiprocess_reader worker exited without finishing its stream
    (OOM-kill, SIGKILL, crash) — raised in the consumer instead of
    hanging forever on a queue that will never fill."""


def cache(reader):
    state = {"data": None}

    def r():
        if state["data"] is None:
            # materialize into a local first: a partial read that raises
            # must not leave a half-filled cache behind
            state["data"] = list(reader())
        return iter(state["data"])
    return r


def map_readers(func, *readers):
    def r():
        for vals in zip(*[rd() for rd in readers]):
            yield func(*vals)
    return r


def shuffle(reader, buf_size):
    def r():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf
    return r


def chain(*readers):
    def r():
        return itertools.chain(*[rd() for rd in readers])
    return r


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    _end = object()

    def r():
        rs = [rd() for rd in readers]
        if check_alignment:
            # zip() would consume one extra element from longer readers
            # before noticing a short one; zip_longest sees the ragged
            # tail regardless of argument order
            for items in itertools.zip_longest(*rs, fillvalue=_end):
                if any(i is _end for i in items):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned")
                yield sum((make_tuple(i) for i in items), ())
        else:
            for items in zip(*rs):
                yield sum((make_tuple(i) for i in items), ())
    return r


class _ReaderError:
    def __init__(self, exc):
        self.exc = exc


def buffered(reader, size):
    """Background-thread prefetch (the host half of a double-buffered
    reader). A source-reader exception re-raises in the consumer, never
    a silently truncated stream."""
    end = object()

    def r():
        q = queue.Queue(maxsize=size)

        def fill():
            try:
                for e in reader():
                    q.put(e)
                q.put(end)
            except BaseException as exc:  # propagate to consumer
                q.put(_ReaderError(exc))

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            # same starvation signal as reader.DataLoader: time the
            # consumer spends blocked on the prefetch queue
            t0 = time.perf_counter()
            e = q.get()
            STAT_OBSERVE("reader.batch_wait_seconds",
                         time.perf_counter() - t0)
            STAT_SET("reader.queue_depth", q.qsize())
            if e is end:
                return
            if isinstance(e, _ReaderError):
                raise e.exc
            STAT_ADD("reader.batches")
            yield e
    return r


def firstn(reader, n):
    def r():
        return itertools.islice(reader(), n)
    return r


def xmap_readers(mapper, reader, process_num, buffer_size,
                 order=False):
    """Thread-pool map over a reader; with `order`, the samples come out
    in the source's order."""
    end = object()

    def r():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def feed():
            try:
                for i, e in enumerate(reader()):
                    in_q.put((i, e))
                for _ in range(process_num):
                    in_q.put(end)
            except BaseException as exc:
                out_q.put(_ReaderError(exc))  # surface + unblock consumer

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, e = item
                try:
                    out_q.put((i, mapper(e)))
                except BaseException as exc:
                    out_q.put(_ReaderError(exc))
                    return

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()

        finished = 0
        pending = {}
        next_i = 0
        while finished < process_num:
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            if isinstance(item, _ReaderError):
                raise item.exc
            i, v = item
            if not order:
                yield v
            else:
                pending[i] = v
                while next_i in pending:
                    yield pending.pop(next_i)
                    next_i += 1
        if order:
            for i in sorted(pending):
                yield pending[i]
    return r


def _mp_worker(reader, q, idx):
    """Module-level so the spawn context can pickle it. Protocol:
    ("item", sample)* then ("end", idx); an exception sends
    ("error", idx, exc) instead of the end sentinel."""
    try:
        for e in reader():
            q.put(("item", e))
    except BaseException as exc:  # noqa: BLE001 — ship it to the consumer
        try:
            q.put(("error", idx, exc))
        except Exception:  # unpicklable exception: send its repr
            q.put(("error", idx, RuntimeError(repr(exc))))
        return
    q.put(("end", idx))


def multiprocess_reader(readers, use_pipe=True, queue_size=1000,
                        get_timeout_s=1.0):
    """Run each reader in its own OS process (spawn context — CUDA does
    not survive fork()), multiplexed onto one bounded
    queue. Samples interleave in arrival order (`use_pipe` is accepted
    for reference API compatibility; the transport is always a
    multiprocessing queue).

    Every queue read is bounded by ``get_timeout_s``; on timeout the
    consumer checks worker liveness and raises :class:`ReaderWorkerDied`
    naming the exit code when a worker vanished without its end
    sentinel — the alternative is a training loop blocked forever on a
    queue no one will ever fill."""
    import multiprocessing as mp
    readers = list(readers)
    if not readers:
        raise ValueError("multiprocess_reader: need at least one reader")

    def r():
        ctx = mp.get_context("spawn")
        q = ctx.Queue(queue_size)
        procs = [ctx.Process(target=_mp_worker, args=(rd, q, i),
                             daemon=True)
                 for i, rd in enumerate(readers)]
        for p in procs:
            p.start()
        live = set(range(len(procs)))
        try:
            while live:
                t0 = time.perf_counter()
                try:
                    msg = q.get(timeout=get_timeout_s)
                except queue.Empty:
                    for i in sorted(live):
                        p = procs[i]
                        if p.is_alive():
                            continue
                        if p.exitcode == 0:
                            # clean exit whose sentinel we somehow
                            # missed: treat the stream as finished
                            live.discard(i)
                            continue
                        STAT_ADD("reader.worker_deaths")
                        raise ReaderWorkerDied(
                            f"multiprocess_reader worker {i} died with "
                            f"exit code {p.exitcode} before finishing "
                            f"its stream")
                    continue
                STAT_OBSERVE("reader.batch_wait_seconds",
                             time.perf_counter() - t0)
                kind = msg[0]
                if kind == "end":
                    live.discard(msg[1])
                elif kind == "error":
                    raise msg[2]
                else:
                    STAT_ADD("reader.batches")
                    yield msg[1]
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=2.0)
            q.close()
    return r


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists of batch_size."""
    def r():
        b = []
        for e in reader():
            b.append(e)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return r
