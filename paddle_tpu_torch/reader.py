"""DataLoader / PyReader: the host input pipeline with prefetch.

A prefetch thread runs the user's generator and stages its batches in a
bounded queue (`capacity`, or FLAGS_reader_queue_depth when None) while
the card computes; the training thread takes one batch a step. Batches
stay numpy feed dicts: ``Executor.run`` moves them to the card.

What the training thread waits for is measured: each batch's wait
(``reader.batch_wait_seconds``), the queue depth left after it
(``reader.queue_depth``), the batches taken (``reader.batches``), and
goodput's ``input_wait`` category and starvation detector
(``goodput.note_input_wait``). An injected reader stall
(``FLAGS_fault_spec=slow_step:...:site=reader``) lands inside the
measured wait. A generator's exception re-raises on the training
thread, never as a silently truncated epoch.

``DataLoader.from_dataset`` needs the Dataset's native feed, which is
not ported yet (ROADMAP §A8): it raises.
"""
from __future__ import annotations

import queue
import threading
import time

from . import goodput as _goodput
from .monitor import STAT_ADD, STAT_OBSERVE, STAT_SET

__all__ = ["DataLoader", "PyReader"]


class _WorkerError:
    """Envelope carrying a prefetch-worker exception to the consumer."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


class _GeneratorLoader:
    def __init__(self, feed_list, capacity, iterable, return_list,
                 use_double_buffer=True):
        self.feed_list = feed_list
        self.capacity = capacity
        self.iterable = iterable
        self.return_list = return_list
        self._gen = None
        self._places = None

    # -- configuration ---------------------------------------------------
    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        from .reader_decorator import batch
        return self.set_sample_list_generator(
            batch(reader, batch_size, drop_last), places)

    def set_sample_list_generator(self, reader, places=None):
        from .data_feeder import DataFeeder
        feeder = DataFeeder(self.feed_list)

        def gen():
            for sample_list in reader():
                yield feeder.feed(sample_list)

        self._gen = gen
        self._places = places
        return self

    def set_batch_generator(self, reader, places=None):
        def gen():
            for batch in reader():
                if isinstance(batch, dict):
                    yield batch
                else:
                    yield {v.name: b for v, b in zip(self.feed_list, batch)}

        self._gen = gen
        self._places = places
        return self

    # -- iteration with prefetch ----------------------------------------
    def __iter__(self):
        from .core.flags import FLAGS
        from .resilience.faults import injector as _fault_injector
        q: "queue.Queue" = queue.Queue(
            maxsize=self.capacity or FLAGS.reader_queue_depth)
        sentinel = object()

        def worker():
            try:
                for item in self._gen():
                    q.put(item)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                q.put(_WorkerError(e))
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            # the training thread's stall on the prefetch queue; the
            # depth sampled after the get is the prefetch headroom left
            t0 = time.perf_counter()
            item = q.get()
            STAT_SET("reader.queue_depth", q.qsize())
            if item is sentinel:
                break
            if isinstance(item, _WorkerError):
                raise item.exc
            inj = _fault_injector()
            if inj is not None:
                # an injected stall models a slow data source: it sits
                # inside the measured wait
                inj.pre_step("reader")
            wait_s = time.perf_counter() - t0
            STAT_OBSERVE("reader.batch_wait_seconds", wait_s)
            # no-op unless FLAGS_enable_goodput and a run is active
            _goodput.note_input_wait(wait_s)
            STAT_ADD("reader.batches")
            yield item

    def __call__(self):
        return iter(self)

    # PyReader-style start/reset are no-ops for the iterable loader.
    def start(self):
        pass

    def reset(self):
        pass


class DataLoader:
    @staticmethod
    def from_generator(feed_list=None, capacity=None,
                       use_double_buffer=True, iterable=True,
                       return_list=False):
        """capacity=None defers to FLAGS_reader_queue_depth at iteration
        time (default 2)."""
        return _GeneratorLoader(feed_list or [], capacity, iterable,
                                return_list, use_double_buffer)

    @staticmethod
    def from_dataset(dataset, places=None, drop_last=True):
        raise NotImplementedError(
            "DataLoader.from_dataset needs the Dataset's native feed, "
            "which is not ported yet (ROADMAP §A8)")


class PyReader(_GeneratorLoader):
    def __init__(self, feed_list=None, capacity=None,
                 use_double_buffer=True, iterable=True, return_list=False):
        super().__init__(feed_list or [], capacity, iterable, return_list,
                         use_double_buffer)

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        return self.set_sample_generator(sample_generator, batch_size,
                                         drop_last, places)

    def decorate_sample_list_generator(self, reader, places=None):
        return self.set_sample_list_generator(reader, places)

    def decorate_batch_generator(self, reader, places=None):
        return self.set_batch_generator(reader, places)
