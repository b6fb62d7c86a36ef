"""Readers for the multiprocess_reader tests of test_torch_reader.py.

Module-level, in a module that imports only the standard library, so
the spawn context pickles them by name and a worker process starts
without importing either framework's test module.
"""
import os
import time


def range_reader():
    for i in range(4):
        yield i


def tens_reader():
    for i in range(10, 14):
        yield i


def failing_reader():
    yield 1
    raise ValueError("reader failed on purpose")


def pid_then_hang_reader():
    yield os.getpid()
    time.sleep(300)
    yield -1
