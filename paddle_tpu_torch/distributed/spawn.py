"""A pool of rank processes for running one function on every rank.

`RankPool(world, store_path)` starts `world` processes with the spawn
method. Each joins a torch.distributed group through a FileStore at
`store_path` (no port to pick, so several pools can run side by side)
and waits for jobs. `pool.run(fn, *args)` runs ``fn(*args)`` on every
rank and returns the per-rank results in rank order; `fn` must be a
module-level function the ranks can import. A rank that raises fails
the call with its traceback, and a call that outlasts `timeout_s`
(a stuck collective) raises TimeoutError and ends the pool, so a caller
never hangs. `close()` stops every process.

Rank processes get `env` on top of the parent's environment; with
`device` set (e.g. "cuda:0", or "cuda:rank" for card r in rank r) each
binds that card first. Both ranks may bind one card under gloo; NCCL
needs one card a rank.
"""
from __future__ import annotations

import datetime
import os
import queue
import traceback

__all__ = ["RankPool"]


def _rank_main(rank, world, store_path, backend, timeout_s, device, env,
               jobs, results):
    os.environ.update(env)
    try:
        import torch
        import torch.distributed as dist
        if device == "cuda:rank":
            device = f"cuda:{rank}"
        if device and device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, "ready"))
    while True:
        job = jobs.get()
        if job is None:
            break
        fn, args = job
        try:
            results.put((rank, True, fn(*args)))
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world, store_path, backend="gloo", timeout_s=60.0,
                 device=None, env=None):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.world = world
        self.timeout_s = timeout_s
        self._jobs = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, world, store_path, backend, timeout_s, device,
                dict(env or {}), self._jobs[r], self._results))
            for r in range(world)]
        for p in self._procs:
            p.start()
        # process start-up (importing torch) is not the job's time
        self._collect(timeout_s + 120.0)

    def _collect(self, timeout_s):
        out = [None] * self.world
        errors = []
        for _ in range(self.world):
            try:
                rank, ok, value = self._results.get(timeout=timeout_s)
            except queue.Empty:
                self.close(force=True)
                raise TimeoutError(
                    f"rank pool: no answer within {timeout_s:.0f} s "
                    f"(a stuck collective or a dead rank)") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            self.close(force=True)
            raise RuntimeError("rank pool job failed\n" + "\n".join(errors))
        return out

    def run(self, fn, *args, timeout_s=None):
        """fn(*args) on every rank -> [result of rank 0, 1, ...]."""
        for q in self._jobs:
            q.put((fn, args))
        return self._collect(timeout_s or self.timeout_s)

    def close(self, force=False):
        if not force:
            for q in self._jobs:
                q.put(None)
            for p in self._procs:
                p.join(timeout=30)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self._procs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(force=exc[0] is not None)
