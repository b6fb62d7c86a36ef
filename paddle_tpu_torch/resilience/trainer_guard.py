"""Resilient training loop: NaN rollback, preemption, watchdog.

The JAX package's `resilience/trainer_guard.py` over this package's
executor and Scope. Wraps the plain ``exe.run`` training loop with the
three recoveries the reference framework bakes into its trainer
(checkpoint notify + error-clearing) and a long training job needs in
practice:

* **NaN-step rollback** — every ``snapshot_every`` steps the guard
  copies the persistable state (tensor copies on the state's own
  device: the optimizers update in place); when a step's fetches come
  back non-finite (or the ``FLAGS_check_nan_inf`` guard raises
  FloatingPointError mid-step, naming the op) the guard restores the
  snapshot and reports the step as *skipped* instead of crashing the
  run. With the default ``snapshot_every=1`` the recovery is exactly
  "the poisoned batch never happened".

* **SIGTERM preemption** — the guard chains onto the process SIGTERM
  handler; on delivery it only sets a flag, the in-flight step
  completes, then ``step()`` writes an atomic checkpoint (persistables
  + ``guard_state.json`` with the consumed-batch count, manifest-last
  commit) and raises PreemptedError. ``TrainerGuard.resume`` restores
  state and returns how many batches the stream must skip for a
  step-accurate restart.

* **Watchdog** — a daemon thread that notices a step exceeding
  ``watchdog_timeout_s`` and dumps the flight recorder once per stuck
  step (the post-mortem the run would otherwise take to its grave).

Usage::

    guard = TrainerGuard(exe, program, fetch_list=[loss],
                         checkpoint_dir="ckpt")
    for batch in stream:
        out = guard.step({"x": batch})   # None = NaN step skipped
    guard.close()

Deterministic-resume caveat: the executor's per-program step counter
(the PRNG fold-in) keeps advancing across skipped batches, so
bit-identical resume holds for deterministic programs (no dropout);
stochastic programs resume correctly but not bit-identically.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Dict, List, Optional

import numpy as np

import torch

from .. import goodput as _goodput
from ..convert import tensor_from_numpy
from ..core.dtypes import as_torch_dtype
from ..core.scope import Scope, global_scope
from ..monitor import (STAT_ADD, dump_flight_recorder, flight_record)

__all__ = ["TrainerGuard", "PreemptedError", "NanStepError"]

_GUARD_STATE = "guard_state.json"


class PreemptedError(RuntimeError):
    """Raised by TrainerGuard.step after a SIGTERM-triggered checkpoint.
    Carries the checkpoint dir and the consumed-batch count."""

    def __init__(self, msg: str, checkpoint_dir: Optional[str],
                 global_step: int):
        super().__init__(msg)
        self.checkpoint_dir = checkpoint_dir
        self.global_step = global_step


class NanStepError(RuntimeError):
    """Raised when NaN steps exceed max_nan_skips — persistent NaN is a
    model/data bug, not a transient to paper over."""


def _persistable_names(program, scope) -> List[str]:
    return [v.name for v in program.list_vars()
            if v.persistable and not v.is_data and scope.has(v.name)]


def _copy(value):
    """A copy of a scope value that no later in-place update reaches."""
    if isinstance(value, torch.Tensor):
        return value.detach().clone()
    return np.array(value, copy=True)


class TrainerGuard:
    """Resilient wrapper around ``exe.run`` for a training program."""

    def __init__(self, exe, program, scope: Optional[Scope] = None,
                 fetch_list=None, checkpoint_dir: Optional[str] = None,
                 snapshot_every: int = 1, checkpoint_every: int = 0,
                 watchdog_timeout_s: float = 0.0,
                 max_nan_skips: int = 10,
                 install_sigterm: bool = True):
        self.exe = exe
        self.program = program
        self.scope = scope or global_scope()
        self.fetch_list = list(fetch_list or [])
        self.checkpoint_dir = checkpoint_dir
        self.snapshot_every = max(0, int(snapshot_every))
        self.checkpoint_every = max(0, int(checkpoint_every))
        self.max_nan_skips = int(max_nan_skips)

        self.global_step = 0        # batches consumed (skips included)
        self.nan_skips = 0
        self._snapshot: Dict[str, np.ndarray] = {}
        self._snapshot_step = -1
        self._preempt_requested = False
        self._preempt_draining = False
        self._closed = False

        self._prev_term = None
        self._installed_sigterm = False
        if install_sigterm:
            self._install_sigterm()

        self._watchdog: Optional[threading.Thread] = None
        self._watchdog_stop = threading.Event()
        self._step_started: Optional[float] = None
        self._step_serial = 0
        self.watchdog_timeout_s = float(watchdog_timeout_s)
        if self.watchdog_timeout_s > 0:
            self._watchdog = threading.Thread(
                target=self._watchdog_loop, name="ptt-trainer-watchdog",
                daemon=True)
            self._watchdog.start()

    # -- SIGTERM --------------------------------------------------------

    def _install_sigterm(self):
        prev = signal.getsignal(signal.SIGTERM)

        def on_term(signum, frame):
            # flag only: the in-flight step finishes, step() checkpoints
            self._preempt_requested = True
            STAT_ADD("resilience.preemptions")
            flight_record("preempt_requested", step=self.global_step)
            if callable(prev) and prev not in (signal.SIG_DFL,
                                               signal.SIG_IGN):
                prev(signum, frame)

        try:
            signal.signal(signal.SIGTERM, on_term)
            self._prev_term = prev
            self._installed_sigterm = True
        except (ValueError, OSError):
            pass  # non-main thread: caller must deliver preemption
            # via request_preemption()

    def request_preemption(self):
        """Programmatic preemption notice (same path as SIGTERM)."""
        self._preempt_requested = True

    # -- watchdog -------------------------------------------------------

    def _watchdog_loop(self):
        poll = max(0.05, self.watchdog_timeout_s / 4.0)
        fired_for = -1
        while not self._watchdog_stop.wait(poll):
            started = self._step_started
            serial = self._step_serial
            if started is None or serial == fired_for:
                continue
            if time.monotonic() - started > self.watchdog_timeout_s:
                fired_for = serial
                STAT_ADD("resilience.watchdog_fires")
                flight_record("watchdog_stuck_step",
                              step=self.global_step,
                              stuck_seconds=round(
                                  time.monotonic() - started, 3))
                try:
                    dump_flight_recorder(reason="watchdog_stuck_step")
                except OSError:
                    pass

    # -- snapshot / rollback -------------------------------------------

    def _take_snapshot(self):
        snap = {}
        for n in _persistable_names(self.program, self.scope):
            snap[n] = _copy(self.scope.get(n))
        self._snapshot = snap
        self._snapshot_step = self.global_step
        STAT_ADD("resilience.snapshots")

    def _rollback(self):
        t0 = time.perf_counter()
        for n, a in self._snapshot.items():
            self.scope.set(n, _copy(a))
        _goodput.attribute("nan_rollback", time.perf_counter() - t0)
        STAT_ADD("resilience.rollbacks")
        flight_record("rollback", step=self.global_step,
                      snapshot_step=self._snapshot_step)

    # -- checkpoint / resume -------------------------------------------

    def checkpoint(self, dirname: Optional[str] = None) -> str:
        """Atomic checkpoint: every persistable via io's atomic per-var
        writes, then guard_state.json LAST as the commit marker."""
        from ..io import atomic_np_save, atomic_write_text
        dirname = dirname or self.checkpoint_dir
        if not dirname:
            raise ValueError("no checkpoint_dir configured")
        t0 = time.perf_counter()
        os.makedirs(dirname, exist_ok=True)
        names = _persistable_names(self.program, self.scope)
        for n in names:
            atomic_np_save(
                os.path.join(dirname,
                             n.replace("/", "%2F") + ".npy"),
                self.scope.get_numpy(n))
        atomic_write_text(
            os.path.join(dirname, _GUARD_STATE),
            json.dumps({"global_step": self.global_step,
                        "nan_skips": self.nan_skips,
                        "vars": names}))
        # on the preemption path the whole drain (this checkpoint) is
        # preempt_drain, not a routine checkpoint_save
        _goodput.attribute(
            "preempt_drain" if self._preempt_draining
            else "checkpoint_save",
            time.perf_counter() - t0)
        STAT_ADD("resilience.checkpoints")
        flight_record("checkpoint", step=self.global_step, dir=dirname)
        return dirname

    def resume(self, dirname: Optional[str] = None) -> int:
        """Restore a checkpoint written by checkpoint(); returns the
        consumed-batch count the data stream must skip."""
        dirname = dirname or self.checkpoint_dir
        t0 = time.perf_counter()
        state_path = os.path.join(dirname, _GUARD_STATE)
        with open(state_path) as f:
            state = json.load(f)
        block = self.program.global_block()
        for n in state["vars"]:
            path = os.path.join(dirname,
                                n.replace("/", "%2F") + ".npy")
            # numpy holds bfloat16 widened to float32: back to the
            # var's own dtype, on the executor's device
            self.scope.set(n, tensor_from_numpy(
                np.load(path), self.exe.device).to(
                    as_torch_dtype(block.var(n).dtype)))
        self.global_step = int(state["global_step"])
        self.nan_skips = int(state.get("nan_skips", 0))
        self._snapshot = {}
        self._snapshot_step = -1
        _goodput.attribute("checkpoint_restore",
                           time.perf_counter() - t0)
        STAT_ADD("resilience.resumes")
        flight_record("resume", step=self.global_step, dir=dirname)
        return self.global_step

    @staticmethod
    def has_checkpoint(dirname: str) -> bool:
        return os.path.exists(os.path.join(dirname, _GUARD_STATE))

    # -- the step -------------------------------------------------------

    def _checkpoint_and_raise(self):
        where = None
        if self.checkpoint_dir:
            self._preempt_draining = True
            try:
                where = self.checkpoint(self.checkpoint_dir)
            finally:
                self._preempt_draining = False
        raise PreemptedError(
            f"preempted at step {self.global_step}"
            + (f"; checkpoint in {where}" if where else ""),
            where, self.global_step)

    def step(self, feed, fetch_list=None):
        """Run one training step. Returns the fetch list, or None when
        the step was NaN-poisoned and rolled back (the batch counts as
        consumed either way). Raises PreemptedError after a SIGTERM
        checkpoint."""
        if self._closed:
            raise RuntimeError("TrainerGuard is closed")
        if self._preempt_requested:
            self._checkpoint_and_raise()
        if self.snapshot_every and (
                self._snapshot_step < 0
                or self.global_step - self._snapshot_step
                >= self.snapshot_every):
            self._take_snapshot()

        fl = fetch_list if fetch_list is not None else self.fetch_list
        self._step_serial += 1
        self._step_started = time.monotonic()
        poisoned = None
        try:
            out = self.exe.run(self.program, feed=feed, fetch_list=fl,
                               scope=self.scope)
        except FloatingPointError as e:
            # FLAGS_check_nan_inf guard fired mid-step (with op/var
            # provenance): recoverable here
            poisoned, out = e, None
        finally:
            self._step_started = None

        if poisoned is None and out:
            for a in out:
                if isinstance(a, np.ndarray) \
                        and np.issubdtype(a.dtype, np.floating) \
                        and a.size and not np.all(np.isfinite(a)):
                    poisoned = FloatingPointError(
                        "non-finite fetch value")
                    break

        self.global_step += 1

        if poisoned is not None:
            self.nan_skips += 1
            STAT_ADD("resilience.nan_steps_skipped")
            flight_record("nan_step_skipped", step=self.global_step - 1,
                          error=repr(poisoned))
            self._rollback()
            if self.max_nan_skips and \
                    self.nan_skips > self.max_nan_skips:
                raise NanStepError(
                    f"{self.nan_skips} NaN steps exceed "
                    f"max_nan_skips={self.max_nan_skips}; last: "
                    f"{poisoned!r}") from poisoned
            out = None

        if self._preempt_requested:
            self._checkpoint_and_raise()
        if self.checkpoint_every and self.checkpoint_dir and \
                self.global_step % self.checkpoint_every == 0:
            self.checkpoint(self.checkpoint_dir)
        return out

    def close(self):
        """Stop the watchdog and restore the previous SIGTERM handler."""
        if self._closed:
            return
        self._closed = True
        self._watchdog_stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2.0)
        if self._installed_sigterm:
            try:
                signal.signal(signal.SIGTERM, self._prev_term)
            except (ValueError, OSError, TypeError):
                pass
            self._installed_sigterm = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
