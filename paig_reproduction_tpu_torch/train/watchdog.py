"""Hung-device watchdog (``--watchdog_secs``, ``--watchdog_floor_secs``).

Counterpart of ``paig_reproduction_tpu/train/watchdog.py``. A device call
that never returns (a lost card, a wedged GPU) leaves the training
process blocked inside C++ for good; the watchdog turns that into a bounded
failure:

- the train and eval loops ``pet()`` it once per batch;
- a daemon thread checks the heartbeat, and if no pet lands within the
  effective timeout it logs the stall, flushes the logs and ends the
  process with ``os._exit(EXIT_CODE)`` (75, EX_TEMPFAIL): the main thread
  is stuck in code that never returns to Python, so no exception or signal
  handler would run;
- a supervisor tells that code apart and resumes the run with
  ``--use_ckpt``. State loss is bounded by the last checkpoint.

**Adaptive mode** (``adaptive_floor_secs`` > 0): after ``WARMUP_PETS``
heartbeats the effective timeout tightens to
``clamp(ADAPT_FACTOR * ewma(inter-pet interval), floor, timeout)``. The
fixed timeout still covers the first batches (their compiles and cuDNN
autotuning); gaps at the timeout's scale are left out of the estimate.

Three changes from the JAX module:

- the floor is clamped to at most the timeout (a floor above it would
  loosen detection past the fixed ceiling, which the CLI help rules out);
- ``clock`` is an argument (``time.monotonic`` by default), so tests drive
  the timing logic without patching the ``time`` module;
- the trainer calls ``stop()`` once its batch loops are done, before the
  post-training artifacts, which emit no pets.
"""
from __future__ import annotations

import logging
import os
import sys
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger("paig")

#: Process exit code when the watchdog fires (EX_TEMPFAIL: retryable).
EXIT_CODE = 75

#: Heartbeats observed before the adaptive timeout activates.
WARMUP_PETS = 20

#: Adaptive effective timeout = ADAPT_FACTOR x EWMA(inter-pet interval),
#: clamped to [adaptive_floor_secs, timeout].
ADAPT_FACTOR = 100.0


class DeviceWatchdog:
    """Heartbeat monitor for blocking device calls. ``start()`` is
    idempotent; ``pet()`` is one clock read and a few stores; ``stop()``
    disarms (the thread ends at its next wake)."""

    def __init__(self, timeout_secs: float, note: str = "",
                 adaptive_floor_secs: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = float(timeout_secs)
        self.floor = min(float(adaptive_floor_secs), self.timeout)
        self.note = note
        self._clock = clock
        self._last = clock()
        self._armed = False
        self._thread: Optional[threading.Thread] = None
        self._pets = 0
        self._ewma = 0.0

    def pet(self):
        now = self._clock()
        if self.floor > 0:
            dt = now - self._last
            # Gaps at the ceiling's scale are stalls or compiles, not the
            # loop's cadence.
            if 0.0 < dt < self.timeout:
                self._ewma = dt if self._pets == 0 else (
                    0.9 * self._ewma + 0.1 * dt)
                self._pets += 1
        self._last = now

    def effective_timeout(self) -> float:
        """The fixed timeout until the warm-up is done; then the adapted
        value clamped to [floor, timeout]."""
        if self.floor <= 0 or self._pets < WARMUP_PETS:
            return self.timeout
        return max(self.floor, min(self.timeout, ADAPT_FACTOR * self._ewma))

    def stale(self) -> Optional[float]:
        """Seconds since the last pet if they exceed the effective timeout
        while armed, else None."""
        idle = self._clock() - self._last
        return idle if self._armed and idle > self.effective_timeout() \
            else None

    def start(self):
        if self.timeout <= 0 or self._armed:
            return
        self._armed = True
        self._last = self._clock()
        self._thread = threading.Thread(
            target=self._watch, name="paig-device-watchdog", daemon=True)
        self._thread.start()
        logger.info("device watchdog armed (%.0fs heartbeat timeout)",
                    self.timeout)

    def stop(self):
        self._armed = False

    def _watch(self):
        # Adaptive mode watches on the minutes scale: wake once a second.
        base = 1.0 if self.floor > 0 else max(1.0, min(15.0,
                                                       self.timeout / 4.0))
        while self._armed:
            time.sleep(max(1.0, min(base, self.effective_timeout() / 4.0)))
            idle = self.stale()
            if idle is not None:
                self._fire(idle, self.effective_timeout())
                return

    def _fire(self, stale: float, limit: float):
        logger.error(
            "device watchdog: no loop progress for %.0fs (> %.0fs) — "
            "device call presumed hung%s; exiting %d so a supervisor can "
            "resume from the last checkpoint", stale, limit,
            " [%s]" % self.note if self.note else "", EXIT_CODE)
        for h in logger.handlers:
            try:
                h.flush()
            except Exception:
                pass
        try:
            sys.stdout.flush()
            sys.stderr.flush()
        except Exception:
            pass
        os._exit(EXIT_CODE)
