"""Fleet-runtime health machinery: stragglers, heartbeats, preemption.

* ``StepMonitor`` — EWMA step-time tracker; flags straggler steps (z-score
  over a robust MAD estimate). In a multi-host deployment each host runs one
  and the controller compares `snapshot()`s; slow hosts get drained (the hook
  is ``on_straggler``).
* ``Heartbeat``   — liveness file for an external supervisor (touch every K
  seconds; supervisor restarts the job if stale).
* ``PreemptionGuard`` — converts SIGTERM into a cooperative "checkpoint and
  exit" flag the training loop polls.
"""

from __future__ import annotations

import collections
import os
import signal
import threading
import time
from typing import Callable, Deque, Dict, Optional


class StepMonitor:
    def __init__(self, *, window: int = 64, z_threshold: float = 4.0,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.window = window
        self.z = z_threshold
        self.times: Deque[float] = collections.deque(maxlen=window)
        self.on_straggler = on_straggler
        self.flagged = 0
        self.steps = 0
        self._ewma: Optional[float] = None

    def record(self, step: int, seconds: float) -> bool:
        """Returns True if this step is a straggler."""
        self.steps += 1
        is_bad = False
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            mad = sorted(abs(t - med) for t in self.times)[len(self.times) // 2]
            # A window of identical step times has MAD = 0; flooring sigma at
            # only 1e-6 would then flag ANY nanosecond of jitter as a
            # straggler. Floor at a fraction of the median too, so "slow"
            # always means slow relative to the typical step.
            sigma = max(1.4826 * mad, 0.05 * med, 1e-6)
            if (seconds - med) / sigma > self.z:
                is_bad = True
                self.flagged += 1
                if self.on_straggler:
                    self.on_straggler(step, seconds)
        self.times.append(seconds)
        a = 0.1
        self._ewma = seconds if self._ewma is None else a * seconds + (1 - a) * self._ewma
        return is_bad

    def snapshot(self) -> Dict[str, float]:
        return {"ewma_s": self._ewma or 0.0, "flagged": self.flagged,
                "steps": self.steps}


class Heartbeat:
    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        def beat():
            while not self._stop.wait(self.interval):
                self._touch()
        self._touch()
        self._thread = threading.Thread(target=beat, daemon=True)
        self._thread.start()

    def _touch(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            f.write(str(time.time()))

    def touch(self) -> None:
        """Synchronous liveness update — for event-driven loops (the serving
        engine beats once per dispatch) instead of the timer thread."""
        self._touch()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)

    @staticmethod
    def is_alive(path: str, stale_after_s: float = 60.0) -> bool:
        try:
            with open(path) as f:
                return time.time() - float(f.read()) < stale_after_s
        except (OSError, ValueError):
            return False


class PreemptionGuard:
    """SIGTERM → cooperative shutdown flag (poll ``should_exit``)."""

    def __init__(self, install: bool = True):
        self._flag = threading.Event()
        if install:
            try:
                signal.signal(signal.SIGTERM, self._handler)
            except ValueError:
                pass  # not on the main thread (tests)

    def _handler(self, signum, frame):
        self._flag.set()

    def trigger(self) -> None:  # tests / manual drain
        self._flag.set()

    @property
    def should_exit(self) -> bool:
        return self._flag.is_set()
