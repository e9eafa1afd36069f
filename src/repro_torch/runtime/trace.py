"""Spans and counters inside the program.

``span(name, on)`` marks a stretch of the program's work and ``add(name,
n)`` counts what it moved, both by name. They record only while a
``torch.profiler`` session is active or inside ``recording()``; otherwise
``span`` returns one shared no-op context and ``add`` returns at once:
nothing is allocated, launched or synchronised.

While on, a span

* enters a function-scope profiler record of its name, so it sits in a
  running profiler trace on the profiler's clock (the clock of the
  device's kernels) as a host operation nested under its parent, with no
  copy mirrored onto the device (a user-scope
  ``torch.profiler.record_function`` adds one, and costs more under the
  profiler: ``PERF.md`` gives the measurement);
* where ``on`` is a CUDA tensor, records a timing event pair on that
  device's current stream at entry and exit, and never waits for them;
* notes its parent, the innermost open span of its thread, and the call id
  of its root: a span opened with no span open starts a new call; a
  backward rule passes ``call=`` the id ``current_call()`` gave its
  forward.

A closed span is folded into its name's totals once its end event has
completed (asked with ``query()`` whenever a root span closes, so the
recorder never waits; the device's own queue bounds how far behind the
events can fall). The records of the last ``KEEP_CALLS`` calls are kept
whole. ``summary()`` waits for the outstanding events and returns, for
each span name, its calls, host ms, device ms and device self ms (its
device ms less its child spans'), and each counter's total; a span that
recorded no device events reads ``None`` on the device. ``reset()``
clears everything.

Counters take host integers known from shapes: a counter never reads a
tensor's values.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

#: calls whose span records ``calls()`` keeps whole
KEEP_CALLS = 64

_profiler_enabled = torch.autograd._profiler_enabled
_record = torch._C._profiler._RecordFunctionFast


class _Off:
    """The context ``span`` returns while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """One open or closed span, until it is folded into the totals."""
    __slots__ = ("rec", "name", "dev", "call", "parent", "parent_name",
                 "fn", "t0", "host_ns", "ev0", "ev1", "child_ms")

    def __init__(self, rec: "Recorder", name: str, on, call):
        self.rec, self.name, self.call = rec, name, call
        # the device only: a span keeps no tensor alive
        self.dev = on.device if on is not None and on.is_cuda else None
        self.ev0 = self.ev1 = None
        self.child_ms = 0.0

    def __enter__(self):
        stack = self.rec._stack()
        parent = stack[-1] if stack else None
        self.parent = parent
        self.parent_name = parent.name if parent is not None else None
        if self.call is None:
            self.call = (parent.call if parent is not None
                         else next(self.rec._ids))
        self.fn = _record(self.name)
        self.fn.__enter__()
        if self.dev is not None:
            self.ev0 = self.rec._event(self.dev)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.host_ns = time.perf_counter_ns() - self.t0
        if self.ev0 is not None:
            self.ev1 = self.rec._event(self.dev)
        self.fn.__exit__(None, None, None)
        self.fn = None
        stack = self.rec._stack()
        stack.pop()
        self.rec._close(self, root=not stack)
        return False


class Recorder:
    """Span and counter totals of one process (``span``, ``add`` and the
    rest of this module act on one shared instance)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._depth = 0              # open ``recording()`` contexts
        self._free: Dict[int, list] = collections.defaultdict(list)
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._pending: collections.deque = collections.deque()
            # name → [calls, host ns, calls with events, device ms, self ms]
            self._totals: Dict[str, list] = {}
            self._counters: Dict[str, int] = {}
            self._calls: "collections.OrderedDict[int, list]" = \
                collections.OrderedDict()

    @contextlib.contextmanager
    def recording(self):
        """Record spans and counters inside the block, profiler or not."""
        with self._lock:
            self._depth += 1
        try:
            yield self
        finally:
            with self._lock:
                self._depth -= 1

    def span(self, name: str, on: Optional[torch.Tensor] = None, *,
             call: Optional[int] = None):
        """A context that records ``name`` while recording is on; ``on``
        is a tensor the span's work runs beside (its device decides
        whether device time is taken); ``call`` a forward's call id for a
        span in its backward."""
        if not (self._depth or _profiler_enabled()):
            return _OFF
        return _Span(self, name, on, call)

    def add(self, name: str, n: int) -> None:
        """Add the host integer ``n`` to the counter ``name``."""
        if not (self._depth or _profiler_enabled()):
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def current_call(self) -> Optional[int]:
        """The call id of the innermost open span of this thread, or
        ``None`` where none is open."""
        stack = getattr(self._local, "stack", None)
        return stack[-1].call if stack else None

    def summary(self) -> dict:
        """``{"spans": {name: {"calls", "host_ms", "device_ms",
        "device_self_ms"}}, "counters": {name: total}}``, after waiting
        for every span's events."""
        with self._lock:
            self._fold(wait=True)
            spans = {n: {"calls": c, "host_ms": h / 1e6,
                         "device_ms": d if dc else None,
                         "device_self_ms": s if dc else None}
                     for n, (c, h, dc, d, s) in self._totals.items()}
            return {"spans": spans, "counters": dict(self._counters)}

    def calls(self) -> List[dict]:
        """The span records of the last ``KEEP_CALLS`` calls, oldest
        first: ``{"call": id, "spans": [{"name", "parent", "host_ms",
        "device_ms", "device_self_ms"}, ...]}``, each call's spans in the
        order they closed."""
        with self._lock:
            self._fold(wait=True)
            return [{"call": c, "spans": [dict(r) for r in recs]}
                    for c, recs in self._calls.items()]

    # -- internals ----------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event(self, device: torch.device):
        """A timing event recorded now on ``device``'s current stream."""
        with self._lock:
            free = self._free[device.index]
            ev = free.pop() if free else None
        if ev is None:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def _close(self, s: _Span, root: bool) -> None:
        with self._lock:
            self._pending.append(s)
            if root:
                self._fold(wait=False)

    def _fold(self, wait: bool) -> None:
        """Fold closed spans into the totals, oldest first, up to the
        first whose end event has not completed (all of them with
        ``wait``)."""
        while self._pending:
            s = self._pending[0]
            if s.ev1 is not None:
                if wait:
                    s.ev1.synchronize()
                elif not s.ev1.query():
                    return
            self._pending.popleft()
            self._fold_one(s)

    def _fold_one(self, s: _Span) -> None:
        dev = self_ms = None
        if s.ev1 is not None:
            dev = s.ev0.elapsed_time(s.ev1)
            self_ms = dev - s.child_ms
            if s.parent is not None:
                s.parent.child_ms += dev
            self._free[s.dev.index].extend((s.ev0, s.ev1))
            s.ev0 = s.ev1 = None
        s.parent = None
        t = self._totals.setdefault(s.name, [0, 0, 0, 0.0, 0.0])
        t[0] += 1
        t[1] += s.host_ns
        if dev is not None:
            t[2] += 1
            t[3] += dev
            t[4] += self_ms
        recs = self._calls.get(s.call)
        if recs is None:
            recs = self._calls[s.call] = []
            while len(self._calls) > KEEP_CALLS:
                self._calls.popitem(last=False)
        recs.append({"name": s.name, "parent": s.parent_name,
                     "host_ms": s.host_ns / 1e6, "device_ms": dev,
                     "device_self_ms": self_ms})


_RECORDER = Recorder()

span = _RECORDER.span
add = _RECORDER.add
recording = _RECORDER.recording
current_call = _RECORDER.current_call
summary = _RECORDER.summary
calls = _RECORDER.calls
reset = _RECORDER.reset

__all__ = ["KEEP_CALLS", "Recorder", "add", "calls", "current_call",
           "recording", "reset", "span", "summary"]
