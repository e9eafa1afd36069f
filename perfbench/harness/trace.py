"""The traced window, reduced from ``torch.profiler``'s events.

The window is the span of the ``perfbench.window`` annotation that the
harness opens around the timed loop. Device intervals are the trace's
kernels, copies and sets (``gpu_user_annotation`` ranges, which the
profiler mirrors onto the device, are not work and are left out), clipped
to the window. Busy time is the length of their union; an idle gap is a
stretch of the window that no device interval covers, named by the
innermost host operation open at its middle.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "perfbench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 100


@dataclasses.dataclass
class Trace:
    """Intervals in ns on the profiler's clock."""
    start: int
    end: int
    device: List[Tuple[int, int, str, str]]       # (start, end, name, kind)
    host: List[Tuple[int, int, str, int]]         # (start, end, name, tid)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def merged(self) -> List[Tuple[int, int]]:
        spans = sorted((s, e) for s, e, _, _ in self.device)
        out: List[List[int]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e9

    def kernel_s(self, symbol: str) -> float:
        """Device seconds of the kernels whose name holds ``symbol``."""
        return sum(e - s for s, e, n, k in self.device
                   if k == "kernel" and symbol in n) / 1e9

    def launches(self) -> int:
        return sum(1 for *_, k in self.device if k == "kernel")

    def top_device_ops(self, k: int = 10) -> List[list]:
        total: Dict[str, int] = defaultdict(int)
        for s, e, n, _ in self.device:
            total[n[:NAME_CHARS]] += e - s
        top = sorted(total.items(), key=lambda x: -x[1])[:k]
        return [[n, t / 1e9] for n, t in top]

    def gaps(self) -> List[Tuple[int, int]]:
        out, at = [], self.start
        for s, e in self.merged():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.end > at:
            out.append((at, self.end))
        return out

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The idle time by what the host was doing: each gap's seconds
        summed under the name of the innermost host operation open at its
        middle, the ``k`` largest."""
        gaps = self.gaps()
        names = _innermost(self.host, [(s + e) // 2 for s, e in gaps])
        total: Dict[str, int] = defaultdict(int)
        for (s, e), n in zip(gaps, names):
            total[(n or "host between operations")[:NAME_CHARS]] += e - s
        top = sorted(total.items(), key=lambda x: -x[1])[:k]
        return [[n, t / 1e9] for n, t in top]


def _innermost(host, points) -> List[Optional[str]]:
    """For each point, the name of the innermost host interval holding it
    on the thread whose innermost such interval started last."""
    by_tid = defaultdict(list)
    for s, e, n, tid in host:
        by_tid[tid].append((s, -e, n))
    best: List[Tuple[int, Optional[str]]] = [(-1, None)] * len(points)
    order = sorted(range(len(points)), key=lambda i: points[i])
    for evs in by_tid.values():
        evs.sort()
        starts = [s for s, _, _ in evs]
        stack: List[Tuple[int, int, str]] = []
        j = 0
        for i in order:
            p = points[i]
            hi = bisect.bisect_right(starts, p)
            while j < hi:
                s, neg_e, n = evs[j]
                while stack and stack[-1][1] < s:
                    stack.pop()
                stack.append((s, -neg_e, n))
                j += 1
            while stack and stack[-1][1] < p:
                stack.pop()
            if stack and stack[-1][0] > best[i][0]:
                best[i] = (stack[-1][0], stack[-1][2])
    return [n for _, n in best]


def _kind(evt) -> str:
    """The event's activity: ``activity_type()`` where the build has it;
    otherwise told from the device and the name (a copy or a set on the
    device is named so by CUPTI; a user annotation mirrored onto the device
    is no work)."""
    if hasattr(evt, "activity_type"):
        return str(evt.activity_type())
    annotation = getattr(evt, "is_user_annotation", lambda: False)()
    if str(evt.device_type()) != "DeviceType.CPU":
        if annotation or evt.name() == WINDOW:
            return "gpu_user_annotation"
        name = evt.name()
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return "user_annotation" if annotation else "cpu_op"


def _span(evt) -> Tuple[int, int]:
    start = (evt.start_ns() if hasattr(evt, "start_ns")
             else int(evt.start_us() * 1000))
    if hasattr(evt, "end_ns"):
        return start, evt.end_ns()
    return start, start + (evt.duration_ns() if hasattr(evt, "duration_ns")
                           else int(evt.duration_us() * 1000))


def from_profiler(prof) -> Trace:
    """Reduce a finished ``torch.profiler.profile`` to the window's
    intervals. Raises where the window's annotation is missing."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW and _kind(e) in
           ("user_annotation", "cpu_op")]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    w0, w1 = _span(win[0])
    device, host = [], []
    for e in events:
        kind = _kind(e)
        e0, e1 = _span(e)
        s, t = max(e0, w0), min(e1, w1)
        if t <= s:
            continue
        if kind in DEVICE_KINDS:
            device.append((s, t, e.name(), kind))
        elif kind in HOST_KINDS and e.name() != WINDOW:
            host.append((e0, e1, e.name(), e.start_thread_id()))
    return Trace(w0, w1, device, host)
