"""What the metric files under ``perfbench/metrics`` read, shared.

A reader gets the run's ``Context`` and returns a number, or ``None``
where the run has nothing for it to read (no trace, another unit of work,
a kernel the trace does not show): the harness then leaves the metric out
of the line. A share of a roofline or of a peak is never made up as 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from harness import peaks
from harness.trace import Trace


@dataclasses.dataclass
class Context:
    unit: str                 # what one call of the window does
    units: int                # calls completed in the window
    window_s: float           # the window on the host clock
    setup_s: float
    counts: dict              # operations and bytes of one call
    trace: Optional[Trace]    # the traced window (``--trace 1``)


def per_unit_ms(ctx: Context, unit: str):
    """Host-clock milliseconds per call, for a run whose calls are
    ``unit``s."""
    if ctx.unit != unit or ctx.units == 0:
        return None
    return 1e3 * ctx.window_s / ctx.units


def mfu(ctx: Context):
    """The model's operations over the traced window, as a share (%) of
    the card's float32 peak."""
    if ctx.trace is None or "flops" not in ctx.counts:
        return None
    return (100.0 * ctx.counts["flops"] * ctx.units
            / (ctx.trace.window_s * peaks.PEAK_FLOPS_F32))


def roofline(ctx: Context, symbol: str, bytes_key: str):
    """The least time the bytes of ``bytes_key`` take at the card's
    memory bandwidth, as a share (%) of the device time of the kernels
    named ``symbol`` in the traced window."""
    if ctx.trace is None or bytes_key not in ctx.counts:
        return None
    busy = ctx.trace.kernel_s(symbol)
    if busy <= 0:
        return None
    bound = ctx.counts[bytes_key] * ctx.units / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / busy


def idle(ctx: Context):
    """The share (%) of the traced window that no device interval
    covers."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def launches(ctx: Context):
    """Device kernels launched in the traced window per call."""
    if ctx.trace is None or ctx.units == 0:
        return None
    return ctx.trace.launches() / ctx.units
