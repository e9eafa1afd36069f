"""What the per-layer metrics read from the program's own spans and
counters (``repro_torch.runtime.trace``), shared.

The program records while a ``torch.profiler`` session is active, so the
traced run's window is what the recorder holds; the untraced run records
nothing. Every function here returns ``None`` where the run has nothing to
read: no trace, another unit of work, a program without the recorder, a
span or counter the window did not record, or a recorder whose ``root``
span, the one the cell's entry opens once per call, did not run exactly
once per call of the window. It never makes up a 0.
"""

from __future__ import annotations

from harness.readers import Context


def _summary(ctx: Context, unit: str, root: str):
    """The recorder's summary of the window, or ``None``."""
    if ctx.trace is None or ctx.unit != unit or ctx.units == 0:
        return None
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    s = trace.summary()
    rec = s["spans"].get(root)
    if rec is None or rec["calls"] != ctx.units:
        return None
    return s


def span_ms(ctx: Context, unit: str, name: str, root: str):
    """Device milliseconds of the span ``name`` over the window, per
    call."""
    s = _summary(ctx, unit, root)
    rec = s["spans"].get(name) if s is not None else None
    if rec is None or rec["device_ms"] is None:
        return None
    return rec["device_ms"] / ctx.units


def counter(ctx: Context, unit: str, name: str, root: str):
    """The counter ``name``'s total over the window, per call."""
    s = _summary(ctx, unit, root)
    if s is None or name not in s["counters"]:
        return None
    return s["counters"][name] / ctx.units
