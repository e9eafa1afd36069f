"""The trace's reduction: busy time as the union of device intervals,
idle gaps named by the innermost host operation open at their middle,
launches and a kernel's device time; and a real profiler's window."""

import pytest
import torch

from harness import readers
from harness.trace import WINDOW, Trace, from_profiler


def _trace():
    # window [0, 100); kernels [10, 30) and [20, 40) overlap, a copy
    # [60, 70), kernel [90, 120) clipped to [90, 100)
    device = [(10, 30, "banded_cluster_kernel<float>", "kernel"),
              (20, 40, "dense_cluster_kernel<float>", "kernel"),
              (60, 70, "Memcpy HtoD", "gpu_memcpy"),
              (90, 100, "banded_cluster_kernel<float>", "kernel")]
    host = [(0, 100, "step", 1), (40, 62, "aten::sort", 1),
            (45, 50, "cudaLaunchKernel", 1), (70, 95, "aten::cat", 2)]
    return Trace(0, 100, device, host)


def test_busy_gaps_and_launches():
    t = _trace()
    assert t.merged() == [(10, 40), (60, 70), (90, 100)]
    assert t.busy_s() == pytest.approx(50e-9)
    assert t.gaps() == [(0, 10), (40, 60), (70, 90)]
    assert t.launches() == 3
    assert t.kernel_s("banded_cluster_kernel") == pytest.approx(30e-9)
    assert t.top_device_ops()[0] == ["banded_cluster_kernel<float>",
                                     pytest.approx(30e-9)]


def test_idle_gaps_are_named_by_the_innermost_open_operation():
    # gap (0, 10): only "step"; (40, 60): middle 50 inside aten::sort
    # (cudaLaunchKernel ended at 50: still open at 50); (70, 90): "step"
    # on thread 1 started at 0, aten::cat on thread 2 at 70 — the later
    got = dict((n, s) for n, s in _trace().idle_gaps())
    assert got == {"step": pytest.approx(10e-9),
                   "cudaLaunchKernel": pytest.approx(20e-9),
                   "aten::cat": pytest.approx(20e-9)}


def test_readers_leave_out_what_the_trace_lacks():
    t = _trace()
    ctx = readers.Context("forward", 2, 1.0, 3.0,
                          {"flops": 67e12 * 1e-7, "banded_bytes": 3.35e12
                           * 1e-8}, t)
    assert readers.idle(ctx) == pytest.approx(50.0)
    assert readers.launches(ctx) == 1.5
    # bound 2 × 1e-8 s against 30 ns of banded time
    assert readers.roofline(ctx, "banded_cluster_kernel", "banded_bytes") \
        == pytest.approx(100 * 2e-8 / 30e-9)
    assert readers.roofline(ctx, "nowhere_kernel", "banded_bytes") is None
    assert readers.roofline(ctx, "banded_cluster_kernel", "dense_bytes") \
        is None
    untraced = readers.Context("forward", 2, 1.0, 3.0, {"flops": 1.0}, None)
    assert readers.mfu(untraced) is None and readers.idle(untraced) is None
    assert readers.per_unit_ms(untraced, "forward") == 500.0
    assert readers.per_unit_ms(untraced, "step") is None


def test_a_profiled_window_is_found():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(WINDOW):
            torch.sort(torch.randn(1000))
    t = from_profiler(prof)
    assert t.window_s > 0 and t.device == []
    assert any("sort" in n for _, _, n, _ in t.host)
    assert t.idle_gaps()[0][1] == pytest.approx(t.window_s)
