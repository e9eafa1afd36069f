"""Fault-tolerant training loop.

Restart semantics: on entry the loop restores the newest committed
checkpoint (if any) and resumes from its step; the batch stream is
stateless-indexable, so fast-forwarding it realigns the data exactly.
SIGTERM (preemption) triggers a final synchronous checkpoint before exit.
Straggler steps are flagged by the ``StepMonitor`` and logged.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.common.tree import leaves
from repro_torch.runtime import PreemptionGuard, StepMonitor


def _block_until_ready(x) -> None:
    """Wait for the device work behind ``x`` (a tensor) to finish."""
    if torch.is_tensor(x) and x.is_cuda:
        torch.cuda.synchronize(x.device)


def train_loop(
    *,
    step_fn: Callable,
    state,
    batches: Iterable[Dict[str, np.ndarray]],
    total_steps: int,
    ckpt: Optional[CheckpointManager] = None,
    ckpt_every: int = 100,
    log_every: int = 10,
    monitor: Optional[StepMonitor] = None,
    guard: Optional[PreemptionGuard] = None,
    log_fn: Callable[[str], None] = print,
):
    """Runs to total_steps (resuming if a checkpoint exists). Returns
    (state, steps done)."""
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(state)
        log_fn(f"[resume] restored checkpoint at step {start_step}")

    monitor = monitor or StepMonitor()
    it = iter(batches)
    # fast-forward the (stateless) stream
    for _ in range(start_step):
        next(it)

    step = start_step
    for step in range(start_step, total_steps):
        batch = next(it)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        _block_until_ready(metrics["total_loss"] if "total_loss" in metrics
                           else leaves(metrics)[0])
        dt = time.perf_counter() - t0
        straggler = monitor.record(step, dt)
        if straggler:
            log_fn(f"[straggler] step {step} took {dt * 1e3:.1f} ms "
                   f"(ewma {monitor.snapshot()['ewma_s'] * 1e3:.1f} ms)")
        if log_every and step % log_every == 0:
            loss = float(metrics.get("total_loss",
                                     metrics.get("loss", np.nan)))
            log_fn(f"step {step:5d} loss {loss:8.4f} dt {dt * 1e3:7.1f} ms")
        done = step + 1
        if ckpt is not None and (done % ckpt_every == 0
                                 or done == total_steps):
            ckpt.save_async(state, done)
        if guard is not None and guard.should_exit:
            log_fn(f"[preempt] SIGTERM at step {done}; checkpointing and "
                   f"exiting")
            if ckpt is not None:
                ckpt.wait()
                ckpt.save(state, done)
            return state, done
    if ckpt is not None:
        ckpt.wait()
    return state, step + 1
