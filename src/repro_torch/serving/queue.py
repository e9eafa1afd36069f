"""The serving front door's request queue: size-or-deadline batching.

Concurrent callers submit independent seed sets; the queue accumulates them
until EITHER ``max_batch`` requests are pending (size trigger — the SSD
command block is full) OR the oldest request has waited ``max_delay_s``
(deadline trigger — latency floor for a trickle of traffic). The engine
polls ``ready()`` and ``drain()``s a batch; everything drained together
fuses into ONE coalesced command block.

The clock is injectable so the deadline trigger is deterministic under
test (pass a fake monotonic counter instead of ``time.monotonic``).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, List, Optional

import numpy as np


@dataclasses.dataclass
class ServeRequest:
    """One caller's query: aggregate ``fanout`` sampled neighbors per seed.

    The neighbor sample is drawn at SUBMIT time (host CSR sampler, rng keyed
    by the request id) and travels with the request — fused and sequential
    dispatch therefore aggregate the *identical* (nbrs, mask) block, which
    is what makes fused ≡ sequential a bit-exactness claim rather than a
    statistical one.
    """
    rid: int                  # engine-assigned request id (unique)
    tenant: int               # the CALLER the results must scatter back to
    seeds: np.ndarray         # (B,) int32 query vertex ids
    nbrs: np.ndarray          # (B, K) int32 sampled neighbor ids
    mask: np.ndarray          # (B, K) bool sample validity
    enqueued_at: float        # queue clock at submit


class RequestQueue:
    """FIFO accumulator with a size-or-deadline dispatch trigger."""

    def __init__(self, *, max_batch: int = 8, max_delay_s: float = 0.005,
                 clock: Callable[[], float] = time.monotonic):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {max_delay_s}")
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.clock = clock
        self._pending: Deque[ServeRequest] = collections.deque()
        self.submitted = 0
        self.drained = 0

    def push(self, req: ServeRequest) -> None:
        self._pending.append(req)
        self.submitted += 1

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def oldest_wait(self) -> float:
        """Seconds the head-of-line request has been waiting (0 if empty)."""
        if not self._pending:
            return 0.0
        return self.clock() - self._pending[0].enqueued_at

    def ready(self) -> bool:
        """Dispatch trigger: the batch is full OR the head request's
        deadline has passed."""
        if not self._pending:
            return False
        return (len(self._pending) >= self.max_batch
                or self.oldest_wait >= self.max_delay_s)

    def drain(self, limit: Optional[int] = None) -> List[ServeRequest]:
        """Pop up to ``limit`` (default ``max_batch``) requests, FIFO."""
        n = min(len(self._pending),
                self.max_batch if limit is None else limit)
        out = [self._pending.popleft() for _ in range(n)]
        self.drained += len(out)
        return out

    def drain_all(self) -> List[ServeRequest]:
        return self.drain(limit=len(self._pending))
