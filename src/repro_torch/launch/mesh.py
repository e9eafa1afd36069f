"""The storage tier's ``data`` mesh on ``torch.distributed``.

The JAX package's ``make_data_mesh(n)`` is a 1-D ``data`` mesh over n
devices of one process, and its sharded dataflows are ``shard_map`` bodies.
Here the same axis is a process group of n ranks, one per shard, and every
rank runs the body's per-shard view: its own ``(1, part, F)`` table slice
and its own ``(1, R, K)`` request blocks.

``spawn(fn, n, ...)`` starts n local ranks and returns what ``fn(mesh,
*args)`` returned on each. The backend is the caller's choice and nothing
switches it:

* ``"nccl"`` needs one card per rank and raises otherwise (NCCL refuses
  two ranks on one card);
* ``"gloo"`` runs CPU ranks, or ranks that share a card: with CUDA tensors
  every collective is staged through pinned host memory in one place,
  ``DataMesh.run``, which counts the staged calls, bytes and seconds in
  ``DataMesh.staged``. A staged collective measures host memory and the
  loopback, not an interconnect.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import multiprocessing.connection
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")
AXIS = "data"

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class StagingStats:
    """Collectives a ``gloo`` mesh staged through host memory: calls, the
    bytes copied device → host and back, and the host seconds spent from
    the first copy to the last (the collective itself included)."""
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0


@dataclasses.dataclass(eq=False)
class DataMesh:
    """One rank's handle on the ``data`` axis: the process group, this
    rank, the axis size, the device this rank's tensors live on and the
    backend. ``shape`` reads as a JAX mesh's does."""
    group: Any
    rank: int
    size: int
    device: torch.device
    backend: str
    staged: StagingStats = dataclasses.field(default_factory=StagingStats)

    @property
    def shape(self):
        return {AXIS: self.size}

    def shard(self, tree):
        """This rank's ``[rank:rank + 1]`` slice of every leaf of a dict of
        arrays or tensors whose leading dimension is the axis size (a
        ``GraphBatchStream`` batch, a ``(P, part, F)`` table)."""
        if isinstance(tree, dict):
            return {k: self.shard(v) for k, v in tree.items()}
        if tree.shape[0] != self.size:
            raise ValueError(f"leading dimension {tree.shape[0]} is not the "
                             f"axis size {self.size}")
        return tree[self.rank:self.rank + 1]

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def run(self, collective: Callable, out: torch.Tensor,
            inp: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Issue ``collective(out, inp)`` (or ``collective(out)`` in place)
        on this group and return ``out``. The one place a ``gloo`` mesh
        stages CUDA tensors through pinned host memory."""
        if self.backend != "gloo" or out.device.type != "cuda":
            if inp is None:
                collective(out)
            else:
                collective(out, inp)
            return out
        torch.cuda.synchronize(out.device)
        t0 = time.perf_counter()
        h_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        moved = 2 * out.nbytes
        if inp is None:
            h_out.copy_(out)
            collective(h_out)
        else:
            h_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
            h_in.copy_(inp)
            moved = inp.nbytes + out.nbytes
            collective(h_out, h_in)
        out.copy_(h_out)
        self.staged.calls += 1
        self.staged.bytes += moved
        self.staged.seconds += time.perf_counter() - t0
        return out


def _check_nccl(n: int, device: DeviceLike) -> None:
    if torch.device(device).type != "cuda":
        raise ValueError("backend='nccl' runs on the card: pass "
                         "device='cuda', or backend='gloo' for CPU ranks")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < n:
        raise RuntimeError(
            f"backend='nccl' needs one card per rank: {n} ranks, {cards} "
            f"card(s). NCCL refuses two ranks on one card; pass "
            f"backend='gloo' to run the ranks on a shared card with every "
            f"collective staged through host memory")


def make_data_mesh(n: int, *, backend: str, device: DeviceLike) -> DataMesh:
    """The 1-D storage-tier mesh of this process's default group, which
    must already hold ``n`` ranks of ``backend`` (``spawn`` starts them).
    Under ``"nccl"`` rank r works on ``cuda:r``; under ``"gloo"`` every
    rank works on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "nccl":
        _check_nccl(n, device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with "
                           "repro_torch.launch.mesh.spawn (or call "
                           "torch.distributed.init_process_group first)")
    if dist.get_world_size() != n:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, not {n}")
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not {backend!r}")
    rank = dist.get_rank()
    dev = resolve_device(device)
    if backend == "nccl":
        dev = torch.device("cuda", rank)
    elif dev.type == "cuda" and rank == 0:
        _log.warning("data mesh: gloo over %d ranks on %s; every "
                     "collective is staged through pinned host memory", n,
                     dev)
    return DataMesh(dist.group.WORLD, rank, n, dev, backend)


# ---------------------------------------------------------------------------
# local ranks
# ---------------------------------------------------------------------------

def _rank_main(fn, rank: int, n: int, backend: str, device: str, work: str,
               timeout_s: float, args: Sequence) -> None:
    """One rank: join the group through the shared ``FileStore``, run
    ``fn(mesh, *args)`` and leave its result (or its traceback) in
    ``work``."""
    torch.set_num_threads(1)      # n ranks share the host's cores
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        store = dist.FileStore(os.path.join(work, "store"), n)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(make_data_mesh(n, backend=backend, device=device), *args)
        tmp = os.path.join(work, f"rank{rank}.pkl.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, os.path.join(work, f"rank{rank}.pkl"))
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    dist.destroy_process_group()


def _failure(work: str, rank: int, code: Optional[int]) -> str:
    path = os.path.join(work, f"rank{rank}.err")
    tb = "(no traceback)\n"
    if os.path.exists(path):
        with open(path) as f:
            tb = f.read()
    return f"rank {rank} failed (exit code {code}):\n{tb}"


def spawn(fn: Callable, n: int, *, backend: str, device: DeviceLike,
          timeout_s: float, args: Sequence = ()) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``n`` local ranks and return their
    results in rank order.

    The ranks start through ``torch.multiprocessing``'s spawn context, so
    ``fn``, ``args`` and the results are pickled: ``fn`` is a module-level
    function and the results are host values. They meet through a
    ``FileStore`` in a temporary directory (no port to race for), and
    their collectives time out after ``timeout_s``. When a rank fails,
    the others are killed and this raises with the failed rank's
    traceback; when ``timeout_s`` passes first, every rank is killed and
    this raises ``TimeoutError``.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "nccl":
        _check_nccl(n, device)
    ctx = torch.multiprocessing.get_context("spawn")
    work = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    procs = []
    try:
        for r in range(n):
            p = ctx.Process(target=_rank_main, name=f"rank{r}",
                            args=(fn, r, n, backend, str(device), work,
                                  timeout_s, tuple(args)))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout_s
        live = list(procs)
        while live:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {[procs.index(p) for p in live]} of {n} still "
                    f"running after {timeout_s} s")
            multiprocessing.connection.wait([p.sentinel for p in live],
                                            timeout=left)
            for p in list(live):
                if p.exitcode is None:
                    continue
                live.remove(p)
                if p.exitcode != 0:
                    raise RuntimeError(_failure(work, procs.index(p),
                                                p.exitcode))
        outs = []
        for r in range(n):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
        shutil.rmtree(work, ignore_errors=True)


def host(x):
    """A tensor (or a dict of them) as numpy on the host — the form a
    rank's result takes back through ``spawn``."""
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)
