"""The port's meshes on ``torch.distributed``: the storage tier's 1-D
``data`` mesh and the LM's named-axis mesh.

The JAX package's ``make_data_mesh(n)`` is a 1-D ``data`` mesh over n
devices of one process, and its sharded dataflows are ``shard_map`` bodies.
Here the same axis is a process group of n ranks, one per shard, and every
rank runs the body's per-shard view: its own ``(1, part, F)`` table slice
and its own ``(1, R, K)`` request blocks (``DataMesh``).

The LM's mesh (``Mesh``, ``make_mesh``, ``make_test_mesh``) has named axes
— ``("data", "model")`` or ``("pod", "data", "model")`` — laid over the
ranks row-major, as JAX lays a mesh over its devices: rank r sits at
``np.unravel_index(r, shape)``. Each axis, and each set of axes, has one
process group per line (the ranks that differ only in those axes), made
on every rank in the same order; ``Mesh.line(axes)`` is this rank's.

``TraceMesh`` is one rank of such a mesh with no processes behind it:
collectives return without moving anything, so a rank's step can be
traced on fake tensors (``launch/dryrun.py``); ``make_production_mesh``
gives a rank of the JAX package's (16, 16) and (2, 16, 16) meshes.

``spawn(fn, n, ...)`` starts local ranks and returns what ``fn(mesh,
*args)`` returned on each: n ranks on a ``DataMesh``, or, with a shape
such as ``(2, 2)`` or ``(2, 2, 2)``, their product on a ``Mesh``. The
backend is the caller's choice and nothing switches it:

* ``"nccl"`` needs one card per rank and raises otherwise (NCCL refuses
  two ranks on one card);
* ``"gloo"`` runs CPU ranks, or ranks that share a card: with CUDA tensors
  every collective is staged through pinned host memory in one place,
  ``run``, which counts the staged calls, bytes and seconds in ``staged``.
  P gloo ranks sharing one card measure host memory and the loopback: a
  staged second is not an interconnect second, and nothing here measures
  an interconnect.
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
import itertools
import math
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")
AXIS = "data"

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class StagingStats:
    """Collectives a ``gloo`` mesh staged through host memory: calls, the
    bytes copied device → host and back, and the host seconds spent from
    the first copy to the last (the collective itself included); and the
    same three as ``[calls, bytes, seconds]`` by collective name
    (``core/collectives.py`` fills ``by_name``)."""
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    by_name: Dict[str, list] = dataclasses.field(default_factory=dict)


def _run(mesh, collective: Callable, out: torch.Tensor,
         inp: Optional[torch.Tensor], axis) -> torch.Tensor:
    """Issue ``collective(out, inp, group)`` (or ``collective(out, group)``
    in place) on this rank's line of ``axis`` and return ``out``. The one
    place a ``gloo`` mesh stages CUDA tensors through pinned host
    memory. What the backend runs to move the bytes (gloo splits and
    copies on the host) is hidden from Python dispatch modes, so a
    counted run (``launch/trace_analysis.py``) sees the program's ops on
    every backend, and a ``TraceMesh``'s."""
    with _disable_current_modes():
        return _issue(mesh, collective, out, inp, axis)


def _issue(mesh, collective, out, inp, axis) -> torch.Tensor:
    group, _ = mesh.line(axis)
    if mesh.backend != "gloo" or out.device.type != "cuda":
        if inp is None:
            collective(out, group)
        else:
            collective(out, inp, group)
        return out
    torch.cuda.synchronize(out.device)
    t0 = time.perf_counter()
    h_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    moved = 2 * out.nbytes
    if inp is None:
        h_out.copy_(out)
        collective(h_out, group)
    else:
        h_in = torch.empty(inp.shape, dtype=inp.dtype, pin_memory=True)
        h_in.copy_(inp)
        moved = inp.nbytes + out.nbytes
        collective(h_out, h_in, group)
    out.copy_(h_out)
    mesh.staged.calls += 1
    mesh.staged.bytes += moved
    mesh.staged.seconds += time.perf_counter() - t0
    return out


@dataclasses.dataclass(eq=False)
class DataMesh:
    """One rank's handle on the ``data`` axis: the process group, this
    rank, the axis size, the device this rank's tensors live on and the
    backend. ``shape`` and ``axis_names`` read as a JAX mesh's do."""
    group: Any
    rank: int
    size: int
    device: torch.device
    backend: str
    staged: StagingStats = dataclasses.field(default_factory=StagingStats)
    _named: Dict[tuple, "Mesh"] = dataclasses.field(default_factory=dict,
                                                    repr=False)

    axis_names = (AXIS,)

    @property
    def shape(self):
        return {AXIS: self.size}

    def line(self, axis=None):
        """(process group, size) of the ``data`` axis, the only one."""
        if axis not in (None, AXIS, (AXIS,)):
            raise ValueError(f"a DataMesh has the one axis {AXIS!r}, not "
                             f"{axis!r}")
        return self.group, self.size

    def axis_index(self, axis=AXIS) -> int:
        self.line(axis)
        return self.rank

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
            inp: Optional[torch.Tensor] = None, *, axis=None
            ) -> torch.Tensor:
        """``collective`` on the axis's group, staged on gloo + CUDA
        (``_run``)."""
        return _run(self, collective, out, inp, axis)

    def named(self, shape: Sequence[int],
              axis_names: Optional[Sequence[str]] = None) -> "Mesh":
        """A named-axis ``Mesh`` of ``shape`` over this mesh's ranks,
        made once per shape (its process groups are collective to make:
        every rank asks for the same meshes in the same order)."""
        key = (tuple(shape), tuple(axis_names or ()))
        if key not in self._named:
            self._named[key] = make_mesh(shape, axis_names,
                                         backend=self.backend,
                                         device=self.device)
        return self._named[key]


Axes = Union[None, str, Sequence[str]]


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's handle on a named-axis mesh (``make_mesh``): the axis
    names and sizes, this rank and its coordinates, one process group per
    set of axes (this rank's line of it), the device and the backend.
    ``shape`` (a dict) and ``axis_names`` read as a JAX mesh's do."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    backend: str
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(repr=False,
                                                          default=None)
    staged: StagingStats = dataclasses.field(default_factory=StagingStats)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def coords(self) -> Tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(self.rank,
                                                      self.axis_sizes))

    def _axes(self, axis: Axes) -> Tuple[str, ...]:
        """``axis`` as a tuple of this mesh's axes in mesh order (``None``
        is every axis)."""
        if axis is None:
            return self.axis_names
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown or not axes:
            raise ValueError(f"axes {axis!r} not in the mesh's "
                             f"{self.axis_names}")
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order) or len(set(order)) != len(order):
            raise ValueError(f"axes {axis!r} must be distinct and in mesh "
                             f"order {self.axis_names}")
        return axes

    def axis_size(self, axis: Axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axis))

    def axis_index(self, axis: Axes) -> int:
        """This rank's index along ``axis``; over several axes the index
        in their flattened product, the first axis major (JAX's
        ``lax.axis_index`` of a tuple)."""
        idx = 0
        coords = dict(zip(self.axis_names, self.coords))
        for a in self._axes(axis):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def line(self, axis: Axes = None):
        """(process group, size) of this rank's line along ``axis``: the
        ranks that differ from it only in those axes, in the order of
        ``axis_index``."""
        axes = self._axes(axis)
        return self.groups[axes], self.axis_size(axes)

    def barrier(self) -> None:
        dist.barrier(group=self.groups[self.axis_names])

    def run(self, collective: Callable, out: torch.Tensor,
            inp: Optional[torch.Tensor] = None, *, axis: Axes = None
            ) -> torch.Tensor:
        """``collective`` on this rank's line of ``axis``, staged on gloo
        + CUDA (``_run``)."""
        return _run(self, collective, out, inp, axis)


@dataclasses.dataclass(eq=False)
class TraceMesh(Mesh):
    """One rank's view of a named-axis mesh with no process behind it: the
    axis names and sizes, the rank and its coordinates, ``line`` and
    ``axis_index`` as a ``Mesh`` has them, and no process group. ``run``
    returns ``out`` as the collective left it unwritten and ``barrier``
    waits for nobody, so a step traced on it (``launch/dryrun.py``) issues
    every collective of a real rank through ``core/collectives.py``, with
    the same names and bytes in ``count_collectives``, and moves nothing.
    """
    backend: str = "trace"

    def line(self, axis: Axes = None):
        """(None, size) of this rank's line along ``axis``."""
        return None, self.axis_size(self._axes(axis))

    def barrier(self) -> None:
        pass

    def run(self, collective: Callable, out: torch.Tensor,
            inp: Optional[torch.Tensor] = None, *, axis: Axes = None
            ) -> torch.Tensor:
        self.line(axis)
        return out


#: the JAX package's production meshes: one pod, and two pods
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         rank: int = 0) -> TraceMesh:
    """Rank ``rank``'s ``TraceMesh`` of the (16, 16) ``("data", "model")``
    mesh, or with ``multi_pod`` of the (2, 16, 16) ``("pod", "data",
    "model")`` one: the shapes the JAX package's dry run compiles for."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} is not on a {shape} mesh")
    return TraceMesh(names, shape, rank, torch.device("cuda"))


def check_named_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a named-axis ``Mesh`` (the LM's)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh={type(mesh).__name__}: the LM shards over a "
            f"repro_torch.launch.mesh.Mesh (make_mesh, make_test_mesh, or "
            f"spawn(fn, (n_data, n_model)))")


#: the axis names of a mesh by its rank, as the JAX package names them
DEFAULT_AXES = {1: ("data",), 2: ("data", "model"),
                3: ("pod", "data", "model")}


def _line_groups(shape: Tuple[int, ...], names: Tuple[str, ...],
                 rank: int, backend: str) -> Dict[Tuple[str, ...], Any]:
    """This rank's process group for every non-empty set of axes. Every
    rank makes every group, in the same order (``dist.new_group`` is
    collective over the whole world)."""
    ranks = np.arange(math.prod(shape)).reshape(shape)
    out: Dict[Tuple[str, ...], Any] = {}
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(range(len(names)), k):
            key = tuple(names[a] for a in axes)
            if k == len(names):
                out[key] = dist.group.WORLD
                continue
            rest = [a for a in range(len(names)) if a not in axes]
            lines = np.moveaxis(ranks, rest, list(range(len(rest))))
            lines = lines.reshape(-1, math.prod(shape[a] for a in axes))
            for members in lines:
                g = dist.new_group([int(r) for r in members],
                                   backend=backend)
                if rank in members:
                    out[key] = g
    return out


def make_mesh(shape: Sequence[int], axis_names: Optional[Sequence[str]] = None,
              *, backend: str, device: DeviceLike) -> Mesh:
    """A named-axis mesh over this process's default group, which must
    already hold ``prod(shape)`` ranks of ``backend`` (``spawn`` starts
    them). ``axis_names`` defaults to ``DEFAULT_AXES``. Under ``"nccl"``
    rank r works on ``cuda:r``; under ``"gloo"`` every rank works on
    ``device``."""
    shape = tuple(int(n) for n in shape)
    names = tuple(axis_names or DEFAULT_AXES[len(shape)])
    if len(names) != len(shape) or len(set(names)) != len(names):
        raise ValueError(f"axis names {names} do not name the {len(shape)} "
                         f"axes of shape {shape}")
    n = math.prod(shape)
    dmesh = make_data_mesh(n, backend=backend, device=device)
    return Mesh(names, shape, dmesh.rank, dmesh.device, backend,
                _line_groups(shape, names, dmesh.rank, backend))


def make_test_mesh(n_data: int = 4, n_model: int = 2, *, backend: str,
                   device: DeviceLike) -> Mesh:
    """The JAX package's small ``(data, model)`` test mesh, over the
    ``n_data * n_model`` ranks of this process's default group."""
    return make_mesh((n_data, n_model), ("data", "model"), backend=backend,
                     device=device)


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

def _rank_main(fn, rank: int, n, backend: str, device: str, work: str,
               timeout_s: float, args: Sequence, axes=None) -> None:
    """One rank: join the group through the shared ``FileStore``, run
    ``fn(mesh, *args)`` and leave its result (or its traceback) in
    ``work``."""
    torch.set_num_threads(1)      # n ranks share the host's cores
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        world = math.prod(n) if isinstance(n, tuple) else n
        store = dist.FileStore(os.path.join(work, "store"), world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        mesh = (make_mesh(n, axes, backend=backend, device=device)
                if isinstance(n, tuple)
                else make_data_mesh(n, backend=backend, device=device))
        out = fn(mesh, *args)
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


def spawn(fn: Callable, n: Union[int, Sequence[int]], *, backend: str,
          device: DeviceLike, timeout_s: float, args: Sequence = (),
          axes: Optional[Sequence[str]] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` on local ranks and return their results in
    rank order: ``n`` ranks on a ``DataMesh``, or, where ``n`` is a mesh
    shape such as ``(2, 2)``, ``prod(n)`` ranks on a ``Mesh`` of that
    shape over ``axes`` (default ``DEFAULT_AXES``).

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
    shape = tuple(int(k) for k in n) if not isinstance(n, int) else None
    n = math.prod(shape) if shape else n
    if backend == "nccl":
        _check_nccl(n, device)
    ctx = torch.multiprocessing.get_context("spawn")
    work = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    procs = []
    try:
        for r in range(n):
            p = ctx.Process(target=_rank_main, name=f"rank{r}",
                            args=(fn, r, shape or n, backend, str(device),
                                  work, timeout_s, tuple(args),
                                  tuple(axes) if axes else None))
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
    rank's result takes back through ``spawn``: a copy, so a snapshot of
    state that a train step later updates in place."""
    if isinstance(x, dict):
        return {k: host(v) for k, v in x.items()}
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)
