"""Checkpointing: atomic, async, and on the JAX package's on-disk layout.

Layout: ``<dir>/step_<N>/arrays.npz`` (one array per leaf, keyed by its
``/``-joined dict path, e.g. ``opt/m/w0``) + ``manifest.json`` (step, and
each leaf's key, shape and dtype). Commit protocol: write into
``.tmp_step_<N>``, fsync the manifest, ``os.replace`` into place — a crash
mid-save never corrupts the latest checkpoint. Retention keeps the newest
K. The layout and the keys are ``repro.checkpoint.manager``'s, so a
training state saved by either package restores in the other.

Async: ``save_async`` copies the state to host memory synchronously and
writes in a daemon thread; ``wait()`` joins before the next save or exit.

On a sharded ``DataMesh`` the training state is replicated: rank 0 writes
it, every rank restores it, and a barrier sits around both, so no rank
reads a step another is still writing. On a named-axis ``Mesh`` (the
sharded LM) each rank holds blocks: ``save(spec_tree=)`` gathers every
leaf to its full shape and rank 0 writes the same layout, so a sharded
checkpoint still crosses between the packages; ``restore(mesh=,
spec_tree=)`` gives each rank its block under ``common.logical
.to_physical`` — of any mesh, so a state saved on (4, 2) restores on
(2, 4) or on one device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import List, Optional

import numpy as np
import torch

from repro_torch.common.logical import (gather_leaf, local_block,
                                        spec_leaves, to_physical)
from repro_torch.common.tree import leaves_with_paths, unflatten
from repro_torch.core.cgtrans import is_sharded
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import Mesh

_SEP = "/"


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _to_host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, mesh=None):
        self.dir = directory
        self.keep = keep
        if isinstance(mesh, Mesh):
            self.mesh = mesh if mesh.size > 1 else None
        else:
            self.mesh = mesh if is_sharded(mesh) else None
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    @property
    def _writes(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    # --- write ---------------------------------------------------------

    def save(self, state, step: int, *, spec_tree=None) -> str:
        """Write ``state`` as step ``step``. On a named-axis ``Mesh``,
        ``spec_tree`` (the state's logical specs) says how each leaf is
        sharded; every rank calls this, and rank 0 writes."""
        self._barrier()
        path = os.path.join(self.dir, f"step_{step}")
        full = self._full(state, spec_tree)
        if self._writes:
            path = self._write(self._snapshot(full), step)
        self._barrier()
        return path

    def save_async(self, state, step: int, *, spec_tree=None) -> None:
        self.wait()
        full = self._full(state, spec_tree)
        if self._writes:
            self._thread = threading.Thread(
                target=self._write, args=(self._snapshot(full), step),
                daemon=True)
            self._thread.start()

    def _full(self, state, spec_tree):
        """The state with every leaf at its full shape: on a named-axis
        mesh each gathered under its spec (a collective on every rank)."""
        if not isinstance(self.mesh, Mesh):
            return state
        if spec_tree is None:
            raise ValueError("save on a named-axis Mesh needs spec_tree= "
                             "(the state's logical specs)")
        specs = dict(spec_leaves(spec_tree))
        full = [gather_leaf(leaf, to_physical(specs[path], self.mesh),
                            self.mesh)
                if torch.is_tensor(leaf) else leaf
                for path, leaf in leaves_with_paths(state)]
        return unflatten(state, full)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._barrier()

    @staticmethod
    def _snapshot(state):
        return [(_key(p), _to_host(leaf))
                for p, leaf in leaves_with_paths(state)]

    def _write(self, leaves, step: int) -> str:
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **dict(leaves))
        manifest = {
            "step": step,
            "leaves": [{"key": k, "shape": list(v.shape),
                        "dtype": str(v.dtype)} for k, v in leaves],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._retain()
        return final

    def _retain(self) -> None:
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --- read ----------------------------------------------------------

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            path = os.path.join(self.dir, name)
            if (name.startswith("step_") and os.path.isdir(path)
                    and os.path.exists(os.path.join(path, "manifest.json"))):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None, *,
                device: Optional[DeviceLike] = None, mesh=None,
                spec_tree=None):
        """Restore into the structure of ``template`` (a tree of tensors or
        arrays at their full shapes). Returns (state, step). Each leaf lands
        on ``device``, or, with ``device=None``, on its template tensor's
        device (on a mesh: the mesh's device); the stored dtype is kept.
        With a named-axis ``mesh`` and ``spec_tree`` (the leaves' logical
        specs) each rank keeps its block of every leaf under
        ``to_physical(spec, mesh)`` — any mesh, not only the one that
        saved."""
        if (mesh is None) != (spec_tree is None):
            raise ValueError("restore takes mesh= and spec_tree= together")
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh={type(mesh).__name__}: sharded restore "
                            f"places blocks on a repro_torch.launch.mesh"
                            f".Mesh")
        specs = dict(spec_leaves(spec_tree)) if mesh is not None else {}
        if mesh is not None and device is None:
            device = mesh.device
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        dev = None if device is None else resolve_device(device)
        with np.load(os.path.join(self.dir, f"step_{step}",
                                  "arrays.npz")) as arrays:
            placed = []
            for path, like in leaves_with_paths(template):
                where = dev
                if where is None:
                    if not torch.is_tensor(like):
                        raise ValueError(
                            f"template leaf {_key(path)} is not a tensor; "
                            f"pass device= to place it")
                    where = like.device
                arr = arrays[_key(path)]
                if mesh is not None:
                    # this rank's block, copied (a 0-d leaf stays 0-d)
                    arr = np.array(local_block(
                        arr, to_physical(specs[path], mesh), mesh),
                        order="C")
                placed.append(torch.from_numpy(arr).to(where))
        self._barrier()
        return unflatten(template, placed), step
