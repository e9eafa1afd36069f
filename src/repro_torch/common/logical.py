"""Logical → physical axis mapping (MaxText-style logical axis rules).

The port's copy of the JAX package's rule table. Schemas annotate each
parameter dimension with a *logical* axis name; the table maps it to a
tuple of physical mesh axes, and resolution drops the axes the mesh does
not have, so one schema is valid on one device, a ``(data, model)`` mesh
and a ``(pod, data, model)`` mesh alike — which is what makes restoring a
checkpoint on another mesh (``checkpoint.manager``) a matter of taking
other blocks.

A physical spec is a plain tuple with one entry per dimension: ``None``
(replicated), one axis name, or a tuple of names (the dimension split
over their product, the first name major). It does the job of JAX's
``PartitionSpec``. ``local_block`` is this rank's block of a full leaf
under a spec, and ``gather_leaf`` its inverse, a gather of the blocks back
to the full leaf.

The mesh is ``repro_torch.launch.mesh.Mesh``: ranks of one
``torch.distributed`` group, one per device of the JAX mesh. On the card
the P ranks of a mesh can share one H100 as gloo ranks, each collective
staged through host memory (``launch/mesh.py``): such a run checks the
sharded arithmetic and counts its collectives, and measures no
interconnect.
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Optional, Tuple, Union

LogicalAxis = Optional[Union[str, Tuple[str, ...]]]
LogicalSpec = Tuple[LogicalAxis, ...]
PhysicalAxis = Optional[Union[str, Tuple[str, ...]]]
PhysicalSpec = Tuple[PhysicalAxis, ...]

# The JAX package's table, entry for entry. Each logical axis maps to an
# ordered tuple of physical axes; resolution keeps the ones in the mesh.
DEFAULT_RULES: dict = {
    # activation axes
    "batch": ("pod", "data"),          # DP over pod and data
    "seq": (),                         # sequence replicated by default
    "seq_shard": ("data",),            # SP: long-context sequence over data
    "seq_kv": ("model",),              # decode KV-cache seq dim
    "act_heads": ("model",),           # activation head dim over TP
    "act_ff": ("model",),
    # parameter axes: the contraction ("embed") dim over data (ZeRO-3:
    # parameters and optimiser state divide by the whole mesh) and the
    # output dim over model (TP)
    "embed": ("data",),                # ZeRO-3 axis of every weight matrix
    "vocab": ("model",),               # embedding tables over TP (CGTrans)
    "heads": ("model",),               # attention heads over TP
    "kv_heads": ("model",),            # GQA kv heads over TP
    "ff": ("model",),                  # MLP hidden over TP
    "experts": ("model",),             # EP: experts over the TP axis
    "lru": ("model",),                 # RG-LRU width over TP
    "ssm_heads": ("model",),           # mamba2 heads over TP
    "layers": (),                      # stacked layer dim never sharded
    # graph engine axes
    "graph_part": ("data",),           # vertex / edge partitions
    "feature": ("model",),             # vertex feature dim over TP
}


def resolve_axis(axis: LogicalAxis, mesh_axes: Iterable[str], rules=None):
    """One logical axis as the physical axes of ``mesh_axes`` it maps to:
    ``None``, one name, or a tuple of names."""
    rules = rules or DEFAULT_RULES
    if axis is None:
        return None
    mesh_axes = tuple(mesh_axes)
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    phys: list = []
    for name in names:
        for p in rules.get(name, ()):  # unknown logical name → replicated
            if p in mesh_axes and p not in phys:
                phys.append(p)
    if not phys:
        return None
    return phys[0] if len(phys) == 1 else tuple(phys)


def to_physical(spec: LogicalSpec, mesh, rules=None) -> PhysicalSpec:
    """A logical spec as a physical spec for ``mesh`` (anything with
    ``axis_names``). A physical axis serves one dimension at most: the
    first logical dim to claim it wins and later dims drop it."""
    mesh_axes = tuple(mesh.axis_names)
    used: set = set()
    out = []
    for axis in spec:
        phys = resolve_axis(axis, mesh_axes, rules)
        if phys is None:
            out.append(None)
            continue
        cand = (phys,) if isinstance(phys, str) else tuple(phys)
        cand = tuple(a for a in cand if a not in used)
        used.update(cand)
        if not cand:
            out.append(None)
        elif len(cand) == 1:
            out.append(cand[0])
        else:
            out.append(cand)
    return tuple(out)


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def tree_to_physical(spec_tree, mesh, rules=None):
    """A tree (nested dicts, or lists) of logical specs as physical
    specs."""
    if _is_spec(spec_tree):
        return to_physical(spec_tree, mesh, rules)
    if isinstance(spec_tree, dict):
        return {k: tree_to_physical(v, mesh, rules)
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [tree_to_physical(v, mesh, rules) for v in spec_tree]
    raise TypeError(f"not a spec tree leaf: {spec_tree!r}")


def spec_leaves(spec_tree, prefix: tuple = ()):
    """(key path, spec) of every spec of a tree of specs, dict keys
    sorted at every level (the order ``common.tree`` walks a tree)."""
    if _is_spec(spec_tree):
        return [(prefix, spec_tree)]
    if isinstance(spec_tree, dict):
        return [item for k in sorted(spec_tree)
                for item in spec_leaves(spec_tree[k], (*prefix, k))]
    return [item for i, v in enumerate(spec_tree)
            for item in spec_leaves(v, (*prefix, i))]


def batch_axes(mesh, rules=None) -> tuple:
    """The physical axes the logical ``"batch"`` axis resolves to on this
    mesh under ``rules`` (default ``DEFAULT_RULES``: ``("pod", "data")``
    where present; a long-context table's ``batch=()``: none, so every
    rank holds the whole batch)."""
    return axes_of(resolve_axis("batch", mesh.axis_names, rules))


def dp_size(mesh, rules=None) -> int:
    """How many ranks split the batch under ``rules``."""
    return math.prod(mesh.shape[a] for a in batch_axes(mesh, rules))


def axes_of(entry: PhysicalAxis) -> Tuple[str, ...]:
    """The axis names of one physical spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: PhysicalSpec) -> Tuple[str, ...]:
    """Every axis a physical spec shards over."""
    return tuple(a for entry in spec for a in axes_of(entry))


def replication(spec: PhysicalSpec, mesh) -> int:
    """How many ranks hold each element of a leaf under ``spec``: the
    product of the sizes of the mesh axes the spec does not use."""
    used = set(spec_axes(spec))
    return math.prod(n for a, n in mesh.shape.items() if a not in used)


def local_shape(shape, spec: PhysicalSpec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a leaf of ``shape``."""
    if len(shape) != len(spec):
        raise ValueError(f"spec {spec} does not match the rank of "
                         f"shape {tuple(shape)}")
    out = []
    for d, entry in zip(shape, spec):
        n = math.prod(mesh.shape[a] for a in axes_of(entry))
        if d % n:
            raise ValueError(f"dimension {d} of shape {tuple(shape)} does "
                             f"not split evenly over {entry} ({n} ranks)")
        out.append(d // n)
    return tuple(out)


def local_block(full: Any, spec: PhysicalSpec, mesh):
    """This rank's block of ``full`` (a tensor or a numpy array) under
    ``spec``: along each sharded dimension, block ``mesh.axis_index(axes)``
    of ``n`` equal blocks. Every dimension must split evenly."""
    shape = local_shape(tuple(full.shape), spec, mesh)
    index = []
    for d, entry in zip(shape, spec):
        if entry is None:
            index.append(slice(None))
        else:
            i = mesh.axis_index(axes_of(entry))
            index.append(slice(i * d, (i + 1) * d))
    return full[tuple(index)]


def gather_leaf(block, spec: PhysicalSpec, mesh, *,
                name: str = "result_gather"):
    """The full leaf from every rank's ``block`` under ``spec`` (the
    inverse of ``local_block``): one all-gather per sharded dimension,
    counted under ``name``; no gradient. Every rank of the mesh calls it."""
    import torch

    from repro_torch.core import collectives

    out = block.detach()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        moved = out.movedim(dim, 0).contiguous()
        parts = collectives.all_gather(moved, mesh, axis=axes_of(entry),
                                       name=name)
        out = parts.reshape((-1,) + tuple(moved.shape[1:])).movedim(0, dim)
    return out.contiguous() if torch.is_tensor(out) else out
