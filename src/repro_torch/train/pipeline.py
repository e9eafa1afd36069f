"""Training pipelines: the graph workload's step and GPipe stage
parallelism.

``pipelined_apply`` runs a stack of blocks as a pipeline over the ``pod``
axis of a ``launch.mesh.Mesh`` (the JAX package's fill–drain GPipe
schedule): stages are contiguous block ranges (``split_stages``), the
boundary transfer is a ``ppermute`` to the next stage, microbatches
stream through ``n_micro + n_stages - 1`` ticks, and the last stage's
outputs are psum'd to every pod. Autograd differentiates through the
ppermute and the psum, which gives the reverse schedule.

The graph workload's training step: GraphSAGE + CGTrans loss, gradients
and AdamW against an owner-sharded feature table.

``make_sage_train_step`` is the JAX package's function of the same name:
the FAST-GAS knobs ride in on the ``GCNConfig`` (``impl``,
``request_chunk``, ``scheduled``, ``coalesce``) and the step differentiates
the parameters only, with the feature table closed over — so its GAS
kernels run in the forward, and its backward is the dense layers.
Differentiating the table (``feats.requires_grad_()`` through
``sage_loss``) runs the GAS backward rules (``repro_torch.core.gas``).

On a sharded ``mesh`` each rank steps on its own slice of the table and of
the batch, and the parameter gradients meet in ONE ``all_reduce`` of a
flat buffer (counted as ``grad_all_reduce``: GSPMD's reduction in the JAX
step, which its traced program does not show). AdamW, the clip and
``int8_ef`` then run identically on every rank, so the state stays
replicated.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.common.config import TrainConfig
from repro_torch.common.tree import leaves_with_paths, tree_map, unflatten
from repro_torch.core import cgtrans, collectives, gcn
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import adamw_update


def make_sage_train_step(cfg: gcn.GCNConfig, tc: TrainConfig, *,
                         feats: torch.Tensor, mesh=None,
                         relabel=None) -> Callable:
    """(state, batch) → (state, metrics) for GraphSAGE + CGTrans training.

    ``feats`` is the (P, part, F) feature table on the device the step runs
    on (on a sharded ``mesh``: this rank's ``(1, part, F)`` slice, and
    each batch this rank's ``mesh.shard(batch)``); ``state`` is
    ``{"params", "opt", "step"}`` (``adamw_init`` makes the optimiser
    state, ``step`` is an int32 scalar tensor). Metrics: ``loss``,
    ``acc``, ``grad_norm``, ``lr``, ``total_loss`` (and
    ``ef_residual_norm`` under ``grad_compression="int8_ef"``), detached
    tensors on the step's device, global over the mesh.

    With ``cfg.partition="island"``, ``feats`` is the islandized table
    (``IslandPartition.relabel_rows`` order) and ``relabel`` the old → new
    id map; every batch's ids are translated at the ``sage_loss`` entry,
    so islandized ≡ interval bit for bit, gradients included.

    The step consumes ``state``: its parameters, optimiser state and step
    count are updated in place (``optim.adamw_update``), as the JAX step's
    donated state is, and the returned state holds the same tensors. A
    caller that reads the old state after a step clones it first.
    """
    sharded = cgtrans.is_sharded(mesh)
    gcn._check_partition_knob(cfg, relabel)

    def train_step(state, batch):
        paths = leaves_with_paths(state["params"])
        live = [p.detach().requires_grad_(True) for _, p in paths]
        params = unflatten(state["params"], live)
        loss, metrics = gcn.sage_loss(params, feats, batch, cfg, mesh=mesh,
                                      relabel=relabel)
        grads = list(torch.autograd.grad(loss, live, materialize_grads=True))
        if sharded:
            grads = _sum_over_ranks(grads, mesh)
        new_p, new_opt, om = adamw_update(
            state["params"], unflatten(state["params"], grads), state["opt"],
            tc)
        with torch.no_grad():
            state["step"].add_(1)
        return ({"params": new_p, "opt": new_opt, "step": state["step"]},
                {**metrics, **om, "total_loss": metrics["loss"]})

    return train_step


def _sum_over_ranks(grads, mesh):
    """The ranks' gradients summed, through ONE all-reduce of a flat
    buffer."""
    flat = collectives.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                                  mesh, name="grad_all_reduce")
    out, off = [], 0
    for g in grads:
        out.append(flat[off:off + g.numel()].reshape(g.shape))
        off += g.numel()
    return out


def state_from_jax(state: Mapping, device: DeviceLike = "cuda"
                   ) -> Dict[str, object]:
    """Carry a JAX training state ``{"params", "opt", "step"}`` (a tree of
    numpy arrays, e.g. ``jax.tree.map(np.asarray, state)``) across: the
    parameters through ``gcn.params_from_jax``, every other leaf as a
    tensor of its own dtype, all on ``device``."""
    dev = resolve_device(device)
    as_tensor = lambda x: torch.from_numpy(np.array(x, copy=True)).to(dev)
    return {"params": gcn.params_from_jax(state["params"], device=dev),
            "opt": tree_map(as_tensor, dict(state["opt"])),
            "step": as_tensor(np.asarray(state["step"], np.int32))}


def split_stages(n_blocks: int, n_stages: int
                 ) -> Tuple[Tuple[int, int], ...]:
    """Contiguous block ranges per stage, balanced to ±1."""
    base, extra = divmod(n_blocks, n_stages)
    out = []
    start = 0
    for s in range(n_stages):
        size = base + (1 if s < extra else 0)
        out.append((start, start + size))
        start += size
    return tuple(out)


def pipelined_apply(block_fn: Callable, params_stacked: Any,
                    x: torch.Tensor, *, mesh, axis: str = "pod"
                    ) -> torch.Tensor:
    """Run the stacked blocks (every leaf's leading dim the block) as a
    pipeline over ``axis`` of ``mesh``. ``x``: (n_micro, …) microbatched
    activations, the same on every pod; ``block_fn(x, block_params)``.

    Every pod holds all the stacked parameters and runs its own stage's
    range. At tick t stage 0 takes microbatch t, the stage holding
    microbatch t - stage keeps its result, the last stage keeps its
    finished microbatch, and every stage ppermutes its output to the
    next. As in the JAX package, every rank computes every tick (the
    longest stage's block count, masked) and selects with ``where``: the
    program, and so the order of the backward's ppermutes, is the same on
    every rank. Returns the (n_micro, …) outputs on every pod (zeros
    elsewhere than the last stage, then one psum over ``axis``); each
    pod's gradient is its stage's part."""
    n_stages = mesh.shape[axis]
    n_micro = x.shape[0]
    n_blocks = leaves_with_paths(params_stacked)[0][1].shape[0]
    ranges = split_stages(n_blocks, n_stages)
    stage = mesh.axis_index(axis)
    start, stop = ranges[stage]
    max_len = max(e - s for s, e in ranges)
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    last = stage == n_stages - 1

    def stage_fn(xi):
        for j in range(max_len):
            i = start + min(j, stop - start - 1)
            y = block_fn(xi, tree_map(lambda a: a[i], params_stacked))
            xi = torch.where(torch.tensor(j < stop - start), y, xi)
        return xi

    buf = torch.zeros_like(x[0])
    outs = [torch.zeros_like(x[0]) for _ in range(n_micro)]
    for t in range(n_micro + n_stages - 1):
        take = stage == 0 and t < n_micro
        inp = torch.where(torch.tensor(take), x[min(t, n_micro - 1)], buf)
        holds = 0 <= t - stage < n_micro
        y = torch.where(torch.tensor(holds), stage_fn(inp), inp)
        slot = min(max(t - stage, 0), n_micro - 1)
        outs[slot] = torch.where(torch.tensor(holds and last), y, outs[slot])
        buf = collectives.ppermute(y, mesh, axis=axis, perm=ring)
    return collectives.psum(torch.stack(outs), mesh, axis=axis)
