"""The graph workload's training step: GraphSAGE + CGTrans loss, gradients
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

from typing import Callable, Dict, Mapping

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
        return ({"params": new_p, "opt": new_opt, "step": state["step"] + 1},
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
