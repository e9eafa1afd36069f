"""The graph workload's training step: GraphSAGE + CGTrans loss, gradients
and AdamW against an owner-sharded feature table.

``make_sage_train_step`` is the one-card form of the JAX package's
function of the same name: the FAST-GAS knobs ride in on the
``GCNConfig`` (``impl``, ``request_chunk``, ``scheduled``, ``coalesce``)
and the step differentiates the parameters only, with the feature table
closed over — so its GAS kernels run in the forward, and its backward is
the dense layers. Differentiating the table (``feats.requires_grad_()``
through ``sage_loss``) runs the GAS backward rules
(``repro_torch.core.gas``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch

from repro_torch.common.config import TrainConfig
from repro_torch.common.tree import leaves_with_paths, tree_map, unflatten
from repro_torch.core import gcn
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import adamw_update


def make_sage_train_step(cfg: gcn.GCNConfig, tc: TrainConfig, *,
                         feats: torch.Tensor, mesh=None,
                         relabel=None) -> Callable:
    """(state, batch) → (state, metrics) for GraphSAGE + CGTrans training.

    ``feats`` is the (P, part, F) feature table on the device the step runs
    on; ``state`` is ``{"params", "opt", "step"}`` (``adamw_init`` makes
    the optimiser state, ``step`` is an int32 scalar tensor). Metrics:
    ``loss``, ``acc``, ``grad_norm``, ``lr``, ``total_loss`` (and
    ``ef_residual_norm`` under ``grad_compression="int8_ef"``), detached
    tensors on the step's device.
    """
    if mesh is not None:
        raise NotImplementedError(
            "make_sage_train_step(mesh=): the sharded dataflows are not "
            "ported yet (ROADMAP Queue 1 row 2)")
    gcn._check_partition_knob(cfg, relabel)

    def train_step(state, batch):
        paths = leaves_with_paths(state["params"])
        live = [p.detach().requires_grad_(True) for _, p in paths]
        params = unflatten(state["params"], live)
        loss, metrics = gcn.sage_loss(params, feats, batch, cfg)
        grads = unflatten(state["params"], list(torch.autograd.grad(
            loss, live, materialize_grads=True)))
        new_p, new_opt, om = adamw_update(state["params"], grads,
                                          state["opt"], tc)
        return ({"params": new_p, "opt": new_opt, "step": state["step"] + 1},
                {**metrics, **om, "total_loss": loss.detach()})

    return train_step


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
