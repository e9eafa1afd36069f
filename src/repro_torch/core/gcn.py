"""GCN / GraphSAGE on the CGTrans substrate (the paper's workload).

``gcn_forward_full`` runs full-graph GCN layers: each layer's aggregation
is the CGTrans edge dataflow (``cgtrans.aggregate_stream``), the combine a
dense product. ``sage_forward`` / ``sage_loss`` run minibatch GraphSAGE.

Vertex features live owner-sharded on the storage tier, ``(P, part, F)``;
a batch carries only ids. Layer 1's remote feature aggregation is the
CGTrans step (``cgtrans.aggregate_multi``); layer 2 aggregates the locally
materialised subgraph. Parameters are a flat dict of tensors named as in
the JAX package (``w0``, ``b0``, ``w1``, ``b1``, ``w_out``, ``b_out``), so
``params_from_jax`` carries them across unchanged. ``sage_forward`` and
``sage_loss`` are differentiable in the parameters and in the feature
table on both GAS backends; inference callers wrap them in
``torch.no_grad()``.

On a sharded ``mesh`` (``repro_torch.launch.mesh.DataMesh``) every rank
passes its own slices: ``feature_table(..., mesh=mesh)``'s ``(1, part, F)``
rows and ``mesh.shard(batch)``'s ``(1, B, …)`` seeds, and gets its own
``(1, B, C)`` logits; ``sage_loss`` reports the global mean over all P·B
seeds, as the JAX package's loss over the seed-sharded batch does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.common.schema import ParamDef
from repro_torch.core import cgtrans, collectives
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.partition import interval_size
from repro_torch.runtime import trace


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    n_features: int
    hidden: int = 128
    n_classes: int = 16
    fanout: int = 50             # paper: GraphSAGE samples 50 neighbors
    aggregate: str = "add"       # add | max
    dataflow: str = "cgtrans"    # cgtrans | baseline
    n_layers: int = 2
    impl: str = "ref"            # ref | kernel — GAS backend for aggregation
    request_chunk: Optional[int] = None  # command-queue depth (rows per
                                         # sampled-aggregation burst)
    scheduled: Optional[bool] = None     # destination-binned edge schedule;
                                         # None → on exactly when
                                         # impl="kernel"
    coalesce: bool = True                # self-row lookup + 2-hop requests
                                         # in ONE command block
    wire: str = "f32"                    # collective transport format
    features: str = "dense"              # dense | sparse
    sparse_capacity: Optional[int] = None
    partition: str = "interval"          # interval | island


def gcn_schema(cfg: GCNConfig) -> Dict[str, ParamDef]:
    F, H, C = cfg.n_features, cfg.hidden, cfg.n_classes
    s: Dict[str, ParamDef] = {}
    d_in = F
    for i in range(cfg.n_layers):
        # SAGE concat [self ‖ aggregated] → weight is (2·d_in, H)
        s[f"w{i}"] = ParamDef((2 * d_in, H), ("embed", "ff"), init="lecun")
        s[f"b{i}"] = ParamDef((H,), ("ff",), init="zeros")
        d_in = H
    s["w_out"] = ParamDef((d_in, C), ("embed", None), init="lecun")
    s["b_out"] = ParamDef((C,), (None,), init="zeros")
    return s


def params_from_jax(params: Mapping[str, np.ndarray],
                    device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Carry parameters across from the JAX package (any mapping of names
    to arrays, e.g. ``repro.common.schema.init_params(gcn_schema(cfg),
    key)``): float32 tensors on ``device``, values unchanged."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True)
                                ).to(dev)
            for k, v in params.items()}


def _check_partition_knob(cfg: GCNConfig, relabel) -> None:
    """``cfg.partition`` and the relabel map travel together or not at all:
    an islandized table without the map (or the map without one) would
    aggregate the wrong rows, so a mismatch raises."""
    if cfg.partition not in ("interval", "island"):
        raise ValueError(f"unknown cfg.partition {cfg.partition!r} "
                         "(expected 'interval' or 'island')")
    if (cfg.partition == "island") != (relabel is not None):
        raise ValueError(
            "cfg.partition='island' requires the IslandPartition relabel map "
            "(relabel=isl.relabel), and relabel= requires partition='island' "
            f"— got partition={cfg.partition!r}, "
            f"relabel={'set' if relabel is not None else 'None'}")


def _relabel_tensor(relabel, device: torch.device) -> torch.Tensor:
    """The old → new id map as an int64 tensor on ``device``."""
    if torch.is_tensor(relabel):
        return relabel.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(relabel, np.int64)).to(device)


def _unpermute(out: torch.Tensor, relabel, mesh) -> torch.Tensor:
    """Islandized (P, part, C) logits → original vertex order: flat row
    ``v`` of the result is vertex ``v``'s logits, pad rows zero. On a
    sharded mesh a rank's rows come from every rank, so the logits meet in
    one ``all_gather`` (``relabel_gather``; the JAX program holds one
    all-reduce of the same (P·part, C) rows there) and each rank keeps its
    own slice of the un-permuted whole."""
    sharded = cgtrans.is_sharded(mesh)
    whole = (collectives.all_gather(out[0], mesh, name="relabel_gather")
             if sharded else out)
    P_, part, C = whole.shape
    r = _relabel_tensor(relabel, out.device)
    orig = whole.reshape(P_ * part, C)[r]
    flat = torch.cat([orig, orig.new_zeros((P_ * part - r.shape[0], C))])
    flat = flat.reshape(P_, part, C)
    return flat[mesh.rank:mesh.rank + 1] if sharded else flat


def _batch_tensors(batch: Mapping, device: torch.device):
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
                ).to(device)
            for k, v in batch.items()}


def gcn_forward_full(params: Mapping[str, torch.Tensor], feats: torch.Tensor,
                     src_local: torch.Tensor, dst_global: torch.Tensor,
                     weights: torch.Tensor, mask: torch.Tensor,
                     cfg: GCNConfig, *, mesh=None, impl: Optional[str] = None,
                     relabel=None) -> torch.Tensor:
    """Full-graph GCN: ``feats`` (P, part, F) owner-sharded, the edge COO
    arrays (P, E) as ``partition_by_src`` lays them out. Returns
    (P, part, C) logits. On a sharded ``mesh`` every argument and the
    result are this rank's ``[rank:rank + 1]`` slices.

    ``impl`` overrides ``cfg.impl``. The edge stream
    (``cgtrans.edge_stream``: flattened or the rank's slice, binned and
    permuted where scheduled) is built once here and read by every layer's
    aggregation and by the backward. ``cfg.features="sparse"`` applies to
    layer 0's gather of the raw table only. After a max / min aggregation
    the ±inf identity rows of vertices without in-edges read 0.

    With ``cfg.partition="island"`` the inputs live in the islandized id
    space (``partition_graph(..., method="island")``) and ``relabel`` is
    the old → new map; the output is un-permuted back, so flat row ``v``
    is original vertex ``v``'s logits (pad rows zero) and islandized ≡
    interval bit for bit over ``[0, V)``. On a mesh this costs one
    ``all_gather`` of the logits (``relabel_gather``).
    """
    with trace.span("gcn.forward", feats):
        _check_partition_knob(cfg, relabel)
        impl_r = impl or cfg.impl
        stream = cgtrans.edge_stream(
            src_local, dst_global, weights, mask, feats.shape[:2], mesh=mesh,
            dataflow=cfg.dataflow, impl=impl_r, scheduled=cfg.scheduled)
        h = feats
        for i in range(cfg.n_layers):
            agg = cgtrans.aggregate_stream(
                h, stream, op=cfg.aggregate, impl=impl_r, wire=cfg.wire,
                # sparse only where the gather reads the raw table: deeper
                # layers' activations would measure a capacity of F anyway
                features=cfg.features if i == 0 else "dense",
                sparse_capacity=cfg.sparse_capacity if i == 0 else None)
            if cfg.aggregate in ("max", "min"):
                agg = torch.where(torch.isfinite(agg), agg, torch.zeros((),
                                  dtype=agg.dtype, device=agg.device))
            h = torch.cat([h, agg], dim=-1)
            h = torch.relu(torch.einsum("pvf,fh->pvh", h, params[f"w{i}"])
                           + params[f"b{i}"])
        out = torch.einsum("pvh,hc->pvc", h, params["w_out"]) + params["b_out"]
        return out if relabel is None else _unpermute(out, relabel, mesh)


def lookup_rows(feats, ids, *, mesh=None, dataflow="cgtrans", impl="ref",
                request_chunk=None, scheduled=None, wire="f32",
                features="dense", sparse_capacity=None):
    """Row lookup: ids (P, B_loc) → (P, B_loc, F)."""
    nbrs = ids[..., None]
    mask = torch.ones_like(nbrs, dtype=torch.bool)
    return cgtrans.aggregate_sampled(feats, nbrs, mask, mesh=mesh,
                                     dataflow=dataflow, impl=impl,
                                     request_chunk=request_chunk,
                                     scheduled=scheduled, wire=wire,
                                     features=features,
                                     sparse_capacity=sparse_capacity)


def sage_forward(params: Mapping[str, torch.Tensor], feats: torch.Tensor,
                 batch: Mapping, cfg: GCNConfig, *, mesh=None, relabel=None
                 ) -> torch.Tensor:
    """2-layer minibatch GraphSAGE, forward.

    ``feats``: (P, part, F) float32 on the device the work runs on.
    ``batch`` (numpy arrays or tensors, leading dim P):
      seeds (P, B), nbrs1/mask1 (P, B, K1), nbrs2/mask2 (P, B·(1+K1), K2).
    Returns (P, B, C) logits. On a sharded ``mesh`` P is 1: this rank's
    slices in, this rank's logits out.

    With ``cfg.partition="island"`` the table is islandized
    (``IslandPartition.relabel_rows`` order) and ``relabel`` translates
    the batch's vertex ids into that space at entry; the logits are
    positional per seed, so islandized ≡ interval bit for bit.
    """
    _check_partition_knob(cfg, relabel)
    b = _batch_tensors(batch, feats.device)
    if relabel is not None:
        r = _relabel_tensor(relabel, feats.device)
        for k in ("seeds", "nbrs1", "nbrs2"):
            b[k] = r[b[k].long()].to(torch.int32)
    Pn, B = b["seeds"].shape
    K1 = b["nbrs1"].shape[-1]
    seeds = b["seeds"].to(torch.int32)
    ids1 = torch.cat([seeds[..., None], b["nbrs1"].to(torch.int32)], dim=-1)
    flat1 = ids1.reshape(Pn, B * (1 + K1))
    nbrs2 = b["nbrs2"].to(torch.int32)
    mask2 = b["mask2"].to(torch.bool)
    knobs = dict(mesh=mesh, dataflow=cfg.dataflow, impl=cfg.impl,
                 request_chunk=cfg.request_chunk, scheduled=cfg.scheduled,
                 wire=cfg.wire, features=cfg.features,
                 sparse_capacity=cfg.sparse_capacity)

    # the CGTrans step: self features + 2-hop neighbourhood aggregation
    if cfg.coalesce:
        x_self, x_agg = cgtrans.aggregate_multi(
            feats, ((flat1[..., None], torch.ones(flat1.shape + (1,),
                                                  dtype=torch.bool,
                                                  device=feats.device)),
                    (nbrs2, mask2)), **knobs)
    else:
        x_self = lookup_rows(feats, flat1, **knobs)
        x_agg = cgtrans.aggregate_sampled(feats, nbrs2, mask2, **knobs)

    h1 = torch.cat([x_self, x_agg], dim=-1)
    h1 = torch.relu(torch.einsum("pbf,fh->pbh", h1, params["w0"])
                    + params["b0"])
    h1 = h1.reshape(Pn, B, 1 + K1, -1)

    # local step: aggregate the 1-hop h1 per seed
    m1 = b["mask1"].to(h1.dtype)[..., None]
    agg1 = (h1[:, :, 1:] * m1).sum(2) / torch.clamp(m1.sum(2), min=1.0)
    h2 = torch.cat([h1[:, :, 0], agg1], dim=-1)
    h2 = torch.relu(torch.einsum("pbf,fh->pbh", h2, params["w1"])
                    + params["b1"])
    return torch.einsum("pbh,hc->pbc", h2, params["w_out"]) + params["b_out"]


def sage_loss(params, feats, batch, cfg: GCNConfig, *, mesh=None,
              relabel=None):
    """(loss, {"loss", "acc"}) of ``sage_forward``'s logits: the mean NLL
    over every seed of the batch, differentiable, and its detached metrics.

    On a sharded ``mesh`` the returned loss is this rank's NLL sum over the
    static global seed count P·B, so the ranks' gradients sum (one
    all-reduce, the train step's) to the gradient of the global mean; the
    metrics are global, from one ``all_reduce`` of (NLL sum, correct
    count), counted as ``metric_all_reduce``."""
    logits = sage_forward(params, feats, batch, cfg, mesh=mesh,
                          relabel=relabel)
    labels = _batch_tensors({"labels": batch["labels"]},
                            logits.device)["labels"].long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    correct = (logits.argmax(-1) == labels).float()
    if not cgtrans.is_sharded(mesh):
        loss = nll.mean()
        return loss, {"loss": loss.detach(), "acc": correct.mean()}
    n_seeds = nll.numel() * mesh.size
    loss = nll.sum() / n_seeds
    sums = collectives.all_reduce(torch.stack([nll.sum(), correct.sum()]),
                                  mesh, name="metric_all_reduce")
    return loss, {"loss": sums[0] / n_seeds, "acc": sums[1] / n_seeds}


def feature_table(feats: np.ndarray, n_parts: int = 1, *, mesh=None,
                  device: DeviceLike = "cuda") -> torch.Tensor:
    """(V, F) host features → the (P, V/P, F) float32 owner-sharded layout
    ``sage_forward`` reads, on ``device``.

    On a sharded ``mesh`` (``n_parts`` = its size) the table is cut at
    ``interval_size`` boundaries, as ``partition_by_src`` cuts it, and only
    this rank's ``(1, part, F)`` interval is copied to the device (zero
    rows pad the last interval)."""
    dev = resolve_device(device)
    V, F = feats.shape
    if cgtrans.is_sharded(mesh):
        if n_parts != mesh.size:
            raise ValueError(f"n_parts={n_parts} on a {mesh.size}-rank mesh")
        part = interval_size(V, n_parts)
        lo = mesh.rank * part
        rows = np.zeros((part, F), np.float32)
        mine = feats[lo:min(lo + part, V)]
        rows[:mine.shape[0]] = mine
        return torch.from_numpy(rows).to(dev).reshape(1, part, F)
    if V % n_parts:
        raise ValueError(f"V={V} must divide into {n_parts} parts")
    return torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(
        dev).reshape(n_parts, V // n_parts, F)
