"""LM train / prefill / decode step builders (schema-driven).

``make_train_step`` builds the (state, batch) → (state, metrics) function
of the JAX package: microbatched gradient accumulation into f32 buffers,
AdamW, optional int8-EF gradient compression. ``state_schema`` and
``batch_structs`` describe the state and a batch with no allocation
(``ParamDef`` trees and meta tensors). The graph workload's training step
is ``train.pipeline.make_sage_train_step``.

On a mesh (``mesh=``, a ``launch.mesh.Mesh``) the state holds this rank's
blocks (``init_state(mesh=)``) and every step builder takes the global
batch, as the JAX step does, and runs this rank's rows of it over the
batch axes. A leaf's gradient comes back from the model as this rank's
block: summed over ``data`` already where the leaf is sharded over it
(the ZeRO-3 gather's reduce-scatter), the same on every ``model`` rank
where it is replicated over ``model`` (``models/layers.py``); the step
sums it over each batch axis the leaf is replicated on (one counted
``grad_all_reduce`` per set of such axes).

A buffer of the schema (``ParamDef(trainable=False)``, the sigmoid
router's selection bias) rides in ``params`` for the model to read; the
step takes no gradient of it and AdamW keeps no state for it and leaves
it as it is.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.common.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.common.logical import (DEFAULT_RULES, batch_axes, dp_size,
                                        local_block, local_shape, spec_axes,
                                        spec_leaves, to_physical,
                                        tree_to_physical)
from repro_torch.common.schema import (ParamDef, frozen_paths, init_params,
                                       leaves as schema_leaves,
                                       param_logical_specs, param_structs)
from repro_torch.common.tree import (leaves_with_paths, prune, tree_map,
                                     unflatten)
from repro_torch.core import collectives
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention.ops import NO_GRADIENT
from repro_torch.models import transformer as T
from repro_torch.models.layers import compute_dtype
from repro_torch.optim import adamw_init, adamw_update, opt_state_schema


# ---------------------------------------------------------------------------
# schemas / structs
# ---------------------------------------------------------------------------

def state_schema(cfg: ModelConfig, tc: TrainConfig, *, max_seq: int = 0):
    ps = T.model_schema(cfg, max_seq=max_seq)
    return {
        "params": ps,
        "opt": opt_state_schema(prune(ps, frozen_paths(ps)), tc),
        "step": ParamDef((), (), init="zeros", dtype=torch.int32),
    }


def batch_structs(cfg: ModelConfig, shape: ShapeConfig
                  ) -> Dict[str, torch.Tensor]:
    """A batch at ``shape`` as meta tensors (shape and dtype, no data)."""
    B, S = shape.global_batch, shape.seq_len
    meta = lambda *shp, dtype: torch.empty(shp, dtype=dtype, device="meta")
    out = {"tokens": meta(B, S, dtype=torch.int32),
           "labels": meta(B, S, dtype=torch.int32)}
    if cfg.is_encoder_decoder:
        out["frames"] = meta(B, cfg.enc_seq, cfg.d_model,
                             dtype=compute_dtype(cfg))
    if cfg.vision_seq:
        out["vision"] = meta(B, cfg.vision_seq, cfg.d_model,
                             dtype=compute_dtype(cfg))
    return out


def batch_logical_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """Each batch entry's logical axes (rows over the batch axes)."""
    out = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    if cfg.is_encoder_decoder:
        out["frames"] = ("batch", "seq", "embed")
    if cfg.vision_seq:
        out["vision"] = ("batch", "seq", "embed")
    return out


def decode_structs(cfg: ModelConfig, shape: ShapeConfig, tp: int = 16, *,
                   layout: str = "seq"):
    """(token, caches, pos) of a decode step at ``shape`` as meta tensors,
    the caches' global shapes (``transformer.stack_cache_schema_for``;
    ``layout="heads"`` lays them out for a ``model`` axis of ``tp``
    ranks). The port's step takes the position as a host int; ``pos`` is
    the JAX step's int32 scalar. A shape's rule table places these
    (``launch/specs.py``) and changes none of them."""
    B, S = shape.global_batch, shape.seq_len
    meta = lambda *shp: torch.empty(shp, dtype=torch.int32, device="meta")
    caches = param_structs(T.stack_cache_schema_for(cfg, B, S, tp, layout))
    return meta(B, 1), caches, meta()


def decode_logical_specs(cfg: ModelConfig, shape: ShapeConfig, tp: int = 16,
                         *, layout: str = "seq"):
    """The logical specs of ``decode_structs``'s (token, caches, pos):
    under ``"seq"`` the JAX package's (a full cache's sequence over
    ``seq_kv``)."""
    cache = T.stack_cache_schema_for(cfg, shape.global_batch, shape.seq_len,
                                     tp, layout)
    return ("batch", None), param_logical_specs(cache), ()


def state_logical_specs(cfg: ModelConfig, tc: TrainConfig, *,
                        max_seq: int = 0):
    """The training state's logical specs (checkpoints on a mesh)."""
    return param_logical_specs(state_schema(cfg, tc, max_seq=max_seq))


def init_state(cfg: ModelConfig, tc: TrainConfig, seed: int = 0, *,
               max_seq: int = 0, device: DeviceLike = "cuda",
               draw: str = "numpy", mesh=None):
    """{"params", "opt", "step"}: parameters from ``seed`` (``draw`` as in
    ``init_params``), zero AdamW state, step 0. On a ``mesh``: this rank's
    blocks of the unsharded run's parameters, on the mesh's device."""
    if mesh is not None:
        device = mesh.device
    schema = T.model_schema(cfg, max_seq=max_seq)
    params = init_params(schema, seed, device=device, draw=draw, mesh=mesh)
    dev = resolve_device(device)
    return {"params": params,
            "opt": adamw_init(prune(params, frozen_paths(schema)), tc),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def _rows(batch, cfg: ModelConfig, mesh, rules=None):
    """This rank's rows of a global batch over the batch axes of
    ``rules`` (default ``DEFAULT_RULES``; under ``batch=()`` every row)."""
    if mesh is None:
        return batch
    specs = batch_logical_specs(cfg)
    return {k: local_block(v, to_physical(specs[k], mesh, rules), mesh)
            for k, v in batch.items()}


def _check_placement(cfg: ModelConfig, params, mesh, param_shardings):
    """Raise unless ``params`` holds, leaf for leaf, the blocks the rule
    table places on ``mesh`` (and ``param_shardings``, when given, names
    those placements)."""
    max_seq = (params["dec_pos"]["table"].shape[0]
               if "dec_pos" in params else 0)
    schema = T.model_schema(cfg, max_seq=max_seq)
    want = tree_to_physical(param_logical_specs(schema), mesh)
    if param_shardings is not None and param_shardings != want:
        have = dict(spec_leaves(param_shardings))
        bad = [p for p, a in spec_leaves(want) if have.get(p) != a]
        raise ValueError(f"param_shardings disagree with the rule table's "
                         f"placement on this mesh at {bad[:4]}")
    for (path, spec), (_, d) in zip(spec_leaves(want),
                                    schema_leaves(schema)):
        leaf = params
        for k in path:
            leaf = leaf[k]
        if tuple(leaf.shape) != local_shape(d.shape, spec, mesh):
            raise ValueError(
                f"params{list(path)} has shape {tuple(leaf.shape)}, not the "
                f"block {local_shape(d.shape, spec, mesh)} of "
                f"{d.shape} under {spec}: pass init_state(mesh=) state")
    return want


def _sync_grads(grads, specs, mesh):
    """Sum every gradient over the batch axes its leaf is replicated on,
    one flat all-reduce per set of such axes."""
    dp = batch_axes(mesh)
    paths = leaves_with_paths(grads)
    spec_of = dict(spec_leaves(specs))
    buckets: Dict[Tuple[str, ...], list] = {}
    for i, (path, _) in enumerate(paths):
        used = spec_axes(spec_of[path])
        axes = tuple(a for a in dp if a not in used and mesh.shape[a] > 1)
        if axes:
            buckets.setdefault(axes, []).append(i)
    out = [g for _, g in paths]
    for axes, idx in buckets.items():
        flat = torch.cat([out[i].reshape(-1).float() for i in idx])
        flat = collectives.all_reduce(flat, mesh, axis=axes,
                                      name="grad_all_reduce")
        for i, part in zip(idx, torch.split(flat,
                                            [out[i].numel() for i in idx])):
            out[i] = part.reshape(out[i].shape).to(out[i].dtype)
    return unflatten(grads, out)


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *, mesh=None,
                    use_flash: bool = False, param_shardings=None,
                    impl: str = "ref"):
    """(state, batch) → (state, metrics) for LM training.

    ``state`` is ``{"params", "opt", "step"}`` (``init_state``); ``batch``
    tokens and labels (B, S) (+ frames / vision), tensors or arrays. With
    ``tc.microbatches`` = mb > 1 the batch splits into mb slices along B;
    each slice's gradients accumulate in f32 and are divided by mb, the
    loss is the slices' mean and the other metrics the last slice's.
    Metrics: the JAX step's keys (``loss``, ``aux_loss``, ``tokens``,
    ``grad_norm``, ``lr``, [``ef_residual_norm``], ``total_loss``), as
    detached tensors.

    On a ``mesh`` the state is this rank's blocks and each rank runs its
    rows of every microbatch (the JAX step's split: microbatch i is rows
    ``[i·B/mb, (i+1)·B/mb)``, sharded over the batch axes).

    The step consumes ``state``, as the JAX step's ``donate=(0,)`` does:
    the parameters, the AdamW moments and the step count are updated in
    place (``optim.adamw_update``), so one copy of the state is live, and
    the returned state holds the same tensors. A caller that reads the old
    state after a step clones it first.
    ``param_shardings`` (a tree of physical specs) is checked against the
    rule table's placement and the state's block shapes on the first
    step: the step raises where they disagree. ``impl`` is the backend of
    the CGTrans lookup's owner-side gradient on a mesh (``"kernel"``: the
    dense FAST-GAS grid).
    """
    mesh = T._valid_mesh(mesh)
    if mesh is None and param_shardings is not None:
        raise ValueError("param_shardings without a mesh")
    if use_flash:
        raise NotImplementedError(
            f"make_train_step(use_flash=True): {NO_GRADIENT}")
    checked = {}
    # the buffers: read by the model, no gradient, no optimiser state
    frozen = frozen_paths(T.model_schema(cfg))

    def value_and_grad(params, batch):
        paths = leaves_with_paths(params)
        live = [p if path in frozen else p.detach().requires_grad_(True)
                for path, p in paths]
        total, metrics = T.loss_fn(unflatten(params, live),
                                   _rows(batch, cfg, mesh), cfg, mesh=mesh,
                                   impl=impl)
        grads = torch.autograd.grad(
            total, [x for (path, _), x in zip(paths, live)
                    if path not in frozen], materialize_grads=True)
        return (total.detach(), tree_map(torch.Tensor.detach, metrics),
                unflatten(prune(params, frozen), list(grads)))

    def train_step(state, batch):
        if mesh is not None and "specs" not in checked:
            checked["specs"] = _check_placement(cfg, state["params"], mesh,
                                                param_shardings)
        dev = state["params"]["embed"]["table"].device
        batch = {k: T._on(v, dev) for k, v in batch.items()}
        params = prune(state["params"], frozen)
        mb = tc.microbatches
        if mb > 1:
            g_acc = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            l_acc = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                l, metrics, g = value_and_grad(state["params"], part)
                g_acc = tree_map(lambda a, b: a + b.to(a.dtype), g_acc, g)
                l_acc = l_acc + l
            grads = tree_map(lambda g: g / mb, g_acc)
            loss_val = l_acc / mb
        else:
            loss_val, metrics, grads = value_and_grad(state["params"], batch)
        specs = checked.get("specs")
        if mesh is not None:
            specs = prune(specs, frozen)
            grads = _sync_grads(grads, specs, mesh)
        # in place: the pruned tree holds the state's own tensors
        _, new_opt, opt_metrics = adamw_update(params, grads, state["opt"],
                                               tc, mesh=mesh, specs=specs)
        with torch.no_grad():
            state["step"].add_(1)
        new_state = {"params": state["params"], "opt": new_opt,
                     "step": state["step"]}
        return new_state, {**metrics, **opt_metrics, "total_loss": loss_val}

    return train_step


def _global_rows(logits, mesh, rules=None):
    """Every rank's rows of the logits, in batch order (the batch axes of
    ``rules``; under ``batch=()`` each rank holds them all already)."""
    if mesh is None or dp_size(mesh, rules) == 1:
        return logits
    parts = collectives.all_gather(logits, mesh,
                                   axis=batch_axes(mesh, rules),
                                   name="result_gather")
    return parts.reshape(-1, *logits.shape[1:])


def make_prefill_step(cfg: ModelConfig, *, cache_len: int, mesh=None,
                      use_flash: bool = False, rules=DEFAULT_RULES,
                      cache_layout: str = "seq"):
    """(params, batch) → (last-token logits, caches). ``use_flash`` runs
    the encoder's and the prefill's self-attention through the flash
    kernel. On a ``mesh``: this rank's blocks, the global batch (split
    over the batch axes of ``rules``, the shape's logical rule table), the
    global (B, V) logits and this rank's caches in ``cache_layout``
    (``models/layers.py``)."""
    mesh = T._valid_mesh(mesh)

    def prefill_step(params, batch):
        dev = params["embed"]["table"].device
        rows = _rows({k: T._on(v, dev) for k, v in batch.items()}, cfg,
                     mesh, rules)
        logits, caches = T.prefill(params, rows, cfg, cache_len=cache_len,
                                   mesh=mesh, use_flash=use_flash,
                                   rules=rules, cache_layout=cache_layout)
        return _global_rows(logits, mesh, rules), caches
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, mesh=None, rules=DEFAULT_RULES,
                     cache_layout: str = "seq"):
    """(params, token, caches, pos) → (logits, caches updated in place).
    On a ``mesh``: the global (B, 1) token (split over the batch axes of
    ``rules``) and (B, V) logits, this rank's blocks and its caches in
    ``cache_layout``, as ``make_prefill_step`` built them."""
    mesh = T._valid_mesh(mesh)

    def decode_step(params, token, caches, pos):
        if mesh is not None:
            tok = T._on(token, params["embed"]["table"].device)
            token = local_block(tok, to_physical(("batch", None), mesh,
                                                 rules), mesh)
        logits, caches = T.decode_step(params, token, caches, pos, cfg,
                                       mesh=mesh, rules=rules,
                                       cache_layout=cache_layout)
        return _global_rows(logits, mesh, rules), caches
    return decode_step
