"""LM train / prefill / decode step builders (schema-driven).

``make_train_step`` builds the (state, batch) → (state, metrics) function
of the JAX package: microbatched gradient accumulation into f32 buffers,
AdamW, optional int8-EF gradient compression. ``state_schema`` and
``batch_structs`` describe the state and a batch with no allocation
(``ParamDef`` trees and meta tensors). The graph workload's training step
is ``train.pipeline.make_sage_train_step``.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.common.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.common.schema import ParamDef, init_params
from repro_torch.common.tree import leaves_with_paths, tree_map, unflatten
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
        "opt": opt_state_schema(ps, tc),
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


def init_state(cfg: ModelConfig, tc: TrainConfig, seed: int = 0, *,
               max_seq: int = 0, device: DeviceLike = "cuda",
               draw: str = "numpy"):
    """{"params", "opt", "step"}: parameters from ``seed`` (``draw`` as in
    ``init_params``), zero AdamW state, step 0."""
    params = init_params(T.model_schema(cfg, max_seq=max_seq), seed,
                         device=device, draw=draw)
    dev = resolve_device(device)
    return {"params": params, "opt": adamw_init(params, tc),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, tc: TrainConfig, *, mesh=None,
                    use_flash: bool = False, param_shardings=None):
    """(state, batch) → (state, metrics) for LM training.

    ``state`` is ``{"params", "opt", "step"}`` (``init_state``); ``batch``
    tokens and labels (B, S) (+ frames / vision), tensors or arrays. With
    ``tc.microbatches`` = mb > 1 the batch splits into mb slices along B;
    each slice's gradients accumulate in f32 and are divided by mb, the
    loss is the slices' mean and the other metrics the last slice's.
    Metrics: the JAX step's keys (``loss``, ``aux_loss``, ``tokens``,
    ``grad_norm``, ``lr``, [``ef_residual_norm``], ``total_loss``), as
    detached tensors.
    """
    if mesh is not None or param_shardings is not None:
        raise NotImplementedError(
            "make_train_step(mesh=, param_shardings=) is not ported yet "
            "(ROADMAP Queue 1 row 10.3, the sharded LM)")
    if use_flash:
        raise NotImplementedError(
            f"make_train_step(use_flash=True): {NO_GRADIENT}")

    def value_and_grad(params, batch):
        paths = leaves_with_paths(params)
        live = [p.detach().requires_grad_(True) for _, p in paths]
        total, metrics = T.loss_fn(unflatten(params, live), batch, cfg)
        grads = torch.autograd.grad(total, live, materialize_grads=True)
        return (total.detach(), tree_map(torch.Tensor.detach, metrics),
                unflatten(params, list(grads)))

    def train_step(state, batch):
        params = state["params"]
        dev = params["embed"]["table"].device
        batch = {k: T._on(v, dev) for k, v in batch.items()}
        mb = tc.microbatches
        if mb > 1:
            g_acc = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            l_acc = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                l, metrics, g = value_and_grad(params, part)
                g_acc = tree_map(lambda a, b: a + b.to(a.dtype), g_acc, g)
                l_acc = l_acc + l
            grads = tree_map(lambda g: g / mb, g_acc)
            loss_val = l_acc / mb
        else:
            loss_val, metrics, grads = value_and_grad(params, batch)
        new_params, new_opt, opt_metrics = adamw_update(params, grads,
                                                        state["opt"], tc)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {**metrics, **opt_metrics, "total_loss": loss_val}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, cache_len: int, mesh=None,
                      use_flash: bool = False):
    """(params, batch) → (last-token logits, caches). ``use_flash`` runs
    the encoder's self-attention through the flash kernel."""
    T._no_mesh(mesh)

    def prefill_step(params, batch):
        return T.prefill(params, batch, cfg, cache_len=cache_len,
                         use_flash=use_flash)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, mesh=None):
    """(params, token, caches, pos) → (logits, caches updated in place)."""
    T._no_mesh(mesh)

    def decode_step(params, token, caches, pos):
        return T.decode_step(params, token, caches, pos, cfg)
    return decode_step
