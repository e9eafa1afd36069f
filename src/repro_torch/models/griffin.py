"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)
a_t = exp(-c · softplus(Λ) ⊙ sigmoid(r_t)),   c = 8

The full-sequence path is a log-depth scan, the JAX package's
``lax.associative_scan``: log₂ S elementwise steps over the sequence, each
combining every position with the one 2^k before it (its rounding is not
the JAX scan's tree, so the two agree within tolerance, not bit for bit).
Decode is a single fused update. The temporal block wraps the RG-LRU with
the Griffin gating: conv1d(4) on the x-branch, GeLU gate branch, output
projection.

**On a mesh** (``mesh=``) the block is tensor-parallel over ``model``, as
the JAX schema's ``lru`` axis places it: ``w_x`` and ``w_gate`` are
column-parallel (the rank's W/tp channels, ``x`` through ``pvary``), and
the conv, ``lam`` and the scan run on those channels. The two gate
products contract over the split width against the rank's rows of
``w_rec_gate`` and ``w_in_gate``: each rank forms both f32 (B, S, W)
partials, stacked, and one all-reduce over ``model`` sums them (the one
tuple all-reduce of the JAX program lowered by GSPMD), then the rank takes
its W/tp columns. ``w_out`` is row-parallel and ends in one all-reduce of
(B, S, D). The decode cache is the rank's channels of ``h`` and ``conv``
(``rglru_cache_schema``, the JAX schema's specs). A ``model`` axis that
does not divide W cannot hold these leaves (``shard_params`` refuses,
as JAX's ``device_put`` does), so on a mesh the width splits wherever
the ``model`` axis has more than one rank.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.schema import ParamDef
from repro_torch.models.layers import (ready_params, tp_size, tp_sum,
                                       tp_vary)

_C = 8.0


def rglru_schema(cfg: ModelConfig) -> Dict[str, Any]:
    D = cfg.d_model
    W = cfg.lru_width or D
    return {
        "w_x": ParamDef((D, W), ("embed", "lru"), init="lecun"),
        "w_gate": ParamDef((D, W), ("embed", "lru"), init="lecun"),
        "conv_w": ParamDef((cfg.conv_kernel, W), (None, "lru"), init="lecun"),
        "conv_b": ParamDef((W,), ("lru",), init="zeros"),
        "w_rec_gate": ParamDef((W, W), ("lru", None), init="lecun"),
        "w_in_gate": ParamDef((W, W), ("lru", None), init="lecun"),
        "lam": ParamDef((W,), ("lru",), init="custom", custom="rglru_lambda"),
        "w_out": ParamDef((W, D), ("lru", "embed"), init="lecun"),
    }


def rglru_cache_schema(cfg: ModelConfig, batch: int) -> Dict[str, ParamDef]:
    """The decode state, with the JAX schema's logical specs: on a mesh a
    rank's holds its rows and its channels of the width."""
    W = cfg.lru_width or cfg.d_model
    return {
        "h": ParamDef((batch, W), ("batch", "lru"), init="zeros",
                      dtype=torch.float32),
        "conv": ParamDef((batch, cfg.conv_kernel - 1, W),
                         ("batch", None, "lru"), init="zeros",
                         dtype=torch.float32),
    }


def _gates(p, xb, mesh=None):
    """Recurrence gate a and gated input from the x-branch. float32. On a
    mesh ``xb`` is the rank's channels, and so are a and the input: the
    gate products' f32 partials are summed over ``model`` in one psum,
    then sliced."""
    x32 = xb.float()
    r = x32 @ p["w_rec_gate"].float()
    i = x32 @ p["w_in_gate"].float()
    if tp_size(mesh) > 1:
        # the whole (2, B, S, W) sum enters the rank's columns: pvary's
        # backward sums the ranks' column cotangents into every column's
        both = tp_vary(tp_sum(torch.stack([r, i]), mesh), mesh)
        Wl = xb.shape[-1]
        lo = mesh.axis_index("model") * Wl
        r, i = both[0, ..., lo:lo + Wl], both[1, ..., lo:lo + Wl]
    r, i = torch.sigmoid(r), torch.sigmoid(i)
    log_a = -_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * x32)


def _conv(xb, w, b, history=None):
    K = w.shape[0]
    B, S, W = xb.shape
    pad = (xb.new_zeros((B, K - 1, W)) if history is None
           else history.to(xb.dtype))
    xp = torch.cat([pad, xb], dim=1)
    out = sum(xp[:, i:i + S] * w[i].to(xb.dtype) for i in range(K))
    return out + b.to(xb.dtype), xp[:, -(K - 1):]


def linear_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t·h_{t-1} + b_t (h_{-1} = 0) along axis 1,
    in ceil(log₂ S) elementwise steps (Hillis–Steele). Returns the
    prefix products of a and h."""
    S = a.shape[1]
    d = 1
    while d < S:
        # combine each position t ≥ d with the element d before it:
        # (a', b') = (a_t·a_{t-d}, a_t·b_{t-d} + b_t)
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def _ready(p, cfg: ModelConfig, mesh):
    """The weights as the rank's compute reads them: its ``lru`` blocks,
    every ``embed`` dimension gathered over ``data``."""
    keep = ("lru",) if tp_size(mesh) > 1 else ()
    return ready_params(p, rglru_schema(cfg), mesh, keep)


def rglru_apply(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
                init_h=None, conv_history=None, return_cache: bool = False,
                mesh=None):
    """Full-sequence temporal block. x: (B,S,D) → (B,S,D); on a mesh the
    rank's channels (``init_h``, ``conv_history`` and the cache too), then
    the psum over ``model``."""
    p = _ready(p, cfg, mesh)
    xv = tp_vary(x, mesh)
    xb = xv @ p["w_x"].to(x.dtype)
    gate = F.gelu(xv @ p["w_gate"].to(x.dtype), approximate="tanh")
    xb, hist = _conv(xb, p["conv_w"], p["conv_b"], conv_history)
    a, bx = _gates(p, xb, mesh)                # (B,S,W) f32 each
    if init_h is not None:
        bx = torch.cat([bx[:, :1] + a[:, :1] * init_h.float()[:, None],
                        bx[:, 1:]], dim=1)
    _, h = linear_scan(a, bx)
    y = h.to(x.dtype) * gate
    out = tp_sum(y @ p["w_out"].to(x.dtype), mesh)
    if return_cache:
        return out, {"h": h[:, -1].float(), "conv": hist.float()}
    return out


def rglru_decode(p: Dict[str, Any], x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], cfg: ModelConfig, mesh=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-step update. x: (B,1,D). Returns (output, new cache); the
    cache passed in is not written. On a mesh the cache is the rank's
    (``rglru_cache_schema``) and so is the new one."""
    p = _ready(p, cfg, mesh)
    xv = tp_vary(x, mesh)
    xb = (xv @ p["w_x"].to(x.dtype))[:, 0]
    gate = F.gelu((xv @ p["w_gate"].to(x.dtype))[:, 0], approximate="tanh")
    hist = torch.cat([cache["conv"].to(xb.dtype), xb[:, None, :]], dim=1)
    xb = (torch.sum(hist * p["conv_w"].to(xb.dtype)[None], dim=1)
          + p["conv_b"].to(xb.dtype))
    a, bx = _gates(p, xb, mesh)
    h = a * cache["h"] + bx
    y = h.to(x.dtype) * gate
    out = tp_sum(y @ p["w_out"].to(x.dtype), mesh)[:, None, :]
    return out, {"h": h, "conv": hist[:, 1:].float()}
