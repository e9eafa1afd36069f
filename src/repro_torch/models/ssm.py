"""Mamba2 mixer via SSD (state-space duality), chunked matmul formulation.

The SSD algorithm (Dao & Gu, arXiv:2405.21060) computes the selective-SSM
recurrence as block matmuls: an intra-chunk "attention-like" term plus the
contribution of the state carried between chunks. The JAX package runs the
chunks under one ``lax.scan``; here a Python loop over chunks carries the
state, with the same per-chunk arithmetic.

Layout: d_inner = expand·d_model, H = d_inner/head_dim heads, state N,
single B/C group (n_groups = 1, matching mamba2-780m).

**On a mesh** (``mesh=``) the mixer is tensor-parallel over ``model``, as
the JAX schema's ``ssm_heads`` axis places it: the rank reads its H/tp
heads of ``z_proj``, ``x_proj``, ``dt_proj``, the x-conv, ``a_log``,
``dt_bias``, ``d_skip`` and ``out_norm`` (ZeRO-3 ``embed`` blocks are
still gathered over ``data``), and B and C come from the replicated
``b_proj`` / ``c_proj`` and their convs, then pass ``pvary`` into the
rank's heads (their cotangents are the rank's part; ``models/layers.py``
says why). The forward holds the two all-reduces over ``model`` that the
JAX program lowered by GSPMD holds: the f32 (B, S) sum of squares of
``out_norm``, an RMS over the whole d_inner, and the (B, S, D) output of
the row-parallel ``out_proj``. Its decode cache is the rank's heads of
``state`` and channels of ``conv_x``, ``conv_b`` and ``conv_c`` whole
(``ssd_cache_schema``, the JAX schema's specs). A ``model`` axis that
does not divide H cannot hold these leaves: ``shard_params`` refuses the
placement, as JAX's ``device_put`` does, so on a mesh the heads split
wherever the ``model`` axis has more than one rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.schema import ParamDef
from repro_torch.models.layers import (ready_params, rms_norm, tp_size,
                                       tp_sum, tp_vary)


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    return d_inner, H, cfg.ssm_head_dim, cfg.ssm_state


def ssd_schema(cfg: ModelConfig) -> Dict[str, Any]:
    D = cfg.d_model
    d_inner, H, _, N = dims(cfg)
    K = cfg.conv_kernel
    return {
        "z_proj": ParamDef((D, d_inner), ("embed", "ssm_heads"), init="lecun"),
        "x_proj": ParamDef((D, d_inner), ("embed", "ssm_heads"), init="lecun"),
        "b_proj": ParamDef((D, N), ("embed", None), init="lecun"),
        "c_proj": ParamDef((D, N), ("embed", None), init="lecun"),
        "dt_proj": ParamDef((D, H), ("embed", "ssm_heads"), init="lecun"),
        "conv_x_w": ParamDef((K, d_inner), (None, "ssm_heads"), init="lecun"),
        "conv_x_b": ParamDef((d_inner,), ("ssm_heads",), init="zeros"),
        "conv_b_w": ParamDef((K, N), (None, None), init="lecun"),
        "conv_b_b": ParamDef((N,), (None,), init="zeros"),
        "conv_c_w": ParamDef((K, N), (None, None), init="lecun"),
        "conv_c_b": ParamDef((N,), (None,), init="zeros"),
        "a_log": ParamDef((H,), ("ssm_heads",), init="custom",
                          custom="ssm_a_log"),
        "dt_bias": ParamDef((H,), ("ssm_heads",), init="custom",
                            custom="ssm_dt_bias"),
        "d_skip": ParamDef((H,), ("ssm_heads",), init="ones"),
        "out_norm": ParamDef((d_inner,), ("ssm_heads",), init="ones"),
        "out_proj": ParamDef((d_inner, D), ("ssm_heads", "embed"),
                             init="lecun"),
    }


def ssd_cache_schema(cfg: ModelConfig, batch: int) -> Dict[str, ParamDef]:
    """The decode state, with the JAX schema's logical specs: on a mesh a
    rank's holds its rows, its heads of ``state`` and its channels of
    ``conv_x``; ``conv_b`` and ``conv_c`` are replicated over
    ``model``."""
    d_inner, H, P_, N = dims(cfg)
    K = cfg.conv_kernel
    f32 = torch.float32
    return {
        "state": ParamDef((batch, H, P_, N),
                          ("batch", "ssm_heads", None, None),
                          init="zeros", dtype=f32),
        "conv_x": ParamDef((batch, K - 1, d_inner),
                           ("batch", None, "ssm_heads"),
                           init="zeros", dtype=f32),
        "conv_b": ParamDef((batch, K - 1, N), ("batch", None, None),
                           init="zeros", dtype=f32),
        "conv_c": ParamDef((batch, K - 1, N), ("batch", None, None),
                           init="zeros", dtype=f32),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor],
                 history: Optional[torch.Tensor] = None, act: bool = True):
    """Depthwise causal conv along seq. x: (B,S,C); w: (K,C); b: (C,) or
    None (no bias). Returns (output, the last K-1 inputs as the next
    call's history)."""
    K = w.shape[0]
    if history is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = history.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, C)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(K))
    if b is not None:
        out = out + b.to(x.dtype)
    if act:
        out = F.silu(out)
    return out, xp[:, -(K - 1):]


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD: a loop over chunks, the state carried between them.

    Per chunk: an intra-chunk attention-like matmul term plus the
    contribution of the carried state; the recurrence between chunks is
    serial. Matmul inputs in the compute dtype accumulate in f32, as the
    JAX package's ``preferred_element_type=float32`` does.

    x: (B,S,H,P)  dt: (B,S,H) post-softplus f32  A: (H,) negative
    Bm, Cm: (B,S,N) single group.
    Returns y: (B,S,H,P) f32, final state (B,H,P,N) f32.
    """
    Bsz, S, H, P_ = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    S_orig = S
    if S % L:
        # pad with dt=0 steps: zero dt means no state update and no output
        # weight, so the padding is exact
        pad = L - S % L
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    li = torch.arange(L, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, :, :, None]  # (1,L,L,1)
    s = (x.new_zeros((Bsz, H, P_, N), dtype=torch.float32)
         if init_state is None else init_state.to(torch.float32))
    ys = []
    for lo in range(0, S, L):
        xi, dti = x[:, lo:lo + L], dt[:, lo:lo + L]
        Bi, Ci = Bm[:, lo:lo + L], Cm[:, lo:lo + L]
        dA = dti * A[None, None, :]                         # (B,L,H) ≤ 0, f32
        cum = torch.cumsum(dA, dim=1)
        total = cum[:, -1, :]                               # (B,H)
        # intra-chunk: att[l,m] = C_l·B_m · exp(cum_l - cum_m) · dt_m, l ≥ m
        cb = torch.einsum("bln,bmn->blm", Ci.float(), Bi.float())
        seg = cum[:, :, None, :] - cum[:, None, :, :]       # (B,L,L,H)
        # mask BEFORE exp: exp(-inf) = 0 keeps the forward and the gradient
        # finite (the non-causal entries are positive and would overflow)
        decay = torch.exp(torch.where(causal, seg, float("-inf")))
        att = (cb[..., None] * decay * dti[:, None, :, :]).to(xi.dtype)
        y = torch.einsum("blmh,bmhp->blhp", att.float(), xi.float())
        # carried-state contribution: y_off_l = C_l · (exp(cum_l) ⊙ S_in)
        y = y + torch.einsum("bln,blh,bhpn->blhp", Ci.float(),
                             torch.exp(cum), s)
        # S_out = exp(total)·S_in + Σ_m exp(total - cum_m)·dt_m·B_m ⊗ x_m
        dstate = torch.exp(total[:, None, :] - cum) * dti   # (B,L,H)
        cs = torch.einsum("bln,blh,blhp->bhpn", Bi.float(), dstate,
                          xi.float())
        s = s * torch.exp(total)[:, :, None, None] + cs
        # chunk outputs stacked in the compute dtype, as the JAX scan does
        ys.append(y.to(xi.dtype))
    y = torch.cat(ys, dim=1)
    return y[:, :S_orig].to(torch.float32), s


def _proj(x, w):
    return x @ w.to(x.dtype)


def _ready(p, cfg: ModelConfig, mesh):
    """The weights as the rank's compute reads them: its ``ssm_heads``
    blocks, every ``embed`` dimension gathered over ``data``."""
    keep = ("ssm_heads",) if tp_size(mesh) > 1 else ()
    return ready_params(p, ssd_schema(cfg), mesh, keep)


def _out_norm(y, w, cfg: ModelConfig, mesh):
    """``rms_norm`` of y (B, S, d_inner/tp) over the whole d_inner: the
    rank's f32 sum of squares, one psum over ``model`` of the (B, S)
    statistic, then the rank's scale."""
    if tp_size(mesh) == 1:
        return rms_norm(y, w, cfg.norm_eps, False)
    yf = y.float()
    ss = tp_sum(torch.sum(torch.square(yf), dim=-1), mesh)
    # the statistic enters the rank's channels: its cotangent is the
    # rank's part, summed by pvary's backward
    var = tp_vary(ss, mesh)[..., None] / (yf.shape[-1] * tp_size(mesh))
    return (yf * torch.rsqrt(var + cfg.norm_eps) * w.float()).to(y.dtype)


def _mixer_out(y, z, p, cfg: ModelConfig, mesh, x_dtype):
    """The gated norm and the (row-parallel on a mesh) ``out_proj``."""
    y = _out_norm(y * F.silu(z), p["out_norm"], cfg, mesh)
    return tp_sum(y @ p["out_proj"].to(x_dtype), mesh)


def ssd_apply(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig,
              init_state=None, conv_history=None,
              return_cache: bool = False, mesh=None):
    """Full-sequence mamba2 mixer. x: (B,S,D) → (B,S,D); on a mesh the
    rank's heads, then the psums over ``model``."""
    p = _ready(p, cfg, mesh)
    _, _, P_, _ = dims(cfg)
    B, S, _ = x.shape
    xv = tp_vary(x, mesh)
    z = _proj(xv, p["z_proj"])
    xs = _proj(xv, p["x_proj"])
    dt = _proj(xv, p["dt_proj"])
    Bm = _proj(x, p["b_proj"])
    Cm = _proj(x, p["c_proj"])
    hx = hb = hc = None
    if conv_history is not None:
        hx, hb, hc = (conv_history["conv_x"], conv_history["conv_b"],
                      conv_history["conv_c"])
    xs, nhx = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"], hx)
    Bm, nhb = _causal_conv(Bm, p["conv_b_w"], p["conv_b_b"], hb)
    Cm, nhc = _causal_conv(Cm, p["conv_c_w"], p["conv_c_b"], hc)
    # B and C from the replicated projections, into the rank's heads
    Bm, Cm = tp_vary(Bm, mesh), tp_vary(Cm, mesh)
    xs = xs.reshape(B, S, -1, P_)
    dt = F.softplus(dt.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["a_log"].float())
    y, state = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk, init_state)
    y = y + xs.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(B, S, -1).to(x.dtype)
    out = _mixer_out(y, z, p, cfg, mesh, x.dtype)
    if return_cache:
        cache = {"state": state,
                 "conv_x": nhx.float(), "conv_b": nhb.float(),
                 "conv_c": nhc.float()}
        return out, cache
    return out


def _conv_step(v, hist, w, b, act: bool = True):
    """Single-token depthwise conv against history. v: (B,C)."""
    full = torch.cat([hist.to(v.dtype), v[:, None, :]], dim=1)  # (B,K,C)
    out = torch.sum(full * w.to(v.dtype)[None], dim=1) + b.to(v.dtype)
    if act:
        out = F.silu(out)
    return out, full[:, 1:]


def ssd_decode(p: Dict[str, Any], x: torch.Tensor,
               cache: Dict[str, torch.Tensor], cfg: ModelConfig, mesh=None):
    """Single-token recurrent update. x: (B,1,D). Returns (output, new
    cache); the cache passed in is not written. On a mesh the cache is the
    rank's (``ssd_cache_schema``) and so is the new one."""
    p = _ready(p, cfg, mesh)
    _, _, P_, _ = dims(cfg)
    B = x.shape[0]
    x0 = x[:, 0]
    xv = tp_vary(x0, mesh)
    z = _proj(xv, p["z_proj"])
    xs = _proj(xv, p["x_proj"])
    dt = _proj(xv, p["dt_proj"])
    Bm = _proj(x0, p["b_proj"])
    Cm = _proj(x0, p["c_proj"])
    xs, nhx = _conv_step(xs, cache["conv_x"], p["conv_x_w"], p["conv_x_b"])
    Bm, nhb = _conv_step(Bm, cache["conv_b"], p["conv_b_w"], p["conv_b_b"])
    Cm, nhc = _conv_step(Cm, cache["conv_c"], p["conv_c_w"], p["conv_c_b"])
    xs = xs.reshape(B, -1, P_)
    Bm = tp_vary(Bm, mesh).float()
    Cm = tp_vary(Cm, mesh).float()
    dt_ = F.softplus(dt.float() + p["dt_bias"][None, :])            # (B,H)
    A = -torch.exp(p["a_log"].float())
    dA = torch.exp(dt_ * A[None, :])                                 # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt_, Bm, xs.float())
    state = cache["state"] * dA[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", Cm, state)                      # (B,H,P)
    y = y + xs.float() * p["d_skip"][None, :, None]
    y = y.reshape(B, -1).to(x.dtype)
    out = _mixer_out(y, z, p, cfg, mesh, x.dtype)[:, None, :]
    return out, {"state": state, "conv_x": nhx.float(),
                 "conv_b": nhb.float(), "conv_c": nhc.float()}
