"""Shared transformer layer library (the attention-family kinds).

Pure functions over dicts of tensors, as in the JAX package:
``*_schema(cfg)`` declares parameters, ``*_apply`` runs a full sequence,
``*_decode`` runs one token against a cache. Attention is chunked over
queries (scores never materialise at (S, T) for long sequences). With
``LayerCtx.use_flash`` set, full-sequence self-attention goes through the
flash kernel (``repro_torch.kernels.flash_attention``) instead; prefill and
decode attention stay plain, as they are plain XLA in the JAX package.

The port runs on one device: ``LayerCtx`` has no mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.schema import ParamDef

NEG_INF = -2.3819763e38  # the finite mask value of the JAX package


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             zero_centered: bool) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = (1.0 + w) if zero_centered else w
    return (x * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def norm_schema(cfg: ModelConfig, d: int) -> Dict[str, ParamDef]:
    if cfg.norm_type == "ln":
        return {"w": ParamDef((d,), (None,), init="ones"),
                "b": ParamDef((d,), (None,), init="zeros")}
    init = "zeros" if cfg.rms_zero_centered else "ones"
    return {"w": ParamDef((d,), (None,), init=init)}


def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_type == "ln":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps, cfg.rms_zero_centered)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, hd: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, shape positions.shape + (hd//2,). float32."""
    dev = positions.device
    freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=dev) / hd))
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (S, hd//2) or broadcastable."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    # tables broadcast over the head axis: (S, hd/2) -> (S, 1, hd/2)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# layer context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerCtx:
    cfg: ModelConfig
    rope_local: Tuple[torch.Tensor, torch.Tensor]   # window/default theta
    rope_global: Tuple[torch.Tensor, torch.Tensor]  # gemma3 global theta
    memory: Optional[torch.Tensor] = None   # encoder memory (B, M, D)
    pos: Optional[int] = None               # decode: current position
    q_chunk: int = 1024
    use_flash: bool = False                 # full attn through the kernel


def rope_for(kind: str, ctx: LayerCtx):
    if kind == "attn" and ctx.cfg.rope_theta_global:
        return ctx.rope_global
    return ctx.rope_local


# ---------------------------------------------------------------------------
# core chunked attention
# ---------------------------------------------------------------------------

def _mask_bias(qpos, kpos, *, causal: bool, window: int) -> torch.Tensor:
    """(len(qpos), len(kpos)) additive bias of 0 / NEG_INF."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= qpos[:, None] >= kpos[None, :]
    if window:
        ok &= qpos[:, None] - kpos[None, :] < window
    return torch.where(ok, 0.0, NEG_INF).float()


def _softmax_pv(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis of f32 scores, rounded to v's dtype, times
    v: (b, k, g, q, t) · (b, t, k, h) → (b, q, k, g, h)."""
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgqt,btkh->bqkgh", p, v)


def _scores(qi: torch.Tensor, k: torch.Tensor, softcap: float) -> torch.Tensor:
    """(b, q, k, g, h) · (b, t, k, h) → f32 scores (b, k, g, q, t)."""
    s = torch.einsum("bqkgh,btkh->bkgqt", qi.float(), k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    return s


def chunked_attention(
    q: torch.Tensor,             # (B, S, H, hd) — already scaled
    k: torch.Tensor,             # (B, T, Hkv, hd)
    v: torch.Tensor,             # (B, T, Hkv, hd)
    *,
    causal: bool,
    window: int = 0,
    softcap: float = 0.0,
    q_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qc = q_chunk if S % q_chunk == 0 else S
    qr = q.reshape(B, S // qc, qc, Hkv, G, hd)
    kpos = torch.arange(T, device=q.device)
    outs = []
    for i in range(S // qc):
        s = _scores(qr[:, i], k, softcap)
        qpos = q_offset + i * qc + torch.arange(qc, device=q.device)
        s = s + _mask_bias(qpos, kpos, causal=causal, window=window)
        outs.append(_softmax_pv(s, v))
    return torch.stack(outs, dim=1).reshape(B, S, H, hd)


def decode_attention(
    q: torch.Tensor,             # (B, 1, H, hd) — already scaled
    k: torch.Tensor,             # (B, T, Hkv, hd) cache
    v: torch.Tensor,
    kv_positions: torch.Tensor,  # (T,) absolute token position per slot, -1 invalid
    pos: int,                    # current position
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    s = _scores(q.reshape(B, 1, Hkv, G, hd), k, softcap)
    ok = (kv_positions >= 0) & (kv_positions <= pos)
    if window:
        ok &= kv_positions > pos - window
    s = torch.where(ok, s, torch.tensor(NEG_INF, device=s.device))
    return _softmax_pv(s, v).reshape(B, 1, H, hd)


# ---------------------------------------------------------------------------
# attention layer (kinds: attn, local, enc, and the attention of dec)
# ---------------------------------------------------------------------------

def attn_schema(cfg: ModelConfig, *, cross: bool = False,
                gated: bool = False) -> Dict[str, Any]:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s: Dict[str, Any] = {
        "wq": ParamDef((D, H * hd), ("embed", "heads"), init="lecun"),
        "wk": ParamDef((D, Hkv * hd), ("embed", "kv_heads"), init="lecun"),
        "wv": ParamDef((D, Hkv * hd), ("embed", "kv_heads"), init="lecun"),
        "wo": ParamDef((H * hd, D), ("heads", "embed"), init="lecun"),
    }
    if cfg.qkv_bias or cfg.mlp_bias:
        s["bq"] = ParamDef((H * hd,), ("heads",), init="zeros")
        s["bk"] = ParamDef((Hkv * hd,), ("kv_heads",), init="zeros")
        s["bv"] = ParamDef((Hkv * hd,), ("kv_heads",), init="zeros")
    if cfg.mlp_bias:
        s["bo"] = ParamDef((D,), (None,), init="zeros")
    norm_init = "zeros" if cfg.rms_zero_centered else "ones"
    if cfg.qk_norm:
        s["q_norm"] = ParamDef((hd,), (None,), init=norm_init)
        s["k_norm"] = ParamDef((hd,), (None,), init=norm_init)
    if gated:  # llama-3.2-vision cross-attn gates
        s["gate_attn"] = ParamDef((1,), (None,), init="zeros")
    return s


def _proj(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., D) @ w (D, N) [+ b] in x's dtype."""
    out = x @ w.to(x.dtype)
    return out if b is None else out + b.to(x.dtype)


def _qkv(p, x, mem, cfg: ModelConfig):
    """Project q from x and k, v from mem (mem = x for self-attention)."""
    B, S, _ = x.shape
    M = mem.shape[1]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, S, H, hd)
    k = _proj(mem, p["wk"], p.get("bk")).reshape(B, M, Hkv, hd)
    v = _proj(mem, p["wv"], p.get("bv")).reshape(B, M, Hkv, hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps, cfg.rms_zero_centered)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps, cfg.rms_zero_centered)
    return q, k, v


def _q_scale(cfg: ModelConfig) -> float:
    if cfg.query_pre_attn_scalar:
        return cfg.query_pre_attn_scalar ** -0.5
    return cfg.hd ** -0.5


def _out_proj(p, o, x_dtype):
    B, S = o.shape[0], o.shape[1]
    return _proj(o.reshape(B, S, -1).to(x_dtype), p["wo"].to(x_dtype),
                 p.get("bo"))


def _self_attn_args(p, x, ctx: LayerCtx, kind: str):
    cfg = ctx.cfg
    q, k, v = _qkv(p, x, x, cfg)
    cos, sin = rope_for(kind, ctx)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    mask = dict(causal=kind != "enc",
                window=cfg.window if kind == "local" else 0,
                softcap=cfg.attn_logit_softcap)
    return q, k, v, mask


def attn_apply(p, x, ctx: LayerCtx, *, kind: str) -> torch.Tensor:
    """Full-sequence attention for kinds attn/local/enc. Returns (B,S,D)."""
    q, k, v, mask = _self_attn_args(p, x, ctx, kind)
    q = q * _q_scale(ctx.cfg)
    if ctx.use_flash:
        from repro_torch.kernels.flash_attention import ops as flash_ops
        o = flash_ops.flash_attention(q, k, v, **mask)
    else:
        o = chunked_attention(q, k, v, **mask, q_chunk=ctx.q_chunk)
    return _out_proj(p, o, x.dtype)


def cross_attn_apply(p, x, ctx: LayerCtx) -> torch.Tensor:
    """Cross-attention to ctx.memory. No rope, no causal mask."""
    cfg = ctx.cfg
    q, k, v = _qkv(p, x, ctx.memory.to(x.dtype), cfg)
    o = chunked_attention(q * _q_scale(cfg), k, v, causal=False,
                          q_chunk=ctx.q_chunk)
    out = _out_proj(p, o, x.dtype)
    if "gate_attn" in p:
        out = torch.tanh(p["gate_attn"].to(x.dtype)) * out
    return out


# --- caches ----------------------------------------------------------------

def _cache_def(cfg: ModelConfig, batch: int, T: int) -> ParamDef:
    return ParamDef((batch, T, cfg.n_kv_heads, cfg.hd),
                    ("batch", None, None, None), init="zeros",
                    dtype=compute_dtype(cfg))


def attn_cache_schema(cfg: ModelConfig, batch: int, seq_len: int, *,
                      kind: str) -> Dict[str, ParamDef]:
    """Decode KV cache; a local layer whose window is shorter than the
    sequence keeps a ring of ``window`` slots."""
    is_ring = kind == "local" and cfg.window and cfg.window < seq_len
    T = cfg.window if is_ring else seq_len
    return {"k": _cache_def(cfg, batch, T), "v": _cache_def(cfg, batch, T)}


def cross_cache_schema(cfg: ModelConfig, batch: int,
                       mem_len: int) -> Dict[str, ParamDef]:
    return {"k": _cache_def(cfg, batch, mem_len),
            "v": _cache_def(cfg, batch, mem_len)}


def _ring_slots(pos: int, W: int, device=None) -> torch.Tensor:
    """Absolute token position held by each ring slot at decode position
    pos."""
    j = torch.arange(W, device=device)
    return pos - torch.remainder(pos - j, W)


def attn_prefill(p, x, ctx: LayerCtx, *, kind: str, cache_len: int):
    """Full-seq attention that also returns the populated decode cache."""
    cfg = ctx.cfg
    q, k, v, mask = _self_attn_args(p, x, ctx, kind)
    o = chunked_attention(q * _q_scale(cfg), k, v, **mask,
                          q_chunk=ctx.q_chunk)
    S = x.shape[1]
    if kind == "local" and cfg.window and cfg.window < cache_len:
        W = cfg.window
        slots = (S - W + torch.arange(W, device=x.device)) % W
        cache = {}
        for name, t in (("k", k), ("v", v)):
            ring = torch.zeros_like(t[:, S - W:])
            ring[:, slots] = t[:, S - W:]
            cache[name] = ring
    else:
        pad = (0, 0, 0, 0, 0, cache_len - S)
        cache = {"k": F.pad(k, pad), "v": F.pad(v, pad)}
    return _out_proj(p, o, x.dtype), cache


def attn_decode(p, x, cache, ctx: LayerCtx, *, kind: str):
    """One-token attention against the cache. x: (B,1,D). Writes the new
    key and value into ``cache`` in place (one slot each) and returns
    (output, cache)."""
    cfg = ctx.cfg
    pos = ctx.pos
    q, k, v = _qkv(p, x, x, cfg)
    cos, sin = rope_for(kind, ctx)  # tables for the single current position
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    T = cache["k"].shape[1]
    is_ring = kind == "local" and cfg.window and cfg.window == T
    slot = (pos % T) if is_ring else pos
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    if is_ring:
        kv_pos = _ring_slots(pos, T, x.device)
    else:
        kv_pos = torch.arange(T, device=x.device)
    o = decode_attention(q * _q_scale(cfg), cache["k"], cache["v"], kv_pos,
                         pos, window=cfg.window if kind == "local" else 0,
                         softcap=cfg.attn_logit_softcap)
    return _out_proj(p, o, x.dtype), cache


def cross_attn_decode(p, x, cache, ctx: LayerCtx):
    """Cross-attention during decode: static precomputed memory K/V."""
    cfg = ctx.cfg
    B = x.shape[0]
    q = _proj(x, p["wq"], p.get("bq")).reshape(B, 1, cfg.n_heads, cfg.hd)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps, cfg.rms_zero_centered)
    T = cache["k"].shape[1]
    o = decode_attention(q * _q_scale(cfg), cache["k"], cache["v"],
                         torch.arange(T, device=x.device), T)
    out = _out_proj(p, o, x.dtype)
    if "gate_attn" in p:
        out = torch.tanh(p["gate_attn"].to(x.dtype)) * out
    return out, cache


def cross_build_cache(p, memory, cfg: ModelConfig):
    """Precompute cross-attention K/V from encoder memory."""
    B, M, _ = memory.shape
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    k = _proj(memory, p["wk"], p.get("bk")).reshape(B, M, Hkv, hd)
    v = _proj(memory, p["wv"], p.get("bv")).reshape(B, M, Hkv, hd)
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps, cfg.rms_zero_centered)
    dt = compute_dtype(cfg)
    return {"k": k.to(dt), "v": v.to(dt)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_schema(cfg: ModelConfig, d_ff: Optional[int] = None, *,
               gated_tag: bool = False) -> Dict[str, Any]:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    if cfg.mlp_gated:
        # gate and up fused into one (D, 2, F) projection, as in the JAX
        # package
        s = {"w_gateup": ParamDef((D, 2, Fd), ("embed", None, "ff"),
                                  init="lecun"),
             "w_down": ParamDef((Fd, D), ("ff", "embed"), init="lecun")}
    else:
        s = {"w_up": ParamDef((D, Fd), ("embed", "ff"), init="lecun"),
             "w_down": ParamDef((Fd, D), ("ff", "embed"), init="lecun")}
        if cfg.mlp_bias:
            s["b_up"] = ParamDef((Fd,), ("ff",), init="zeros")
            s["b_down"] = ParamDef((D,), (None,), init="zeros")
    if gated_tag:  # llama-3.2-vision cross layers gate their FFN too
        s["gate_ffn"] = ParamDef((1,), (None,), init="zeros")
    return s


def _act(x, kind: str):
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp_apply(p, x, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_gated:
        gu = torch.einsum("bsd,dtf->bstf", x, p["w_gateup"].to(x.dtype))
        out = _proj(_act(gu[:, :, 0], cfg.act) * gu[:, :, 1], p["w_down"])
    else:
        u = _proj(x, p["w_up"], p.get("b_up"))
        out = _proj(_act(u, cfg.act), p["w_down"], p.get("b_down"))
    if "gate_ffn" in p:
        out = torch.tanh(p["gate_ffn"].to(x.dtype)) * out
    return out
