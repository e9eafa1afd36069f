"""Multi-head latent attention (MLA), DeepSeek-V3's, without query
compression (``q_lora_rank`` null, as Moonlight-16B-A3B publishes it).

With H heads, a q/k width of n ("nope", ``cfg.head_dim``) + r (rotary,
``cfg.qk_rope_dim``) per head, a value width v (``cfg.v_head_dim``) and a
latent of L (``cfg.kv_lora_rank``)::

    [q_n ‖ q_r]_h   = (x W_q)_h                       per head, n + r
    [c_kv ‖ k_r]    = x W_kva                         L + r, k_r shared
    [k_n ‖ v]_h     = (RMSNorm(c_kv) W_kvb)_h         per head, n + v
    q_r, k_r        = RoPE(q_r), RoPE(k_r)            interleaved pairs;
                                                      unrotated where
                                                      ``cfg.mla_nope``
    o_h             = softmax((q_h · k_h) / sqrt(n + r), causal) v_h
    out             = [o_1 ‖ … ‖ o_H] W_o

where q_h = [q_n ‖ q_r]_h and k_h = [k_n ‖ k_r]_h, the one k_r broadcast
over the heads. RoPE rotates the pairs (2i, 2i+1) of the rotary width at
frequency theta^(-2i/r), as DeepSeek-V3's code does (it de-interleaves the
pairs before a half-split rotation; the dot products are the same).
With ``cfg.mla_nope`` (Kimi Linear's ``mla_use_nope``) neither is rotated:
q_r and k_r are still projected and the scale stays 1/sqrt(n + r), so the
layer is the same attention with position left to the other layers.

Attention runs in the compute dtype, chunked over queries: each chunk's
scores (scaled, the causal mask added) are one batched product against
the keys up to the chunk's end only, so the masked half of the (S, S)
scores is never computed past the diagonal block; the softmax reads them
in f32 and writes probabilities in the compute dtype, as the published
code's ``softmax(dtype=float32).to(dtype)`` does. The layer keeps its
chunks' probabilities for the backward (the model's block checkpoint
recomputes them once). The whole layer is one ``mla.attention`` span.

Only the full-sequence forward of one device is here: ``prefill`` and
``decode_step`` refuse an MLA model (the latent KV cache is not built),
and so does a mesh.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.schema import ParamDef
from repro_torch.models.layers import LayerCtx, norm_schema, rms_norm
from repro_torch.runtime import trace


def mla_schema(cfg: ModelConfig) -> Dict[str, Any]:
    D, H = cfg.d_model, cfg.n_heads
    n, r, v, L = cfg.head_dim, cfg.qk_rope_dim, cfg.v_head_dim, \
        cfg.kv_lora_rank
    return {
        "wq": ParamDef((D, H * (n + r)), ("embed", "heads"), init="lecun"),
        "wkva": ParamDef((D, L + r), ("embed", None), init="lecun"),
        "kv_norm": norm_schema(cfg, L),
        "wkvb": ParamDef((L, H * (n + v)), (None, "heads"), init="lecun"),
        "wo": ParamDef((H * v, D), ("heads", "embed"), init="lecun"),
    }


def rope_pairs(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, r) with the pairs (2i, 2i+1) rotated by the angle of
    cos/sin (S, r/2) column i, in f32, back in x's dtype."""
    dt = x.dtype
    x = x.float().unflatten(-1, (-1, 2))
    x0, x1 = x[..., 0], x[..., 1]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s],
                       dim=-1).flatten(-2).to(dt)


def _chunk(q, k, v, q0: int, scale: float) -> torch.Tensor:
    """One query chunk: q (b, c, dq) at positions q0.. against the keys
    k (b, t, dq) and values v (b, t, dv) up to its end, t = q0 + c."""
    c, t = q.shape[1], k.shape[1]
    qpos = q0 + torch.arange(c, device=q.device)
    kpos = torch.arange(t, device=q.device)
    bias = torch.zeros((c, t), dtype=q.dtype, device=q.device)
    bias.masked_fill_(kpos[None, :] > qpos[:, None], float("-inf"))
    s = torch.baddbmm(bias, q, k.transpose(1, 2), alpha=scale)
    p = torch.softmax(s, dim=-1)
    return torch.bmm(p, v)


def causal_attention(q, k, v, scale: float, q_chunk: int) -> torch.Tensor:
    """q, k (B, H, S, dq), v (B, H, S, dv), contiguous → (B, H, S, dv).

    The queries split into chunks and the keys and values into blocks of
    the same length (``split``, so autograd joins each one's gradient
    once); a chunk reads the blocks up to its own. Nothing is checkpointed
    here: under ``remat="block"`` the layer's block is."""
    B, H, S, dq = q.shape
    c = q_chunk if S % q_chunk == 0 else S
    q3, k3, v3 = (t.reshape(B * H, S, t.shape[-1]) for t in (q, k, v))
    kb, vb = k3.split(c, dim=1), v3.split(c, dim=1)
    outs = [_chunk(qi, torch.cat(kb[:i + 1], dim=1),
                   torch.cat(vb[:i + 1], dim=1), i * c, scale)
            for i, qi in enumerate(q3.split(c, dim=1))]
    return torch.cat(outs, dim=1).reshape(B, H, S, -1)


def mla_apply(p, x: torch.Tensor, ctx: LayerCtx) -> torch.Tensor:
    """Full-sequence causal MLA of x (B, S, D) → (B, S, D)."""
    cfg = ctx.cfg
    if ctx.mesh is not None:
        raise NotImplementedError("MLA runs on one device: no mesh")
    with trace.span("mla.attention", x):
        B, S, _ = x.shape
        H, n, r, dv = (cfg.n_heads, cfg.head_dim, cfg.qk_rope_dim,
                       cfg.v_head_dim)
        dt = x.dtype
        cos, sin = ctx.rope_local
        q = (x @ p["wq"].to(dt)).reshape(B, S, H, n + r)
        kva = x @ p["wkva"].to(dt)
        c_kv = rms_norm(kva[..., :cfg.kv_lora_rank], p["kv_norm"]["w"],
                        cfg.norm_eps, cfg.rms_zero_centered)
        k_r = kva[..., None, cfg.kv_lora_rank:]
        kv = (c_kv @ p["wkvb"].to(dt)).reshape(B, S, H, n + dv)
        if not cfg.mla_nope:
            k_r = rope_pairs(k_r, cos, sin)
            q = torch.cat([q[..., :n], rope_pairs(q[..., n:], cos, sin)], -1)
        k = torch.cat([kv[..., :n], k_r.expand(B, S, H, r)], -1)
        heads = lambda t: t.transpose(1, 2).contiguous()  # noqa: E731
        o = causal_attention(heads(q), heads(k), heads(kv[..., n:]),
                             (n + r) ** -0.5, ctx.q_chunk)
        return o.transpose(1, 2).reshape(B, S, H * dv) @ p["wo"].to(dt)
