"""Naive full-materialisation attention oracle."""

from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q: (B,S,H,hd) pre-scaled; k,v: (B,T,Hkv,hd). Returns (B,S,H,hd)."""
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qr = q.reshape(B, S, Hkv, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qr.float(), k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(S, device=q.device)
    kpos = torch.arange(T, device=q.device)
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos[:, None] >= kpos[None, :]
    if window:
        ok &= qpos[:, None] - kpos[None, :] < window
    s = torch.where(ok, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkh->bskgh", p, v)
    return o.reshape(B, S, H, hd)
