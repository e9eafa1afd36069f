"""Mixture-of-Experts FFN (deepseek-moe / moonshot style).

Capacity-based GShard-style dispatch expressed as einsums, as in the JAX
package: top-k routing per token, each (token, k) slot's position in its
expert's queue by a cumulative sum per group of ``group_size`` tokens,
slots past the capacity dropped, and the combine einsum reducing the
expert axis. Shared experts (deepseek: 2) run as an always-on dense FFN.
The port runs on one device, so the experts are not sharded (the JAX
package's expert parallelism over ``model`` is ROADMAP Queue 1 row 10.3).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.schema import ParamDef
from repro_torch.models import layers


def moe_schema(cfg: ModelConfig) -> Dict[str, Any]:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s: Dict[str, Any] = {
        "router": ParamDef((D, E), ("embed", None), init="lecun",
                           dtype=torch.float32),
        "w_gate": ParamDef((E, D, Fd), ("experts", "embed", None),
                           init="lecun"),
        "w_up": ParamDef((E, D, Fd), ("experts", "embed", None),
                         init="lecun"),
        "w_down": ParamDef((E, Fd, D), ("experts", None, "embed"),
                           init="lecun"),
    }
    if cfg.n_shared_experts:
        s["shared"] = layers.mlp_schema(cfg, cfg.d_ff * cfg.n_shared_experts)
    return s


def _capacity(tokens_per_group: int, n_experts: int, top_k: int,
              factor: float) -> int:
    c = int(tokens_per_group * top_k * factor / n_experts) + 1
    return max(c, top_k)


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    """Top-k routing. x: (..., D) → (weights (..., k), ids (..., k), aux).

    ``torch.topk`` does not promise ``lax.top_k``'s order among equal
    probabilities (lower index first); continuous inputs have no ties."""
    logits = torch.einsum("...d,de->...e", x.float(), router_w)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / (torch.sum(top_p, dim=-1, keepdim=True) + 1e-9)
    # Switch-style load-balance aux loss: E·Σ_e (mean router prob)·(routed
    # fraction)
    E = cfg.n_experts
    me = torch.mean(probs.reshape(-1, E), dim=0)
    ce = torch.mean(F.one_hot(top_ids.reshape(-1), E).to(torch.float32),
                    dim=0)
    aux = E * torch.sum(me * ce)
    return top_p, top_ids, aux


def moe_apply(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
              capacity_factor: float = 1.25, group_size: int = 512
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (output (B,S,D), aux load-balance loss, an f32
    scalar). The B·S tokens split into groups of ``min(group_size, B·S)``;
    a token count that is not a multiple of the group fails in the
    reshape, as in the JAX package."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    t = min(group_size, T)
    G = T // t
    xf = x.reshape(G, t, D)

    top_p, top_ids, aux = route(p["router"], xf, cfg)   # (G,t,K)

    C = _capacity(t, E, K, capacity_factor)
    # position of each (token, k) slot within its expert queue, per group
    e_onehot = F.one_hot(top_ids, E).to(torch.int32)    # (G,t,K,E)
    flat = e_onehot.reshape(G, t * K, E)
    pos_in_e = torch.cumsum(flat, dim=1) - flat          # (G,t*K,E)
    pos = torch.sum(pos_in_e.reshape(G, t, K, E) * e_onehot, dim=-1)
    keep = pos < C
    w = top_p * keep.to(top_p.dtype)

    # dispatch (G,t,E,C) in the compute dtype; combine through f32
    pos_oh = F.one_hot(torch.where(keep, pos, C).long(), C + 1
                       ).to(x.dtype)[..., :C]
    disp = torch.einsum("gtke,gtkc->gtec", e_onehot.to(x.dtype), pos_oh)
    comb = torch.einsum("gtke,gtkc,gtk->gtec", e_onehot.to(torch.float32),
                        pos_oh.to(torch.float32),
                        w.to(torch.float32)).to(x.dtype)

    # gather expert inputs, run experts, combine (expert axis reduced)
    xin = torch.einsum("gtec,gtd->gecd", disp, xf)                 # (G,E,C,D)
    g = layers._act(torch.einsum("gecd,edf->gecf", xin,
                                 p["w_gate"].to(x.dtype)), cfg.act)
    u = torch.einsum("gecd,edf->gecf", xin, p["w_up"].to(x.dtype))
    xout = torch.einsum("gecf,efd->gecd", g * u, p["w_down"].to(x.dtype))
    out = torch.einsum("gecd,gtec->gtd", xout, comb)

    out = out.reshape(B, S, D)
    if "shared" in p:
        out = out + layers.mlp_apply(p["shared"], x, cfg)
    return out, aux.to(torch.float32)
