"""Mixture-of-Experts FFN (deepseek-moe / moonshot style).

Capacity-based GShard-style dispatch expressed as einsums, as in the JAX
package: top-k routing per token, each (token, k) slot's position in its
expert's queue by a cumulative sum per group of ``group_size`` tokens,
slots past the capacity dropped, and the combine einsum reducing the
expert axis. Shared experts (deepseek: 2) run as an always-on dense FFN.

On a mesh the experts go over ``model`` (EP): each rank keeps ``E/tp``
experts of ``w_gate``, ``w_up`` and ``w_down``. Routing runs on the
replicated tokens; the rank dispatches to and runs its own experts, the
combine reduces the expert axis locally, and one psum over ``model`` of
the combined (B, S, D) crosses the axis — bytes ∝ tokens·D, not
tokens·top_k·D (the CGTrans dataflow). The shared experts run as the
MLP does (tensor-parallel). The batch axes split the tokens: the routing
groups and the load-balance loss stay those of the whole batch (a group
that spans data ranks takes its queue offsets from the ranks before it,
and the loss's means are summed over the batch axes).

**DeepSeek-V3 MoE** (``cfg.held_experts`` > 0, the port's own): the
router is DeepSeek-V3's (``sigmoid_route``), and the layer
holds experts ``[held_first, held_first + held_experts)`` of the router's
``n_experts`` (one chip's share under expert parallelism; all of them
where ``held_experts == n_experts``), routes every token over all of
them, and adds what its own experts give for every slot routed to them:
no slot is dropped. The (token, k) slots are sorted by expert (the held
ones first, in expert order), their inputs gathered, the held experts run
as grouped GEMMs over the sorted rows (``expert_mm``, ``torch._grouped_mm``
with the per-expert row offsets), and each token sums its slots' results
with their routing weights, gathered through the sort's inverse. Shapes
are static (every slot has a row; the rows past the held experts' are
never computed, and masked out both ways) and nothing waits for the
host. The absent experts' part is left out, as the chip of a
deployment leaves it to the others. Spans: ``moe.route``, ``moe.experts``,
``moe.combine``; counter ``moe.dispatch.bytes``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.logical import batch_axes, dp_size
from repro_torch.common.schema import ParamDef
from repro_torch.core import collectives
from repro_torch.models import layers
from repro_torch.runtime import trace


def moe_schema(cfg: ModelConfig) -> Dict[str, Any]:
    """The router over all ``n_experts``; the expert weights of the held
    ones (every expert on the capacity path); with a held share, the
    router's selection bias, a buffer."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    El = cfg.held_experts or E
    s: Dict[str, Any] = {
        "router": ParamDef((D, E), ("embed", None), init="lecun",
                           dtype=torch.float32),
        "w_gate": ParamDef((El, D, Fd), ("experts", "embed", None),
                           init="lecun"),
        "w_up": ParamDef((El, D, Fd), ("experts", "embed", None),
                         init="lecun"),
        "w_down": ParamDef((El, Fd, D), ("experts", None, "embed"),
                           init="lecun"),
    }
    if cfg.held_experts:
        s["bias"] = ParamDef((E,), (None,), init="zeros", trainable=False)
    if cfg.n_shared_experts:
        s["shared"] = layers.mlp_schema(cfg, cfg.d_ff * cfg.n_shared_experts)
    return s


def _capacity(tokens_per_group: int, n_experts: int, top_k: int,
              factor: float) -> int:
    c = int(tokens_per_group * top_k * factor / n_experts) + 1
    return max(c, top_k)


def route(router_w: torch.Tensor, x: torch.Tensor, cfg: ModelConfig,
          mesh=None, rules=None):
    """Top-k routing. x: (..., D) → (weights (..., k), ids (..., k), aux).

    ``torch.topk`` does not promise ``lax.top_k``'s order among equal
    probabilities (lower index first); continuous inputs have no ties.
    On a mesh ``x`` is this rank's tokens and the aux loss's means cover
    every rank's (the ranks the batch splits over under ``rules``)."""
    # a bf16 router (serving parameters) promotes to f32, as JAX's einsum
    logits = torch.einsum("...d,de->...e", x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_ids = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / (torch.sum(top_p, dim=-1, keepdim=True) + 1e-9)
    # Switch-style load-balance aux loss: E·Σ_e (mean router prob)·(routed
    # fraction)
    E = cfg.n_experts
    hot = F.one_hot(top_ids.reshape(-1), E).to(torch.float32)
    if mesh is not None and dp_size(mesh, rules) > 1:
        dp = batch_axes(mesh, rules)
        n = probs.reshape(-1, E).shape[0] * dp_size(mesh, rules)
        me = collectives.psum(probs.reshape(-1, E).sum(0), mesh,
                              axis=dp) / n
        ce = collectives.all_reduce(hot.sum(0), mesh, axis=dp) / (
            hot.shape[0] * dp_size(mesh, rules))
    else:
        me = torch.mean(probs.reshape(-1, E), dim=0)
        ce = torch.mean(hot, dim=0)
    aux = E * torch.sum(me * ce)
    return top_p, top_ids, aux


def sigmoid_route(router_w: torch.Tensor, bias: torch.Tensor,
                  x: torch.Tensor, cfg: ModelConfig, seq_len: int):
    """DeepSeek-V3's router (noaux_tc, one group). x: (T, D), the tokens
    of T / ``seq_len`` whole sequences → (weights (T, k) f32, ids (T, k),
    aux f32 scalar).

    s = sigmoid(x W_r) in f32; the k experts are chosen on s + b (b the
    selection bias, which takes no gradient); the weights are the chosen
    s, without b, over their sum, times ``cfg.routed_scale``. aux is the
    sequence-wise balance loss (arXiv:2412.19437 eq. 17–20, without its
    alpha: ``loss_fn`` scales it by ``router_aux_coef``): per sequence
    Σ_i f_i P_i with f_i = E/(k·S) · the sequence's slots on expert i and
    P_i = the mean over its tokens of s_i / Σ_j s_j; the mean over the
    sequences."""
    E, K = cfg.n_experts, cfg.top_k
    s = torch.sigmoid(x.float() @ router_w.float())
    ids = torch.topk(s + bias.float(), K, dim=-1).indices
    w = torch.gather(s, 1, ids)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-20) * cfg.routed_scale
    n_seq = x.shape[0] // seq_len
    hits = torch.zeros((n_seq, E), dtype=torch.float32, device=x.device)
    hits.scatter_add_(1, ids.reshape(n_seq, -1),
                      torch.ones((n_seq, seq_len * K), device=x.device))
    f = hits * (E / (K * seq_len))
    P = (s / torch.sum(s, dim=-1, keepdim=True)).reshape(
        n_seq, seq_len, E).mean(dim=1)
    return w, ids, torch.mean(torch.sum(f * P, dim=-1))


def expert_mm(x: torch.Tensor, w: torch.Tensor,
              offs: torch.Tensor) -> torch.Tensor:
    """Grouped GEMM: rows ``[offs[g-1], offs[g])`` of x (N, K) times w[g]
    (G, K, M) → (N, M); rows past ``offs[-1]`` are left unwritten."""
    return torch._grouped_mm(x, w, offs=offs)


def _dropless(p: Dict[str, Any], x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dropless share (module docstring). x: (B, S, D)."""
    B, S, D = x.shape
    T, K, El = B * S, cfg.top_k, cfg.held_experts
    x2 = x.reshape(T, D)
    with trace.span("moe.route", x):
        w, ids, aux = sigmoid_route(p["router"], p["bias"], x2, cfg, S)
    with trace.span("moe.experts", x):
        N = T * K
        trace.add("moe.dispatch.bytes", N * D * x.element_size())
        local = ids - cfg.held_first
        held = (local >= 0) & (local < El)                    # (T, K)
        key = torch.where(held, local, El).reshape(-1)
        order = torch.argsort(key, stable=True)
        counts = torch.zeros(El + 1, dtype=torch.int64, device=x.device)
        counts.scatter_add_(0, key, torch.ones_like(key))
        offs = torch.cumsum(counts[:El], 0).to(torch.int32)
        # the sorted rows past the held experts' are never computed: their
        # inputs are zero, and their gradients (left unwritten by the
        # grouped GEMM's backward) never reach the tokens
        valid = (torch.arange(N, device=x.device) < offs[-1])[:, None]
        tok = torch.div(order, K, rounding_mode="floor")
        xs = torch.where(valid, x2[tok], 0)
        dt = x.dtype
        w_gu = torch.cat([p["w_gate"], p["w_up"]], dim=-1).to(dt)
        gu = expert_mm(xs, w_gu, offs)
        Fd = gu.shape[-1] // 2
        h = layers._act(gu[:, :Fd], cfg.act) * gu[:, Fd:]
        y = expert_mm(h, p["w_down"].to(dt), offs)
    with trace.span("moe.combine", x):
        # each token gathers its k slots' rows (the sort's inverse): no
        # two slots write one place
        inv = torch.empty_like(order).scatter_(
            0, order, torch.arange(N, device=x.device))
        yk = torch.where(held[..., None], y[inv].reshape(T, K, D), 0)
        out = torch.sum(yk * w[..., None], dim=1)
    return out.to(dt).reshape(B, S, D), aux


def _groups(T_local: int, group_size: int, mesh, rules=None):
    """(groups here, tokens per group here, ranks a group spans, tokens
    per group): the JAX package's groups of ``min(group_size, T)`` of the
    whole batch's T tokens, over this rank's contiguous ``T_local``."""
    dp = dp_size(mesh, rules) if mesh is not None else 1
    t = min(group_size, T_local * dp)
    if dp == 1 or T_local % t == 0:
        return T_local // t, t, 1, t
    if t % T_local == 0:
        return 1, T_local, t // T_local, t
    raise ValueError(f"{T_local} tokens per rank neither hold whole "
                     f"routing groups of {t} nor tile one")


def moe_apply(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
              capacity_factor: float = 1.25, group_size: int = 512,
              mesh=None, rules=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D). Returns (output (B,S,D), aux load-balance loss, an f32
    scalar). The B·S tokens split into groups of ``min(group_size, B·S)``;
    a token count that is not a multiple of the group fails in the
    reshape, as in the JAX package. On a mesh ``x`` is this rank's rows
    (its block over the batch axes of ``rules``, default
    ``DEFAULT_RULES``; all of them under a table with ``batch=()``) and
    ``p`` its blocks. A dropless share (``cfg.held_experts``) ignores the
    capacity and the groups and runs on one device."""
    if cfg.held_experts:
        if mesh is not None:
            raise NotImplementedError("the dropless expert share runs on "
                                      "one device: no mesh")
        out, aux = _dropless(p, x, cfg)
        shared = p.get("shared")
        if shared is not None:
            out = out + layers.mlp_apply(shared, x, cfg)
        return out, aux
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    tp = layers.tp_size(mesh)
    shared = p.get("shared")
    if mesh is not None:
        p = layers.ready_params({k: v for k, v in p.items()
                                 if k != "shared"}, moe_schema(cfg), mesh,
                                keep=("experts",))
    G, t, span, t_group = _groups(B * S, group_size, mesh, rules)
    xf = x.reshape(G, t, D)

    top_p, top_ids, aux = route(p["router"], xf, cfg, mesh, rules)

    C = _capacity(t_group, E, K, capacity_factor)
    # position of each (token, k) slot within its expert queue, per group
    e_onehot = F.one_hot(top_ids, E).to(torch.int32)    # (G,t,K,E)
    flat = e_onehot.reshape(G, t * K, E)
    pos_in_e = torch.cumsum(flat, dim=1) - flat          # (G,t*K,E)
    if span > 1:
        # the group began on an earlier rank: queue past its slots there
        dp = batch_axes(mesh, rules)
        counts = collectives.all_gather(flat.sum(1), mesh, axis=dp)
        me = mesh.axis_index(dp)
        pos_in_e = pos_in_e + counts[me - me % span:me].sum(0)[:, None]
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
    x_in = xf
    if tp > 1:
        # this rank's experts: their dispatch and combine columns
        El = E // tp
        e0 = mesh.axis_index("model") * El
        disp = disp[:, :, e0:e0 + El]
        comb = collectives.pvary(comb, mesh, axis="model")[:, :, e0:e0 + El]
        x_in = collectives.pvary(xf, mesh, axis="model")

    # gather expert inputs, run experts, combine (expert axis reduced)
    xin = torch.einsum("gtec,gtd->gecd", disp, x_in)              # (G,E,C,D)
    g = layers._act(torch.einsum("gecd,edf->gecf", xin,
                                 p["w_gate"].to(x.dtype)), cfg.act)
    u = torch.einsum("gecd,edf->gecf", xin, p["w_up"].to(x.dtype))
    xout = torch.einsum("gecf,efd->gecd", g * u, p["w_down"].to(x.dtype))
    out = torch.einsum("gecd,gtec->gtd", xout, comb)
    if tp > 1:
        out = collectives.psum(out, mesh, axis="model")

    out = out.reshape(B, S, D)
    if shared is not None:
        out = out + layers.mlp_apply(shared, x, cfg, mesh)
    return out, aux.to(torch.float32)
