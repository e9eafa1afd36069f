"""Plain float32 PyTorch reference of Moonlight-16B-A3B's training loss,
its gradients and the optimizer step, on one chip's share.

Moonlight-16B-A3B (huggingface.co/moonshotai/Moonlight-16B-A3B,
config.json) is the DeepSeek-V3 block (arXiv:2412.19437): a dense first
layer, then MoE layers, every layer with multi-head latent attention.
Written from the published description with plain ``torch`` operations:
it imports nothing of the program under test and nothing of JAX. Callers
run it with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False).

For a hidden state x (T, D) of T tokens, each layer is

    h  = x + MLA(RMSNorm(x))
    x' = h + FFN(RMSNorm(h))

**MLA** (``q_lora_rank`` null), per head h of H:
``[q_n ‖ q_r]_h = (x W_q)_h``; ``[c ‖ k_r] = x W_kva`` with c
``kv_lora_rank`` wide; ``[k_n ‖ v]_h = (RMSNorm(c) W_kvb)_h``; RoPE on
q_r and on the one k_r shared by every head, rotating the pairs
(2i, 2i+1) by position · theta^(-2i/r) (DeepSeek-V3's interleaved
layout); causal softmax of ``q_h · k_h / sqrt(n + r)`` with
``q_h = [q_n ‖ q_r]``, ``k_h = [k_n ‖ k_r]``; ``o = [o_1 ‖ …] W_o``.

**FFN**: layer 0 a SwiGLU MLP, ``(silu(x W_g) ⊙ x W_u) W_d``. The others
MoE: s = sigmoid(x W_r) over all ``router_width`` experts; the top
``num_experts_per_tok`` experts by s + b (b the per-expert selection
bias); weights g = the chosen s (without b) over their sum, times
``routed_scaling_factor``; out = Σ over the chosen experts that this
share holds of g · SwiGLU_e(x), plus the shared experts' SwiGLU (one MLP
of width ``n_shared_experts`` · ``moe_intermediate_size``). Every slot is
computed (no capacity). Balance loss per MoE layer, the sequence-wise one
(§2.1.2 of the paper): per sequence of S tokens Σ_i f_i P_i, f_i = E/(K·S)
· the count of the sequence's slots on expert i, P_i the mean over its
tokens of s_i / Σ_j s_j; the mean over the sequences.

**Loss**: the mean cross-entropy of the untied head's logits over the
labels, plus ``aux_alpha`` times the layers' balance losses summed.

**Departures from Moonlight as trained**, each also in the port: the
selection bias is fixed (no per-step bias update); AdamW
(``repro_torch.optim.adamw_update``'s arithmetic, ``AdamW`` below) in place
of Muon; the share and slice cut: the layer holds experts
``[held_first, held_first + n_routed_experts)`` of ``router_width``, and
what the other experts would add is left out, as the chip of an
expert-parallel deployment leaves it to its peers; the vocabulary is the
chip's ``vocab_size`` rows, tokens and labels drawn from them.

The parameters are a nested dict laid out as the port lays them out
(``embed.table``, ``unembed.table``, ``final_norm.w``, and under
``stack`` the dense layer ``prefix_0`` and the MoE layers stacked on a
leading axis in ``blocks.p0``, or unrolled as ``prefix_i``): norms
``{"w"}``; attention ``wq`` (D, H(n+r)), ``wkva`` (D, L+r),
``kv_norm.w``, ``wkvb`` (L, H(n+v)), ``wo`` (Hv, D), each head's columns
contiguous in the order above; an MLP ``w_gateup`` (D, 2, F) (gate, up)
and ``w_down`` (F, D); the MoE ``router`` (D, E), ``bias`` (E,),
``w_gate`` and ``w_up`` (held, D, F), ``w_down`` (held, F, D) and
``shared``.

At full size the loss runs layer by layer with recomputation (each layer,
each attention query chunk and each loss chunk checkpointed), so that it
fits beside the parameters, their gradients and AdamW's moments.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_CHUNK = 1024        # attention queries per checkpointed chunk
LOSS_CHUNK = 2048     # tokens per checkpointed chunk of the loss


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, r): the pairs (2i, 2i+1) rotated by position ·
    theta^(-2i/r)."""
    S, r = x.shape[1], x.shape[-1]
    freq = theta ** (-torch.arange(0, r, 2, dtype=torch.float32,
                                   device=x.device) / r)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freq
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * c - b * s, b * c + a * s], dim=-1).flatten(-2)


def _attend(q, k, v, lo: int, scale: float):
    """Queries q (B, H, c, d) at positions lo.. against every key."""
    s = (q @ k.transpose(-1, -2)) * scale
    qpos = lo + torch.arange(q.shape[2], device=q.device)
    kpos = torch.arange(k.shape[2], device=q.device)
    s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    return torch.softmax(s, dim=-1) @ v


def mla(p: Dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Causal MLA of x (B, S, D)."""
    B, S, _ = x.shape
    H, n, r = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
               cfg["qk_rope_head_dim"])
    dv, L = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = (x @ p["wq"]).reshape(B, S, H, n + r)
    ckv = x @ p["wkva"]
    c = rms_norm(ckv[..., :L], p["kv_norm"]["w"], cfg["rms_norm_eps"])
    k_r = rope(ckv[..., None, L:], cfg["rope_theta"]).expand(B, S, H, r)
    kv = (c @ p["wkvb"]).reshape(B, S, H, n + dv)
    q = torch.cat([q[..., :n], rope(q[..., n:], cfg["rope_theta"])], -1)
    k = torch.cat([kv[..., :n], k_r], -1)
    q, k, v = (t.transpose(1, 2) for t in (q, k, kv[..., n:]))
    c = Q_CHUNK if S % Q_CHUNK == 0 else S
    o = torch.cat([checkpoint(_attend, q[:, :, lo:lo + c], k, v, lo,
                              (n + r) ** -0.5, use_reentrant=False)
                   for lo in range(0, S, c)], dim=2)
    return o.transpose(1, 2).reshape(B, S, H * dv) @ p["wo"]


def swiglu(p: Dict, x: torch.Tensor) -> torch.Tensor:
    w = p["w_gateup"]
    return (F.silu(x @ w[:, 0]) * (x @ w[:, 1])) @ p["w_down"]


def route(p: Dict, x: torch.Tensor, cfg: dict, S: int):
    """x (T, D) of T / S sequences → (weights (T, K), ids (T, K), the
    sequence-wise balance loss)."""
    E, K = cfg["router_width"], cfg["num_experts_per_tok"]
    s = torch.sigmoid(x @ p["router"])
    ids = torch.topk(s + p["bias"], K, dim=-1).indices
    g = s.gather(1, ids)
    g = g / (g.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    n_seq = x.shape[0] // S
    f = F.one_hot(ids.reshape(n_seq, S * K), E).sum(1).float() * (E / (K * S))
    P = (s / s.sum(-1, keepdim=True)).reshape(n_seq, S, E).mean(1)
    return g, ids, (f * P).sum(-1).mean()


def moe(p: Dict, x: torch.Tensor, cfg: dict):
    """The MoE FFN of x (B, S, D) on this share → (out, balance loss)."""
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    g, ids, aux = route(p, x2, cfg, S)
    out = torch.zeros_like(x2)
    for j in range(cfg["n_routed_experts"]):
        tok, slot = torch.nonzero(ids == cfg["held_first"] + j,
                                  as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x2[tok]
        y = (F.silu(xe @ p["w_gate"][j]) * (xe @ p["w_up"][j])) \
            @ p["w_down"][j]
        out = out.index_add(0, tok, y * g[tok, slot][:, None])
    return (out + swiglu(p["shared"], x2)).reshape(B, S, D), aux


def layer(p: Dict, x: torch.Tensor, cfg: dict, dense: bool):
    eps = cfg["rms_norm_eps"]
    h = x + mla(p["attn"], rms_norm(x, p["norm"]["w"], eps), cfg)
    y = rms_norm(h, p["norm2"]["w"], eps)
    if dense:
        return h + swiglu(p["mlp"], y), torch.zeros((), device=x.device)
    out, aux = moe(p["moe"], y, cfg)
    return h + out, aux


def _unbind(tree):
    """A tree of stacked leaves as the list of its blocks' trees (each
    leaf split once, so its gradient is stacked once)."""
    if torch.is_tensor(tree):
        return torch.unbind(tree, 0)
    parts = {k: _unbind(v) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def layer_params(stack: Dict) -> List[Dict]:
    """Each layer's parameters in order: ``prefix_i``, the ``blocks`` of
    ``p0`` (one layer a block), ``suffix_i``."""
    idx = lambda name: int(name.rsplit("_", 1)[1])  # noqa: E731
    out = [stack[k] for k in sorted((k for k in stack
                                     if k.startswith("prefix_")), key=idx)]
    if "blocks" in stack:
        out += [b["p0"] for b in _unbind(stack["blocks"])]
    out += [stack[k] for k in sorted((k for k in stack
                                      if k.startswith("suffix_")), key=idx)]
    return out


def _xent(x, w_norm, table, labels, eps):
    logits = rms_norm(x, w_norm, eps) @ table.t()
    return F.cross_entropy(logits, labels, reduction="sum")


def loss(params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
         cfg: dict) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, mean cross-entropy, summed balance loss) of tokens and
    labels (B, S)."""
    x = params["embed"]["table"][tokens]
    aux = torch.zeros((), device=x.device)
    for i, p in enumerate(layer_params(params["stack"])):
        x, a = checkpoint(layer, p, x, cfg,
                          i < cfg["first_k_dense_replace"],
                          use_reentrant=False)
        aux = aux + a
    x, labels = x.reshape(-1, x.shape[-1]), labels.reshape(-1)
    xent = sum(checkpoint(_xent, x[lo:lo + LOSS_CHUNK],
                          params["final_norm"]["w"],
                          params["unembed"]["table"],
                          labels[lo:lo + LOSS_CHUNK], cfg["rms_norm_eps"],
                          use_reentrant=False)
               for lo in range(0, x.shape[0], LOSS_CHUNK)) / x.shape[0]
    return xent + cfg["aux_alpha"] * aux, xent, aux


def flat(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The leaves of a nested dict by dotted path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


class AdamW:
    """AdamW on a dict of float32 leaves with the hyperparameters of
    ``repro_torch.common.config.TrainConfig``: global-norm clipping, a
    linear warm-up into a cosine decay, bias-corrected moments, decoupled
    weight decay ``p − lr·(step + wd·p)``."""

    def __init__(self, params: Dict[str, torch.Tensor], hp: dict):
        self.hp = hp
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    def lr(self) -> float:
        hp, t = self.hp, float(self.count)
        warm = min(t / max(hp["warmup_steps"], 1), 1.0)
        prog = min(max((t - hp["warmup_steps"])
                       / max(hp["total_steps"] - hp["warmup_steps"], 1), 0.0),
                   1.0)
        cos = 0.5 * (1 + math.cos(math.pi * prog))
        scale = hp["min_lr_ratio"] + (1 - hp["min_lr_ratio"]) * cos
        return hp["learning_rate"] * warm * scale

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        """Updates ``params`` in place; scales ``grads`` in place."""
        hp = self.hp
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(hp["grad_clip"] / torch.clamp(norm, min=1e-9),
                            max=1.0)
        self.count += 1
        lr = self.lr()
        b1, b2 = hp["beta1"], hp["beta2"]
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for k, p in params.items():
            g = grads[k].mul_(scale)
            self.m[k].mul_(b1).add_((1 - b1) * g)
            self.v[k].mul_(b2).add_((1 - b2) * (g * g))
            step = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2)
                                        + hp["eps"])
            p.copy_(p - lr * (step + hp["weight_decay"] * p))
