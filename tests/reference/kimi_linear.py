"""Plain float32 PyTorch reference of Kimi-Linear-48B-A3B's training loss,
its gradients and the optimizer step, on one chip's share.

Kimi-Linear-48B-A3B (huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct,
config.json; the Kimi Linear report, arXiv:2510.26692) stacks Kimi Delta
Attention (KDA) layers and latent attention (MLA) layers without a rotary
embedding, at the 1-based layers its ``linear_attn_config`` lists
(``kda_layers``, ``full_attn_layers``). The first ``first_k_dense_replace``
layers have a dense SwiGLU FFN, the others the DeepSeek-V3 MoE. Written
from the published description with plain ``torch`` operations: it
imports nothing of the program under test and nothing of JAX; the MoE,
the norms, the attention chunk and AdamW are ``moonlight.py``'s, beside
this file. Callers run it with TF32 off.

For a hidden state x (B, S, D) each layer is

    h  = x + Mixer(RMSNorm(x))
    x' = h + FFN(RMSNorm(h))

**KDA** (H = ``num_heads``, d = ``head_dim`` of ``linear_attn_config``,
P = H·d): ``[q ‖ k ‖ v] = SiLU(conv(x W_qkv))``, the convolution causal
and depthwise over the 3P channels (width ``short_conv_kernel_size``, no
bias); per head q and k scaled to unit length (x / sqrt(Σx² + 1e-6)), q
then by d^-1/2; per channel the log-decay g = −exp(A_log_h) ·
softplus((x W_fa) W_fb + dt_bias); per head β = sigmoid(x W_b). Per head,
from S_0 = 0 (d × d):

    S_t = Diag(exp g_t) S_{t−1};  S_t += β_t k_t (v_t − S_tᵀ k_t)ᵀ;  o_t = S_tᵀ q_t

out = (RMSNorm_d(o) · w ⊙ sigmoid((x W_ga) W_gb)) W_o, the norm's scale w
(d,) shared by the heads. The recurrence is computed in chunks of
``KDA_CHUNK`` tokens: with G the cumulative sum of g from the chunk's
start, every pair's decay exp(G_t − G_i) (i ≤ t) is taken directly, per
channel, its exponent summed over the pair's own tokens (Σ_{i<s≤t} g_s),
the entries above the diagonal masked before the exponential;
A_ti = β_t Σ_c k_tc k_ic exp(G_tc − G_ic) (i < t), the chunk's
corrections X = (I + A)^{-1} diag(β) [k ⊙ exp(G) ‖ v], U = X_v − X_k S,
o = (q ⊙ exp(G)) S + Pairs(q, k) U, and S ← exp(G_last) ⊙ S + (k ⊙
exp(G_last − G))ᵀ U, chunk after chunk (the pair decays and corrections
of ``KDA_GROUP`` chunks at once).

**MLA** is ``moonlight.py``'s without RoPE (``mla_use_nope``): q_r and the
shared k_r are projected and enter the scores unrotated; the scale stays
1/sqrt(n + r).

**FFN** and **loss**: ``moonlight.py``'s (SwiGLU; MoE over the held share
of ``router_width`` experts, sigmoid scores with a selection bias, the
sequence-wise balance loss; mean cross-entropy plus ``aux_alpha`` times
the balance losses summed).

**Departures from Kimi Linear as trained**, each also in the program: the
selection bias is fixed; AdamW for Muon; the share and vocabulary cut
(``moonlight.py``'s); the gates' low rank (``w_fa``, ``w_ga``: D → r) is
the head width, which the config does not give; the output gate is
written without a bias, as the report's equation has it.

The parameters are a nested dict laid out as the port lays them out:
``embed.table``, ``unembed.table``, ``final_norm.w`` and under ``stack``
the layers in order as ``prefix_i``, the ``blocks`` (every leaf stacked
on a leading axis over the blocks; a block's layers ``p0``, ``p1``, …)
and ``suffix_i``. A KDA layer's mixer is ``mixer``: ``w_qkv`` (D, 3, P),
``conv_w`` (K, 3P), ``w_fa`` (D, r), ``w_fb`` (r, P), ``dt_bias`` (P,),
``a_log`` (H,), ``w_b`` (D, H), ``w_ga`` (D, r), ``w_gb`` (r, P),
``o_norm.w`` (d,), ``wo`` (P, D); an MLA layer's is ``attn``, laid out as
in ``moonlight.py``; the FFN is ``mlp`` or ``moe``.

At full size the loss runs layer by layer with recomputation (each layer,
each group of KDA chunks, each attention query chunk and each loss chunk
checkpointed), so that it fits beside the parameters, their gradients and
AdamW's moments.

``cfg`` is the configuration file's keys (``linear_attn_config``,
``first_k_dense_replace``, the widths) and what ``moonlight.py`` reads:
``router_width``, ``n_routed_experts`` (the experts held),
``held_first``, ``num_experts_per_tok`` and ``aux_alpha``.
"""

from __future__ import annotations

import importlib.util
import re
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _beside(name: str):
    """The reference module ``name`` of this file's directory."""
    path = Path(__file__).resolve().parent / f"{name}.py"
    qual = "_reference_" + re.sub(r"\W", "_", str(path))
    if qual not in sys.modules:
        spec = importlib.util.spec_from_file_location(qual, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[qual] = mod
    return sys.modules[qual]


moonlight = _beside("moonlight")
rms_norm, swiglu, moe, route = (moonlight.rms_norm, moonlight.swiglu,
                                moonlight.moe, moonlight.route)
flat, AdamW, LOSS_CHUNK = moonlight.flat, moonlight.AdamW, moonlight.LOSS_CHUNK

KDA_CHUNK = 32        # tokens per chunk of the recurrence
KDA_GROUP = 16        # chunks per checkpointed group
L2_EPS = 1e-6


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + L2_EPS)


def _kda_group(S0, q, k, v, g, beta):
    """Chunks of ``KDA_CHUNK`` tokens: q, k, v, g (B, H, m·c, d), beta
    (B, H, m·c), the state S0 (B, H, d, d) before them → (o (B, H, m·c,
    d), the state after them). Each chunk's pair decays and corrections
    are taken for all m chunks at once; the state passes from chunk to
    chunk."""
    B, H, L, d = q.shape
    c = KDA_CHUNK
    q, k, v, g = (t.reshape(B, H, L // c, c, d) for t in (q, k, v, g))
    beta = beta.reshape(B, H, L // c, c)
    G = torch.cumsum(g, dim=3)
    causal = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    # Σ_{i<s≤t} g_s of every pair (t, i): g_s where s > i, summed over s ≤ t
    pair = torch.cumsum(g[..., :, None, :] * causal.tril(-1)[:, :, None],
                        dim=3)
    decay = torch.exp(pair.masked_fill(~causal[:, :, None], float("-inf")))
    kk = torch.einsum("bhmtc,bhmic,bhmtic->bhmti", k, k, decay)
    qk = torch.einsum("bhmtc,bhmic,bhmtic->bhmti", q, k, decay)
    eye = torch.eye(c, device=q.device)
    A = beta[..., None] * kk.masked_fill(~causal.tril(-1), 0.0)
    rhs = beta[..., None] * torch.cat([k * torch.exp(G), v], dim=-1)
    X = torch.linalg.solve_triangular(eye + A, rhs, upper=False)
    qg = q * torch.exp(G)
    kl = k * decay[..., -1, :, :]                   # k_i exp(G_last − G_i)
    gl = torch.exp(G[..., -1:, :]).transpose(-1, -2)         # (B,H,m,d,1)
    outs = []
    for j in range(L // c):
        U = X[:, :, j, :, d:] - X[:, :, j, :, :d] @ S0
        outs.append(qg[:, :, j] @ S0 + qk[:, :, j] @ U)
        S0 = gl[:, :, j] * S0 + kl[:, :, j].transpose(-1, -2) @ U
    return torch.cat(outs, dim=2), S0


def kda_scan(q, k, v, g, beta):
    """The recurrence over q, k, v, g (B, H, S, d) and beta (B, H, S) from
    S_0 = 0 → o (B, H, S, d). The sequence is padded to whole chunks with
    zeros, which no state or earlier output reads."""
    B, H, S, d = q.shape
    pad = -S % KDA_CHUNK
    if pad:
        q, k, v, g = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v, g))
        beta = F.pad(beta, (0, pad))
    state = q.new_zeros(B, H, d, d)
    span = KDA_CHUNK * KDA_GROUP
    outs = []
    for lo in range(0, S + pad, span):
        args = [t[:, :, lo:lo + span] for t in (q, k, v, g, beta)]
        if torch.is_grad_enabled():
            o, state = checkpoint(_kda_group, state, *args,
                                  use_reentrant=False)
        else:
            o, state = _kda_group(state, *args)
        outs.append(o)
    return torch.cat(outs, dim=2)[:, :, :S]


def kda(p: Dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """KDA of x (B, S, D)."""
    B, S, D = x.shape
    lac = cfg["linear_attn_config"]
    H, d = lac["num_heads"], lac["head_dim"]
    P = H * d
    qkv = (x @ p["w_qkv"].reshape(D, 3 * P)).transpose(1, 2)  # (B, 3P, S)
    w = p["conv_w"]
    qkv = F.conv1d(F.pad(qkv, (w.shape[0] - 1, 0)), w.t()[:, None, :],
                   groups=3 * P)
    q, k, v = (t.transpose(1, 2).reshape(B, S, H, d)
               for t in F.silu(qkv).split(P, dim=1))
    q = _l2(q) * d ** -0.5
    k = _l2(k)
    g = -torch.exp(p["a_log"])[:, None] * F.softplus(
        (x @ p["w_fa"]) @ p["w_fb"] + p["dt_bias"]).reshape(B, S, H, d)
    beta = torch.sigmoid(x @ p["w_b"])
    heads = lambda t: t.transpose(1, 2)  # noqa: E731
    o = heads(kda_scan(heads(q), heads(k), heads(v), heads(g), heads(beta)))
    gate = torch.sigmoid((x @ p["w_ga"]) @ p["w_gb"]).reshape(B, S, H, d)
    o = rms_norm(o, p["o_norm"]["w"], cfg["rms_norm_eps"]) * gate
    return o.reshape(B, S, P) @ p["wo"]


def mla(p: Dict, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Causal MLA of x (B, S, D) without RoPE."""
    B, S, _ = x.shape
    H, n, r = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
               cfg["qk_rope_head_dim"])
    dv, L = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = (x @ p["wq"]).reshape(B, S, H, n + r)
    ckv = x @ p["wkva"]
    c = rms_norm(ckv[..., :L], p["kv_norm"]["w"], cfg["rms_norm_eps"])
    kv = (c @ p["wkvb"]).reshape(B, S, H, n + dv)
    k = torch.cat([kv[..., :n], ckv[..., None, L:].expand(B, S, H, r)], -1)
    q, k, v = (t.transpose(1, 2) for t in (q, k, kv[..., n:]))
    qc = moonlight.Q_CHUNK if S % moonlight.Q_CHUNK == 0 else S
    o = torch.cat([checkpoint(moonlight._attend, q[:, :, lo:lo + qc], k, v,
                              lo, (n + r) ** -0.5, use_reentrant=False)
                   for lo in range(0, S, qc)], dim=2)
    return o.transpose(1, 2).reshape(B, S, H * dv) @ p["wo"]


def kinds(cfg: dict) -> List[Tuple[bool, bool]]:
    """(KDA?, dense FFN?) of each layer in order, from the config's
    1-based lists."""
    kda_layers = set(cfg["linear_attn_config"]["kda_layers"])
    return [(i in kda_layers, i <= cfg["first_k_dense_replace"])
            for i in range(1, cfg["num_hidden_layers"] + 1)]


def layer(p: Dict, x: torch.Tensor, cfg: dict, is_kda: bool, dense: bool):
    eps = cfg["rms_norm_eps"]
    y = rms_norm(x, p["norm"]["w"], eps)
    h = x + (kda(p["mixer"], y, cfg) if is_kda else mla(p["attn"], y, cfg))
    y = rms_norm(h, p["norm2"]["w"], eps)
    if dense:
        return h + swiglu(p["mlp"], y), torch.zeros((), device=x.device)
    out, aux = moe(p["moe"], y, cfg)
    return h + out, aux


def layer_params(stack: Dict) -> List[Dict]:
    """Each layer's parameters in order: ``prefix_i``, the blocks (their
    layers ``p0``, ``p1``, … in turn), ``suffix_i``."""
    idx = lambda name: int(name.rsplit("_", 1)[1])  # noqa: E731
    out = [stack[k] for k in sorted((k for k in stack
                                     if k.startswith("prefix_")), key=idx)]
    if "blocks" in stack:
        for b in moonlight._unbind(stack["blocks"]):
            out += [b[f"p{j}"] for j in range(len(b))]
    out += [stack[k] for k in sorted((k for k in stack
                                      if k.startswith("suffix_")), key=idx)]
    return out


def loss(params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
         cfg: dict) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, mean cross-entropy, summed balance loss) of tokens and
    labels (B, S)."""
    x = params["embed"]["table"][tokens]
    aux = torch.zeros((), device=x.device)
    for p, (is_kda, dense) in zip(layer_params(params["stack"]),
                                  kinds(cfg), strict=True):
        x, a = checkpoint(layer, p, x, cfg, is_kda, dense,
                          use_reentrant=False)
        aux = aux + a
    x, labels = x.reshape(-1, x.shape[-1]), labels.reshape(-1)
    xent = sum(checkpoint(moonlight._xent, x[lo:lo + LOSS_CHUNK],
                          params["final_norm"]["w"],
                          params["unembed"]["table"],
                          labels[lo:lo + LOSS_CHUNK], cfg["rms_norm_eps"],
                          use_reentrant=False)
               for lo in range(0, x.shape[0], LOSS_CHUNK)) / x.shape[0]
    return xent + cfg["aux_alpha"] * aux, xent, aux
