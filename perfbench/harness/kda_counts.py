"""Operations of the hybrid LM cell's training step (Kimi Linear: KDA and
latent attention layers, MoE FFNs), from the configuration's published
keys and the batch's shape alone.

Counted as ``lm_counts`` counts them: a multiply-add counts 2; each
weight matrix once per token that reads it in the forward; a training
step three times the forward; recomputation, elementwise work, norms,
convolutions and softmaxes not counted; latent attention its causal pairs
alone (S(S + 1)/2 a sequence and head, q/k width n + r, value width v);
an expert layer the slots its held experts take on average under uniform
routing (T · k · held / E of the T tokens). A KDA layer counts its
matrices (W_qkv, the two gates' low-rank pairs, W_b, W_o) and its scan
the delta rule's three products per token and head (Sᵀk, k uᵀ, Sᵀq:
2 · d_k · d_v each), whatever form computes them.
"""

from __future__ import annotations

from harness import lm_counts

PEAK_FLOPS_BF16 = lm_counts.PEAK_FLOPS_BF16


def kda_weights(c: dict) -> int:
    """Weights of one KDA layer's matrices."""
    lac = c["linear_attn_config"]
    D, H, d = c["hidden_size"], lac["num_heads"], lac["head_dim"]
    P, r = H * d, c["kda_gate_rank"]
    return D * 3 * P + 2 * (D * r + r * P) + D * H + P * D


def forward_flops(c: dict, B: int, S: int) -> int:
    """One forward of B sequences of S tokens on the chip's share."""
    T = B * S
    D, L = c["hidden_size"], c["num_hidden_layers"]
    n_kda = len(c["linear_attn_config"]["kda_layers"])
    n_mla = L - n_kda
    dense = c["first_k_dense_replace"]
    moe = L - dense
    E, K = c["router_width"], c["num_experts_per_token"]
    held, F = c["n_routed_experts"], c["moe_intermediate_size"]
    per_token = (n_kda * kda_weights(c) + n_mla * lm_counts.mla_weights(c)
                 + dense * 3 * D * c["intermediate_size"]
                 + moe * (3 * D * c["num_shared_experts"] * F + D * E)
                 + D * c["vocab_size"])
    slots = T * K * held / E
    H, n, r, v = (c["num_attention_heads"], c["qk_nope_head_dim"],
                  c["qk_rope_head_dim"], c["v_head_dim"])
    pairs = B * H * S * (S + 1) // 2
    lac = c["linear_attn_config"]
    scan = T * lac["num_heads"] * 3 * 2 * lac["head_dim"] ** 2
    return int(2 * T * per_token + 2 * slots * 3 * D * F * moe
               + n_mla * 2 * pairs * (n + r + v) + n_kda * scan)


def train_flops(c: dict, B: int, S: int) -> int:
    return 3 * forward_flops(c, B, S)
