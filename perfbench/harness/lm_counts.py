"""Operations of the LM cells' training step, from the configuration's
published keys and the batch's shape alone.

Counted as a model's FLOPs are: a multiply-add counts 2; each weight
matrix once per token that reads it in the forward, and a training step
three times the forward (the forward, the gradient of every weight, the
gradient of every input: the first layer's input is the embedding rows,
whose table takes a gradient). What the program recomputes (checkpointed
blocks, attention chunks) is not counted, nor elementwise work, norms and
softmaxes. Attention counts its causal pairs alone, S(S + 1)/2 a sequence
and head, for q·k (q/k width n + r) and for p·v (value width v). An expert
layer counts the slots its held experts take on average under uniform
routing: T · k · held / E of the T tokens.

The card's bf16 dense peak is a copy of ``repro_torch.common.hw``'s
(NVIDIA's data sheet, H100 SXM5 at 700 W).
"""

from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, tensor cores, dense


def mla_weights(c: dict) -> int:
    """Weights of one latent attention layer's matrices."""
    D, H = c["hidden_size"], c["num_attention_heads"]
    n, r, v, L = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                  c["v_head_dim"], c["kv_lora_rank"])
    return D * H * (n + r) + D * (L + r) + L * H * (n + v) + H * v * D


def forward_flops(c: dict, B: int, S: int) -> int:
    """One forward of B sequences of S tokens on the chip's share."""
    T = B * S
    D, Lyr = c["hidden_size"], c["num_hidden_layers"]
    dense = c["first_k_dense_replace"]
    moe = Lyr - dense
    E, K = c["router_width"], c["num_experts_per_tok"]
    held = c["n_routed_experts"]
    expert = 3 * D * c["moe_intermediate_size"]
    per_token = (Lyr * mla_weights(c)
                 + dense * 3 * D * c["intermediate_size"]
                 + moe * (3 * D * c["n_shared_experts"]
                          * c["moe_intermediate_size"] + D * E)
                 + D * c["vocab_size"])
    slots = T * K * held / E
    H, n, r, v = (c["num_attention_heads"], c["qk_nope_head_dim"],
                  c["qk_rope_head_dim"], c["v_head_dim"])
    pairs = B * H * S * (S + 1) // 2
    return int(2 * T * per_token + 2 * slots * expert * moe
               + Lyr * 2 * pairs * (n + r + v))


def train_flops(c: dict, B: int, S: int) -> int:
    return 3 * forward_flops(c, B, S)
