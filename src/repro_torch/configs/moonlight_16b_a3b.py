"""moonlight-16b-a3b [moe] — Moonlight-16B-A3B as published: the
DeepSeek-V3 block.

[hf:moonshotai/Moonlight-16B-A3B config.json]. 27 layers at hidden 2048:
the first dense (SwiGLU 11264), then 26 MoE layers of 64 routed experts
(width 1408, top-6) and 2 shared ones, routed by DeepSeek-V3's noaux_tc
gate (``scoring_func`` sigmoid, a per-expert selection bias, one group,
``norm_topk_prob``, ``routed_scaling_factor`` 2.446). Attention is MLA
with 16 heads and no query compression (``q_lora_rank`` null):
``kv_lora_rank`` 512, q/k 128 + 64 rotary wide, values 128. RoPE theta
50000 with no scaling, RMSNorm eps 1e-5, vocab 163840, untied
embeddings. The sequence-wise balance loss's alpha (1e-4) is DeepSeek-V3's
(arXiv:2412.19437 §2.1.2); the config gives none.

Outside the JAX registry's ten architectures (``configs.ARCHS``): its
mechanisms are the port's own. ``share`` cuts it to what one chip of an
expert- and vocabulary-parallel deployment holds.
"""

import dataclasses

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=163840,
    pattern=("moe",),
    first_k_dense=1,
    d_ff_dense=11264,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    router_aux_coef=1e-4,
    rope_theta=50000.0,
    tie_embeddings=False,
    norm_eps=1e-5,
    kv_lora_rank=512,
    qk_rope_dim=64,
    v_head_dim=128,
    routed_scale=2.446,
    held_experts=64,
)


def share(cfg: ModelConfig = CONFIG, *, ep: int, rank: int = 0,
          vocab: int) -> ModelConfig:
    """One chip's share of ``cfg`` in a deployment where ``ep`` chips
    share each MoE layer: experts ``[rank·E/ep, (rank+1)·E/ep)`` of the
    router's E, and the ``vocab`` rows of the embedding and the head that
    the chip's slice of the vocabulary holds. Every width is kept."""
    if cfg.n_experts % ep:
        raise ValueError(f"{cfg.n_experts} experts do not split {ep} ways")
    n = cfg.n_experts // ep
    out = dataclasses.replace(cfg, held_experts=n, held_first=rank * n,
                              vocab=vocab)
    out.validate()
    return out
