"""kimi-linear-48b-a3b [hybrid] — Kimi-Linear-48B-A3B as published: Kimi
Delta Attention (KDA) layers beside rotary-free latent attention, 3 : 1.

[hf:moonshotai/Kimi-Linear-48B-A3B-Instruct config.json; arXiv:2510.26692].
27 layers at hidden 2304. ``linear_attn_config`` puts KDA (32 heads of
128, short convolutions of width 4) at the 1-based layers ``KDA_LAYERS``
and MLA at ``FULL_ATTN_LAYERS`` (4, 8, …, 24 and 27: the last period is
irregular); the MLA has 32 heads, ``kv_lora_rank`` 512, q/k 128 + 64 and
values 128, no query compression and no rotary embedding
(``mla_use_nope``). Layer 1 keeps its KDA mixer with a dense SwiGLU of
9216; the other 26 layers are MoE: 256 routed experts of 1024, top-8,
sigmoid scores with a selection bias (one group), renormalised,
``routed_scaling_factor`` 2.446, one shared expert. RMSNorm eps 1e-5,
vocab 163840, untied embeddings. Assumed: the gates' rank 128 (the head
width, as the public modelling code has it) and the balance loss's alpha
1e-4, as Moonlight's (the config gives none).

Outside the JAX registry's ten architectures (``configs.ARCHS``).
``share`` (Moonlight's, on this config) cuts it to what one chip of an expert- and
vocabulary-parallel deployment holds.
"""

from typing import Sequence, Tuple

from repro_torch.common.config import ModelConfig
from repro_torch.configs import moonlight_16b_a3b

KDA_LAYERS = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22,
              23, 25, 26)
FULL_ATTN_LAYERS = (4, 8, 12, 16, 20, 24, 27)


def layer_kinds(kda_layers: Sequence[int], full_attn_layers: Sequence[int],
                first_k_dense: int) -> Tuple[str, ...]:
    """The port's kind of each layer from the config's 1-based lists: a
    KDA layer is ``kda`` (``kda_dense`` among the first ``first_k_dense``),
    a full-attention layer ``moe`` (latent attention, MoE FFN; ``attn``
    among the first)."""
    n = len(kda_layers) + len(full_attn_layers)
    if sorted([*kda_layers, *full_attn_layers]) != list(range(1, n + 1)):
        raise ValueError("the KDA and full-attention layers must cover "
                         f"1..{n} once each")
    kda = set(kda_layers)
    return tuple(("kda_dense" if i in kda else "attn") if i <= first_k_dense
                 else ("kda" if i in kda else "moe")
                 for i in range(1, n + 1))


CONFIG = ModelConfig(
    name="kimi-linear-48b-a3b",
    family="hybrid",
    n_layers=27,
    d_model=2304,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=1024,
    vocab=163840,
    layers=layer_kinds(KDA_LAYERS, FULL_ATTN_LAYERS, 1),
    first_k_dense=1,
    d_ff_dense=9216,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    router_aux_coef=1e-4,
    rope_theta=10000.0,
    tie_embeddings=False,
    norm_eps=1e-5,
    kv_lora_rank=512,
    qk_rope_dim=64,
    v_head_dim=128,
    mla_nope=True,
    routed_scale=2.446,
    held_experts=256,
    kda_heads=32,
    kda_head_dim=128,
    kda_gate_rank=128,
    conv_kernel=4,
    remat="layer",
)


def share(cfg: ModelConfig = CONFIG, *, ep: int, rank: int = 0,
          vocab: int) -> ModelConfig:
    """``moonlight_16b_a3b.share`` of ``cfg``: one chip's experts and
    vocabulary rows, every width kept."""
    return moonlight_16b_a3b.share(cfg, ep=ep, rank=rank, vocab=vocab)
