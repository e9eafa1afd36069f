"""moonshot-v1-16b-a3b [moe] — kimi/moonlight: 64 experts top-6 + 2 shared.

[hf:moonshotai/Moonlight-16B-A3B; hf]. First layer dense (width 8·d_ff,
derived — the assignment pins the expert width 1408).

This mirrors the JAX registry's entry value for value, and is not
Moonlight's published config: that has 27 layers, latent attention (MLA)
and sigmoid routing with a selection bias, and lives in
``configs/moonlight_16b_a3b.py``.
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
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
    cgtrans_embedding=True,
    cgtrans_moe=True,         # combine-at-expert compressed all-to-all
)
