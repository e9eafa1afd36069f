"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained experts.

[arXiv:2401.06066; hf]. First layer dense FFN (10944, per the release).
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=102400,
    pattern=("moe",),
    first_k_dense=1,
    d_ff_dense=10944,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    cgtrans_embedding=True,
    cgtrans_moe=True,
)
