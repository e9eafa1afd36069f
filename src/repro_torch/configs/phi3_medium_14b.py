"""phi3-medium-14b [dense] — RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]."""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab=100352,
    pattern=("attn",),
    rope_theta=10000.0,
    tie_embeddings=False,
    cgtrans_embedding=True,
)
