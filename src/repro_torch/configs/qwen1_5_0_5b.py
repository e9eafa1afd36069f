"""qwen1.5-0.5b [dense] — plain GQA (kv=heads) transformer with QKV bias.

[hf:Qwen/Qwen1.5-0.5B; hf].
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab=151936,
    pattern=("attn",),
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    cgtrans_embedding=True,   # 152k vocab
)
