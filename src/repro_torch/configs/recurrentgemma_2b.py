"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 pattern.

[arXiv:2402.19427; hf]. 26 layers = 8×(rec, rec, attn) + 2 trailing rec.
MQA (kv=1), window 2048, GeGLU MLP, gemma-style norms/embedding scale.
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    lru_width=2560,
    act="gelu",
    embed_scale=True,
    rms_zero_centered=True,
    rope_theta=10000.0,
    cgtrans_embedding=True,   # 256k vocab
)
