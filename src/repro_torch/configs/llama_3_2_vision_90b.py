"""llama-3.2-vision-90b [vlm] — 100L incl. 20 cross-attn image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]. Backbone only; the vision
frontend is a STUB: input_specs provide precomputed patch embeddings
(B, vision_seq, d_model). Cross-attn layers sit at i % 5 == 3 (20 of 100).
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    pattern=("attn", "attn", "attn", "cross", "attn"),
    rope_theta=500000.0,
    vision_seq=1024,
    tie_embeddings=False,
    cgtrans_embedding=True,   # 128k vocab — CGTrans owner-aggregated embedding
)
