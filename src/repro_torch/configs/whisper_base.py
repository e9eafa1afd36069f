"""whisper-base [audio] — encoder-decoder; conv frontend is a STUB.

[arXiv:2212.04356; unverified]. input_specs provide precomputed frame
embeddings (B, 1500, 512). LayerNorm, plain GELU MLP, biases everywhere.
Decode shapes run a 32k decoder cache (structural stretch of the 448-pos
trained decoder — documented in DESIGN §4). The paper's technique is NOT
wired here (DESIGN §5: no sparse gather hotspot).
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51865,
    pattern=("dec",),
    is_encoder_decoder=True,
    n_enc_layers=6,
    enc_seq=1500,
    norm_type="ln",
    mlp_gated=False,
    mlp_bias=True,
    qkv_bias=True,
    act="gelu",
    tie_embeddings=True,
    cgtrans_embedding=False,  # inapplicable (DESIGN §5)
)
