"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified]. Window 1024 local; global layers use
rope theta 1M (dual-rope); qk-norm; pre+post norms.
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024,
    rope_theta=10000.0,
    rope_theta_global=1000000.0,
    query_pre_attn_scalar=256.0,
    qk_norm=True,
    post_norms=True,
    rms_zero_centered=True,
    embed_scale=True,
    act="gelu",
    cgtrans_embedding=True,   # 262k vocab — the biggest CGTrans embedding case
)
