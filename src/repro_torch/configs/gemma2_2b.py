"""gemma2-2b [dense] — local+global alternating attention with logit softcaps.

[arXiv:2408.00118; hf]. Window 4096 on even (local) layers; attn softcap 50,
final softcap 30; pre+post norms; query_pre_attn_scalar = 256.
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256000,
    pattern=("local", "attn"),
    window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    query_pre_attn_scalar=256.0,
    post_norms=True,
    rms_zero_centered=True,
    embed_scale=True,
    act="gelu",
    cgtrans_embedding=True,   # 256k vocab
)
