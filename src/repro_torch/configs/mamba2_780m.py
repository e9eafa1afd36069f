"""mamba2-780m [ssm] — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified]. d_inner = 2·1536 = 3072, 48 heads × 64,
state 128, chunked-SSD scan (chunk 256). The paper's GAS technique is
inapplicable to the mixer (attention-free; DESIGN §Arch-applicability);
vocab 50280 is below the CGTrans-embedding win threshold and not 16-divisible
→ plain sharded embedding.
"""

from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=48,           # = d_inner / ssm_head_dim (bookkeeping only)
    n_kv_heads=48,
    head_dim=64,
    d_ff=0,               # SSD layers have no separate FFN
    vocab=50280,
    pattern=("ssd",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,          # §Perf M1: halved — the (B,L,L,H) intra-chunk
                            # tensors dominate HBM traffic (∝ L per token)
    conv_kernel=4,
    block_repeat=2,           # §Perf M2: 24 blocks of 2 — halves the
                              # backward working set (stored block inputs
                              # stay small; bwd replays 2 layers not 4)
    cgtrans_embedding=False,
)
