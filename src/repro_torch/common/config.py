"""Model configuration dataclass, a copy of the JAX package's.

One ``ModelConfig`` covers every architecture family; per-arch files in
``repro_torch.configs`` instantiate it with the published numbers. The
fields under "port only" have no counterpart in the JAX package: at their
defaults a configuration means what the JAX package's means, field for
field.
``ShapeConfig`` and ``SHAPES`` are the JAX module's (train, prefill,
decode) shape presets and ``TrainConfig`` is the optimiser's, field for
field.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Layer kinds usable in ``pattern`` (the repeating block pattern):
#   attn    full causal self-attention + dense FFN
#   local   sliding-window self-attention + dense FFN
#   cross   cross-attention to encoder/vision memory + dense FFN
#   dec     decoder layer with BOTH self- and cross-attention + FFN (whisper)
#   enc     bidirectional self-attention + FFN (whisper encoder)
#   moe     full self-attention + MoE FFN (shared + routed experts)
#   rglru   RG-LRU recurrent block + dense FFN (griffin/recurrentgemma)
#   ssd     mamba2 state-space-duality mixer (no separate FFN)
#   kda     Kimi Delta Attention mixer + MoE FFN (port only)
#   kda_dense  Kimi Delta Attention mixer + dense FFN of d_ff_dense (port
#           only: a leading dense layer that keeps its KDA mixer)
LAYER_KINDS = ("attn", "local", "cross", "dec", "enc", "moe", "rglru", "ssd",
               "kda", "kda_dense")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 → d_model // n_heads
    pattern: Tuple[str, ...] = ("attn",)
    first_k_dense: int = 0           # MoE: leading dense-FFN layers
    qkv_bias: bool = False
    window: int = 0                  # local attention window size
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    rope_theta_global: float = 0.0   # gemma3: global layers use a larger theta
    query_pre_attn_scalar: float = 0.0  # gemma2/3 custom attention scale
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_dense: int = 0              # FFN width for first_k_dense layers
    router_aux_coef: float = 0.01
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # --- RG-LRU (recurrentgemma) ---
    lru_width: int = 0
    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500              # frames after the (stubbed) conv frontend
    max_dec_pos: int = 0             # learned decoder positions (0 → per-shape)
    # --- VLM (llama-3.2-vision) ---
    vision_seq: int = 0              # stub patch-embedding sequence length
    # --- misc ---
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma: scale embeddings by sqrt(d_model)
    norm_eps: float = 1e-6
    act: str = "silu"                # silu | gelu
    norm_type: str = "rms"           # rms | ln (whisper uses LayerNorm)
    rms_zero_centered: bool = False  # gemma: weight stored as (1 + w)
    qk_norm: bool = False            # gemma3: RMSNorm on q and k heads
    post_norms: bool = False         # gemma2/3: post-attn and post-ffn norms
    mlp_gated: bool = True           # SwiGLU/GeGLU vs plain 2-matrix MLP
    mlp_bias: bool = False           # whisper: biases everywhere
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "block"             # none | block | layer (port only:
                                     # every layer its own checkpoint)
    scan_layers: bool = True
    block_repeat: int = 1            # pattern periods per scan block (remat
                                     # stores one input per block: repeat>1
                                     # trades recompute for stored activations)
    # --- CGTrans integration (the paper's technique; see DESIGN §5) ---
    cgtrans_embedding: bool = False  # owner-aggregated embedding-grad scatter
    cgtrans_moe: bool = False        # combine-at-expert compressed all-to-all
    # --- port only (DeepSeek-V3 block: MLA, biased sigmoid router, share) ---
    kv_lora_rank: int = 0            # >0: multi-head latent attention (MLA);
                                     # head_dim is then the q/k "nope" width
    qk_rope_dim: int = 0             # MLA: the rotary q/k width per head
    v_head_dim: int = 0              # MLA: the value width per head
    held_experts: int = 0            # >0: DeepSeek-V3 MoE (noaux_tc sigmoid
    held_first: int = 0              # router + selection bias, sequence-wise
                                     # aux), dropless over the held experts
                                     # [held_first, held_first+held_experts)
    routed_scale: float = 1.0        # held_experts: the weights x this
    mla_nope: bool = False           # MLA without RoPE (q_r, k_r projected
                                     # and left unrotated)
    # --- port only (hybrid stacks: Kimi Linear) ---
    layers: Tuple[str, ...] = ()     # every layer's kind, given outright in
                                     # place of ``pattern``'s repeats
    kda_heads: int = 0               # Kimi Delta Attention: heads,
    kda_head_dim: int = 0            # the key and value width of a head,
    kda_gate_rank: int = 0           # the rank of the decay and output gates

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def rope_dim(self) -> int:
        """The width the rotary tables cover: MLA's rotary part of a
        head, else the whole head."""
        return self.qk_rope_dim if self.kv_lora_rank else self.hd

    @property
    def vocab_padded(self) -> int:
        """Embedding-table rows: vocab padded to a 32-multiple so the table
        shards evenly on any mesh (standard practice; padded logits are
        masked to -inf — see models.embedding)."""
        return -(-self.vocab // 32) * 32

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer kind list of length n_layers: ``layers``
        where a config gives it, else ``attn`` for the first
        ``first_k_dense`` layers and ``pattern`` repeated after them."""
        if self.layers:
            return tuple(self.layers)
        kinds = []
        for i in range(self.n_layers):
            if i < self.first_k_dense:
                kinds.append("attn")
            else:
                kinds.append(self.pattern[(i - self.first_k_dense) % len(self.pattern)])
        return tuple(kinds)

    def validate(self) -> None:
        assert self.n_layers > 0 and self.d_model > 0
        assert self.remat in ("none", "block", "layer"), self.remat
        if self.layers:
            assert len(self.layers) == self.n_layers, (
                len(self.layers), self.n_layers)
        kinds = set(self.pattern) | set(self.layers)
        for k in kinds:
            assert k in LAYER_KINDS, k
        if kinds & {"moe", "kda"}:
            assert self.n_experts > 0 and self.top_k > 0
        if "ssd" in kinds:
            assert self.ssm_state > 0
        if "local" in kinds:
            assert self.window > 0
        if kinds & {"kda", "kda_dense"}:
            assert self.kda_heads > 0 and self.kda_head_dim > 0 \
                and self.kda_gate_rank > 0
        if self.is_encoder_decoder:
            assert self.n_enc_layers > 0
        if self.kv_lora_rank:
            assert self.qk_rope_dim > 0 and self.v_head_dim > 0
        if self.held_experts:
            assert 0 <= self.held_first and \
                self.held_first + self.held_experts <= self.n_experts


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    microbatches: int = 1            # grad-accum microbatches per step
    grad_compression: str = "none"   # none | int8_ef (error-feedback int8)
    seed: int = 0


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests.

    Keeps the *pattern* (the interesting structure) and shrinks everything
    else: width, layers (≥ one full pattern period), experts, vocab.
    """
    period = len(cfg.pattern)
    small = dict(
        n_layers=max(2 * period, cfg.first_k_dense + period),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 2,
        d_ff=128,
        vocab=512,
        head_dim=16,
        window=min(cfg.window, 32) if cfg.window else 0,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        d_ff_dense=128 if cfg.d_ff_dense else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16 if cfg.ssm_state else 256,
        lru_width=64 if cfg.lru_width else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        enc_seq=32 if cfg.is_encoder_decoder else cfg.enc_seq,
        vision_seq=16 if cfg.vision_seq else 0,
        query_pre_attn_scalar=16.0 if cfg.query_pre_attn_scalar else 0.0,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
    small.update(overrides)
    out = dataclasses.replace(cfg, **small)
    out.validate()
    return out
