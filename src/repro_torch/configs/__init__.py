"""Configurations: the paper's GCN and the ten LM architectures.

``get_config(arch)`` resolves one of the ten LM configurations of the JAX
registry, value for value, or one of the port's own (``PORT_ONLY``:
moonlight-16b-a3b, the DeepSeek-V3 block; kimi-linear-48b-a3b, KDA beside
rotary-free MLA); ``smoke_config`` gives its
reduced CPU-test size. ``ARCHS``, ``SKIP_CELLS``, ``get_shape`` and ``cells`` are the JAX
registry's (arch × shape) grid, with the cells it skips under the
assignment's sub-quadratic rule.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.common.config import SHAPES, ModelConfig, ShapeConfig, reduced
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2
from repro_torch.configs.gemma3_12b import CONFIG as _gemma3
from repro_torch.configs.graphic_gcn import CONFIG, PALLAS_CONFIG
from repro_torch.configs.kimi_linear_48b_a3b import CONFIG as _kimi_linear
from repro_torch.configs.llama_3_2_vision_90b import CONFIG as _llama_vis
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.moonlight_16b_a3b import CONFIG as _moonlight
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as _moonshot
from repro_torch.configs.phi3_medium_14b import CONFIG as _phi3
from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma
from repro_torch.configs.whisper_base import CONFIG as _whisper

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in (
        _llama_vis, _rgemma, _qwen, _gemma2, _phi3, _gemma3,
        _moonshot, _deepseek, _whisper, _mamba2,
    )
}

ARCHS: List[str] = list(REGISTRY)

# configurations of mechanisms the JAX package lacks: by name, outside the
# JAX grid (ARCHS, cells)
PORT_ONLY: Dict[str, ModelConfig] = {
    c.name: c for c in (_moonlight, _kimi_linear)}

# long_500k requires sub-quadratic context handling; pure full-attention
# archs are skipped per the assignment
_FULL_ATTN = ("llama-3.2-vision-90b", "qwen1.5-0.5b", "phi3-medium-14b",
              "moonshot-v1-16b-a3b", "deepseek-moe-16b", "whisper-base")
SKIP_CELLS: Dict[Tuple[str, str], str] = {
    (a, "long_500k"): "pure full-attention arch — 500k decode cache is "
                      "quadratic-history; skipped per assignment"
    for a in _FULL_ATTN
}
SKIP_CELLS[("whisper-base", "long_500k")] = (
    "enc-dec with 1.5k-frame encoder and full-attention decoder; 500k decode "
    "context is architecturally meaningless — skipped per assignment")


def get_config(arch: str) -> ModelConfig:
    cfg = REGISTRY[arch] if arch in REGISTRY else PORT_ONLY[arch]
    cfg.validate()
    return cfg


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(include_skipped: bool = False) -> List[Tuple[str, str]]:
    """All 40 (arch × shape) cells, minus the documented skips."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            if include_skipped or (a, s) not in SKIP_CELLS:
                out.append((a, s))
    return out


def smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))


__all__ = ["ARCHS", "CONFIG", "PALLAS_CONFIG", "PORT_ONLY", "REGISTRY",
           "SKIP_CELLS", "cells", "get_config", "get_shape", "smoke_config"]
