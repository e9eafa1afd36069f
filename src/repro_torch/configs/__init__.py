"""Configurations: the paper's GCN and the LM architectures ported so far.

``REGISTRY`` holds the LM configurations whose layer kinds the port runs
(``attn``, ``local``, ``enc``, ``dec``); ``get_config`` resolves one by
name and ``smoke_config`` gives its reduced CPU-test size. The other
architectures of the JAX registry need layer kinds that are not ported yet
(ROADMAP Queue 1 row 10).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.common.config import ModelConfig, reduced
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2
from repro_torch.configs.graphic_gcn import CONFIG, PALLAS_CONFIG
from repro_torch.configs.qwen1_5_0_5b import CONFIG as _qwen
from repro_torch.configs.whisper_base import CONFIG as _whisper

REGISTRY: Dict[str, ModelConfig] = {c.name: c
                                    for c in (_qwen, _gemma2, _whisper)}


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP Queue 1 row 10, the "
            f"LM stack); ported: {sorted(REGISTRY)}")
    cfg = REGISTRY[arch]
    cfg.validate()
    return cfg


def smoke_config(arch: str) -> ModelConfig:
    return reduced(get_config(arch))


__all__ = ["CONFIG", "PALLAS_CONFIG", "REGISTRY", "get_config",
           "smoke_config"]
