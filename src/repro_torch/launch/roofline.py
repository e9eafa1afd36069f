"""Roofline terms: the least time a piece of work can take on the card.

  T_compute    = flops / peak            (f32 CUDA cores or bf16 tensor cores)
  T_memory     = bytes_accessed / hbm_bw
  T_collective = collective_bytes / ici_link_bw

with the peaks of ``common/hw.py``. The JAX package also reads collective
bytes out of compiled XLA HLO (``parse_collective_bytes``); the port has no
HLO, and counts what its collectives ship instead
(``core.collectives.count_collectives``), so only the arithmetic is here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.common.hw import H100, ChipSpec


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-device flops
    bytes_accessed: float        # per-device HBM traffic
    collective_bytes: float      # per-device wire bytes
    collectives: Dict[str, Dict[str, float]]
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: float = 0.0     # 6·N·D (train) / 2·N·D (fwd) per device
    useful_ratio: float = 0.0    # model_flops / flops

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def bound_s(self) -> float:
        """The larger of the three times: the least the work can take."""
        return max(self.t_compute, self.t_memory, self.t_collective)


def roofline_terms(flops: float, bytes_accessed: float,
                   collectives: Dict[str, Dict[str, float]] = None,
                   *, chip: ChipSpec = H100, model_flops: float = 0.0,
                   dtype: str = "bf16") -> RooflineTerms:
    """The three times of one piece of work on ``chip``. ``dtype`` names the
    peak its operations run at: ``"bf16"`` (tensor cores, the JAX
    package's only peak) or ``"f32"`` (CUDA cores)."""
    if dtype not in ("bf16", "f32"):
        raise ValueError(f"unknown peak dtype {dtype!r}")
    collectives = collectives or {}
    peak = chip.peak_flops_bf16 if dtype == "bf16" else chip.peak_flops_f32
    cbytes = sum(v["bytes"] for v in collectives.values())
    tc = flops / peak
    tm = bytes_accessed / chip.hbm_bw
    tl = cbytes / chip.ici_link_bw
    dom = max((tc, "compute"), (tm, "memory"), (tl, "collective"))[1]
    return RooflineTerms(
        flops=flops, bytes_accessed=bytes_accessed, collective_bytes=cbytes,
        collectives=collectives, t_compute=tc, t_memory=tm, t_collective=tl,
        dominant=dom, model_flops=model_flops,
        useful_ratio=(model_flops / flops) if flops else 0.0)


def model_flops_estimate(n_params: int, n_active_params: int, shape_kind: str,
                         tokens_per_device: float) -> float:
    """6·N·D (train) or 2·N·D (fwd/decode) using ACTIVE params for MoE."""
    n = n_active_params or n_params
    mult = 6.0 if shape_kind == "train" else 2.0
    return mult * n * tokens_per_device


def active_params(cfg, n_params: int) -> int:
    """Approximate active-per-token params for MoE archs (top-k + shared)."""
    if cfg.n_experts:
        expert = 3 * cfg.d_model * cfg.d_ff
        moe_layers = sum(1 for k in cfg.layer_kinds() if k == "moe")
        routed_total = moe_layers * cfg.n_experts * expert
        routed_active = moe_layers * cfg.top_k * expert
        return n_params - routed_total + routed_active
    return n_params
