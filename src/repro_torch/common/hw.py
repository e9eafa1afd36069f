"""The card's roofline constants.

The counterpart of the JAX package's TPU ``ChipSpec``: the peaks a bound is
computed from (``launch.roofline.roofline_terms``, ``chip_smoke.py``'s
kernel bounds, ``launch/dryrun.py``'s roofline). The JAX package's
production mesh shapes are ``launch.mesh.PRODUCTION_SHAPES``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-card roofline constants of the NVIDIA H100 SXM5 80 GB, from its
    data sheet at the full 700 W power limit (a card set below it runs
    slower under load)."""

    name: str = "H100 SXM5 80GB"
    sm_count: int = 132
    smem_per_sm: int = 228 * 1024      # bytes of shared memory per SM
    hbm_bytes: float = 80e9            # capacity
    hbm_bw: float = 3.35e12            # bytes/s
    peak_flops_f32: float = 67e12      # FLOP/s on the CUDA cores
    peak_flops_bf16: float = 989e12    # FLOP/s, dense, on the tensor cores
    # NVLink, bidirectional bytes/s per card: the port's stand-in for the
    # TPU spec's per-link interconnect rate
    ici_link_bw: float = 900e9


H100 = ChipSpec()
