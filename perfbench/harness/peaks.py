"""The card's peaks: NVIDIA's data sheet for the H100 SXM5 80 GB at its
full 700 W power limit, dense rates (a copy of ``repro_torch.common.hw``'s
numbers). A card set below 700 W runs slower under load, so each run
records the card's ``power.limit`` beside them."""

from __future__ import annotations

import subprocess

PEAK_FLOPS_F32 = 67e12       # FLOP/s, CUDA cores, float32 (TF32 off)
HBM_BYTES_PER_S = 3.35e12


def power_limit_w():
    """The card's power limit in watts from ``nvidia-smi``, or ``None``
    where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.split()[0])
    except (IndexError, ValueError):
        return None
