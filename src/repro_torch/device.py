"""Device selection shared by every entry point of the port."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises.

    Entry points default to the card and never continue on the CPU by
    themselves: a caller who wants the CPU says ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_impl(impl: str) -> str:
    """Validate the GAS backend knob (``ref`` or ``kernel``)."""
    if impl not in ("ref", "kernel"):
        raise ValueError(
            f"unknown impl {impl!r}: expected 'ref' (the index_add_ / "
            f"scatter_reduce oracle) or 'kernel' (the FAST-GAS kernels)")
    return impl
