"""GRAPHIC / CGTrans in PyTorch, with hand-written CUDA kernels for Hopper.

The counterpart of the JAX package ``repro``, module for module where the
two share a layout. This package imports ``torch`` and ``numpy`` only.

Its entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``; without a card they raise rather than fall back. The
GAS backend knob takes ``impl="ref"`` (the oracle: ``index_add_`` /
``scatter_reduce``) or ``impl="kernel"`` (the FAST-GAS kernels).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
