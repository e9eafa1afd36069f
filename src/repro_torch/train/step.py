"""Prefill and decode step builders.

The JAX module's LM training step comes with the LM training port
(ROADMAP Queue 1 row 10); these two serve the LM path. The graph
workload's training step is ``train.pipeline.make_sage_train_step``.
"""

from __future__ import annotations

from repro_torch.common.config import ModelConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig, *, cache_len: int, mesh=None,
                      use_flash: bool = False):
    """(params, batch) → (last-token logits, caches). ``use_flash`` runs
    the encoder's self-attention through the flash kernel."""
    T._no_mesh(mesh)

    def prefill_step(params, batch):
        return T.prefill(params, batch, cfg, cache_len=cache_len,
                         use_flash=use_flash)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, mesh=None):
    """(params, token, caches, pos) → (logits, caches updated in place)."""
    T._no_mesh(mesh)

    def decode_step(params, token, caches, pos):
        return T.decode_step(params, token, caches, pos, cfg)
    return decode_step
