"""Vocab embedding lookup and the output logits.

The port runs on one device, so the lookup is the JAX package's
single-device branch: ``table[ids]`` cast to the compute dtype. The
CGTrans sharded lookup (owner-resolved gather, psum of the result) comes
with the LM stack (ROADMAP Queue 1 row 10).
"""

from __future__ import annotations

import torch


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, *, mesh=None,
                 compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """ids: (B, S) integer → (B, S, D) in ``compute_dtype``."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded (CGTrans) embedding lookup is not ported yet "
            "(ROADMAP Queue 1 row 10, the LM stack)")
    return table[ids.long()].to(compute_dtype)


def logits_matmul(x: torch.Tensor, table: torch.Tensor, *,
                  softcap: float = 0.0, valid_vocab: int = 0) -> torch.Tensor:
    """(…, D) @ (V, D)ᵀ → (…, V), float32 accumulation and output.

    ``valid_vocab``: padded table rows (≥ valid_vocab) get -1e30 so the
    vocab padding never leaks into softmax or sampling.
    """
    logits = x.float() @ table.to(x.dtype).float().T
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    if valid_vocab and valid_vocab < table.shape[0]:
        pad = torch.arange(table.shape[0], device=x.device) >= valid_vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits
