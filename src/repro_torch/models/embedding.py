"""Vocab embedding lookup, the output logits and the chunked
cross-entropy.

The port's LM runs on one device, so the lookup is the JAX package's
single-device branch: ``table[ids]`` cast to the compute dtype. The
CGTrans sharded lookup (owner-resolved gather, psum of the result) comes
with the sharded LM (ROADMAP Queue 1 row 10.3).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, *, mesh=None,
                 compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """ids: (B, S) integer → (B, S, D) in ``compute_dtype``."""
    if mesh is not None:
        raise NotImplementedError(
            "the sharded (CGTrans) embedding lookup is not ported yet "
            "(ROADMAP Queue 1 row 10.3, the sharded LM)")
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


def _chunk_loss(xi, table, li, softcap: float, valid_vocab: int):
    """(sum of -log p(label), count of labels ≥ 0) over one chunk."""
    logits = logits_matmul(xi, table, softcap=softcap,
                           valid_vocab=valid_vocab)     # (B, chunk, V) f32
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(li, min=0).long()[..., None]
                        )[..., 0]
    valid = (li >= 0).to(torch.float32)
    return torch.sum((lse - gold) * valid), torch.sum(valid)


def chunked_softmax_xent(
    x: torch.Tensor,          # (B, S, D) final hiddens
    table: torch.Tensor,      # (V, D) tied output embedding
    labels: torch.Tensor,     # (B, S) integer, -1 = padding
    *,
    softcap: float = 0.0,
    max_chunk: int = 512,
    byte_budget: int = 1 << 28,
    valid_vocab: int = 0,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequence-chunked cross-entropy, so (B, S, V) f32 logits never
    materialise. Returns (sum_loss, n_valid), f32 scalars.

    The chunk is the JAX package's: the largest divisor of S at most
    ``min(max_chunk, byte_budget // (B·V·4))``, so the loss sums the same
    chunks in the same order. Under autograd each chunk is checkpointed
    (its logits recomputed in the backward, as ``jax.checkpoint`` does),
    so the backward holds one (B, chunk, V) f32 block at a time.
    """
    if mesh is not None:
        raise NotImplementedError(
            "chunked_softmax_xent(mesh=) is not ported yet (ROADMAP Queue 1 "
            "row 10.3, the sharded LM)")
    B, S, _ = x.shape
    V = table.shape[0]
    dev_bytes = max(B * V * 4, 1)
    chunk = max(1, min(max_chunk, byte_budget // dev_bytes))
    while S % chunk:
        chunk -= 1
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for lo in range(0, S, chunk):
        args = (x[:, lo:lo + chunk], table, labels[:, lo:lo + chunk],
                softcap, valid_vocab)
        l, c = (checkpoint(_chunk_loss, *args, use_reentrant=False)
                if remat else _chunk_loss(*args))
        loss_sum = loss_sum + l
        cnt = cnt + c
    return loss_sum, cnt
