"""Public wrapper for the flash-attention kernel.

Accepts the model's (B, S, H, hd) layout, flattens heads b-major /
h-minor, pads S and T to the 128-row blocks (the padded keys are masked
through ``kv_len``) and slices the padded query rows off. CUDA tensors
launch the kernel; CPU tensors run its plain version.

Forward only, as the JAX kernel is: a call that autograd would record (a
``q``, ``k`` or ``v`` requiring grad while grad mode is on) raises, on
either device, before anything launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import entries
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


NO_GRADIENT = (
    "the flash-attention kernel is forward only: the JAX kernel it ports "
    "(flash_attention_pallas) has no VJP, so no gradient can flow through "
    "it; train through the plain chunked attention (use_flash=False), as "
    "the JAX launcher does")


def _flat(x: torch.Tensor, pad: int) -> torch.Tensor:
    B, L, H, hd = x.shape
    x = x.transpose(1, 2).reshape(B * H, L, hd)
    return F.pad(x, (0, 0, 0, pad)) if pad else x.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B,S,H,hd) pre-scaled; k,v: (B,T,Hkv,hd) → (B,S,H,hd)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(f"flash_attention under autograd: "
                                  f"{NO_GRADIENT}")
    entries.refuse_fake("flash_attention", q, k, v)
    entries.note("flash", q, k, v)
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = K.flash_attention_fwd(
        _flat(q, (-S) % K.BLOCK_Q), _flat(k, (-T) % K.BLOCK_K),
        _flat(v, (-T) % K.BLOCK_K), causal=causal, window=window,
        softcap=softcap, kv_len=T, n_kv_heads=Hkv)
    return out[:, :S].reshape(B, H, S, hd).transpose(1, 2)


__all__ = ["NO_GRADIENT", "flash_attention", "flash_attention_ref"]
