"""Kimi Delta Attention (KDA), the linear-attention mixer of Kimi Linear
(Moonshot AI, arXiv:2510.26692): a gated delta rule whose decay is one per
channel.

With x the layer's normed input (B, S, D), H heads (``cfg.kda_heads``) of
width d (``cfg.kda_head_dim``, keys and values alike), P = H·d, and the
gates' rank r (``cfg.kda_gate_rank``)::

    q, k, v = SiLU(CausalDepthwiseConv(x W_q)), … (x W_k), … (x W_v)   D → P
    q, k    = L2Norm(q_h), L2Norm(k_h) per head;  q_h *= d^-1/2
    g       = −exp(A_log_h) · softplus((x W_fa) W_fb + dt_bias)  log-decay
    β       = sigmoid(x W_b)                          one per head and token
    S_t     = Diag(exp g_t) S_{t−1};  S_t += β_t k_t (v_t − S_tᵀ k_t)ᵀ
    o_t     = S_tᵀ q_t                                S ∈ R^{d×d}, S_0 = 0
    out     = (RMSNorm_d(o) ⊙ sigmoid((x W_ga) W_gb)) W_o

W_q, W_k, W_v are one (D, 3, P) matrix and their three convolutions (width
``cfg.conv_kernel``, no bias) one depthwise convolution over the 3P
channels (``ssm._causal_conv``); the output norm's scale (d,) is shared
by the heads. The projections run in the compute dtype; g, β and
everything after the projections run in float32.

**The chunked form** (``chunk_scan``). Within a chunk of C tokens let G_t
be the sum of g from the chunk's start to t (float32, per channel, ≤ 0 and
falling), k̃_t = k_t ⊙ e^{G_t}, q̃_t = q_t ⊙ e^{G_t}, k̂_t = k_t ⊙ e^{G_C−G_t}
(every factor ≤ 1), and

    A_ti = Σ_c k_tc k_ic e^{G_tc − G_ic}   (i < t)
    P_ti = Σ_c q_tc k_ic e^{G_tc − G_ic}   (i ≤ t)

The delta rule's corrections solve one unit lower-triangular system a
chunk (the WY / UT transform): (I + diag(β) A) [W_k ‖ W_v] = diag(β)
[K̃ ‖ V]. With the state S at the chunk's start, U = W_v − W_k S, the
chunk's outputs are O = Q̃ S + P U and the next state is Diag(e^{G_C}) S +
K̂ᵀ U; as an affine carry, S' = M S + N with M = Diag(e^{G_C}) − K̂ᵀ W_k and
N = K̂ᵀ W_v, and O = (Q̃ − P W_k) S + P W_v. Everything but the carry is
batched over all chunks of all heads; the carry (``carry``) is one
batched product a chunk, in float32, as the state is kept.

**The pair decays.** e^{G_t − G_i} taken as e^{G_t} · e^{−G_i} overflows
float32 once −G_i passes ~88, which the published initialisation (A =
exp(A_log) up to 16) reaches inside one chunk. So A and P are built by
halving (``_pairs``): the cross block of a chunk's two halves takes the
decays against the last position r of the first half, (a_t e^{G_t − G_r})
· (k_i e^{G_r − G_i}), both factors ≤ 1; each half splits the same way,
down to single tokens: log2 C levels, one batched product each. No decay
is clamped or dropped, whatever its size. Each exponent is summed afresh
from r (G_t − G_r = Σ_{r<s≤t} g_s, G_r − G_i = Σ_{i<s≤r} g_s, and
G_C − G_t likewise), never taken as a difference of the chunk's running
sums: once those reach hundreds, a difference of two of them loses the
near pairs' decay to float32 rounding.

The scan's products take float32 operands (the decayed keys and queries
carry float32 exponentials) and accumulate in float32. The whole mixer is
one ``kda.mixer`` span and the scan (its layout, the chunked form and the
carry) one ``kda.chunk`` span inside it. Only the full-sequence forward of
one device is here: ``prefill`` and ``decode_step`` refuse a KDA model (no
state cache is built), and so does a mesh.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.schema import ParamDef
from repro_torch.models.layers import rms_norm
from repro_torch.models.ssm import _causal_conv
from repro_torch.runtime import trace

L2_EPS = 1e-6         # the public kernel's L2Norm eps
CHUNK = 64            # tokens per chunk of the scan, as the public kernel


def kda_schema(cfg: ModelConfig) -> Dict[str, Any]:
    D, H, d = cfg.d_model, cfg.kda_heads, cfg.kda_head_dim
    P, r = H * d, cfg.kda_gate_rank
    return {
        "w_qkv": ParamDef((D, 3, P), ("embed", None, "heads"), init="lecun"),
        "conv_w": ParamDef((cfg.conv_kernel, 3 * P), (None, "heads"),
                           init="lecun"),
        "w_fa": ParamDef((D, r), ("embed", None), init="lecun"),
        "w_fb": ParamDef((r, P), (None, "heads"), init="lecun"),
        "dt_bias": ParamDef((P,), ("heads",), init="custom",
                            custom="ssm_dt_bias"),
        "a_log": ParamDef((H,), ("heads",), init="custom",
                          custom="ssm_a_log"),
        "w_b": ParamDef((D, H), ("embed", "heads"), init="lecun"),
        "w_ga": ParamDef((D, r), ("embed", None), init="lecun"),
        "w_gb": ParamDef((r, P), (None, "heads"), init="lecun"),
        "o_norm": {"w": ParamDef((d,), (None,), init="ones")},
        "wo": ParamDef((P, D), ("heads", "embed"), init="lecun"),
    }


def _l2norm(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """x / sqrt(Σx² + eps) over the last axis, times ``scale``, float32."""
    x = x.float()
    return x * (torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + L2_EPS)
                * scale)


def decay(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """g (B, S, H, d) float32: each channel's log-decay of x (B, S, D)."""
    B, S, _ = x.shape
    H, d = cfg.kda_heads, cfg.kda_head_dim
    z = (x @ p["w_fa"].to(x.dtype)) @ p["w_fb"].to(x.dtype)
    z = F.softplus(z.float() + p["dt_bias"].float())
    return -torch.exp(p["a_log"].float())[:, None] * z.reshape(B, S, H, d)


def _levels(C: int):
    """The halving levels of a chunk of C tokens, from its halves down to
    single tokens: h, the half block's length."""
    return [C >> (j + 1) for j in range(C.bit_length() - 1)]


@functools.lru_cache(maxsize=None)
def _plan(C: int, device: torch.device):
    """The chunk's fixed index work, for C a power of two:

    * sums (L·C + 2C, C), 0/1: each row the sum of g that one exponent
      needs (L = log2 C levels). First every level's first-half positions
      i, level by level, block by block: Σ_{i<s≤r}, r the last position of
      the half; then every level's second-half positions t, in the same
      order: Σ_{r<s≤t}; then G_t = Σ_{s≤t}; then G_C − G_t = Σ_{s>t}.
      Every sum is over g ≤ 0 alone: no rounding cancels.
    * place: the flat (row·C + column) place in the C × C matrix of each
      cross-block entry, level by level, block by block, row by row."""
    firsts, seconds, place = [], [], []
    for h in _levels(C):
        for b in range(0, C, 2 * h):
            r = b + h - 1
            firsts += [range(i + 1, r + 1) for i in range(b, b + h)]
            seconds += [range(r + 1, t + 1) for t in range(b + h, b + 2 * h)]
            place += [t * C + i for t in range(b + h, b + 2 * h)
                      for i in range(b, b + h)]
    rows = firsts + seconds + [range(0, t + 1) for t in range(C)] \
        + [range(t + 1, C) for t in range(C)]
    sums = torch.zeros(len(rows), C)
    for j, cols in enumerate(rows):
        sums[j, list(cols)] = 1.0
    return sums.to(device), torch.tensor(place, device=device)


def _pairs(q, k, e1, e2, place):
    """(A, P's strictly lower part), each (Z, C, C), from q, k (Z, C, d)
    and the exponentials e1 = e^{G_r − G_i}, e2 = e^{G_t − G_r} of every
    level's cross blocks (Z, L·C/2, d; ``_plan``), placed by ``place``."""
    Z, C, d = k.shape
    blocks = ([], [])
    for h, ef, es in zip(_levels(C), e1.split(C // 2, dim=1),
                         e2.split(C // 2, dim=1)):
        shape = (Z, C // (2 * h), h, d)
        kf, ks = k.view(Z, C // (2 * h), 2, h, d).unbind(2)
        _, qs = q.view(Z, C // (2 * h), 2, h, d).unbind(2)
        right = kf * ef.view(shape)
        for out, a in zip(blocks, (ks, qs)):
            a = a * es.view(shape)
            if h <= 2:   # products of 1 or 2 rows: sums, not tiny GEMMs
                blk = torch.sum(a[..., :, None, :] * right[..., None, :, :],
                                dim=-1)
            else:
                blk = torch.matmul(a, right.transpose(-1, -2))
            out.append(blk.reshape(Z, -1))
    return [k.new_zeros((Z, C * C)).index_copy(1, place, torch.cat(
        b, dim=1)).view(Z, C, C) for b in blocks]


def carry(M: torch.Tensor, N: torch.Tensor) -> torch.Tensor:
    """The state at each chunk's start, (Z, n, d, d) float32, from S_0 = 0
    and S_{j+1} = M_j S_j + N_j; M (Z, n, d, d), N (Z, n, d, d)."""
    Ms, Ns = M.unbind(1), N.unbind(1)
    states = [M.new_zeros(M.shape[0], M.shape[2], N.shape[3])]
    for j in range(M.shape[1] - 1):
        states.append(torch.baddbmm(Ns[j], Ms[j], states[-1]))
    return torch.stack(states, dim=1)


def chunk_scan(q, k, v, g, beta, chunk: int = CHUNK) -> torch.Tensor:
    """The gated delta rule of q, k, v, g (B, S, H, d) and beta (B, S, H),
    from S_0 = 0, in chunks of ``chunk`` tokens (a power of two) → o
    (B, S, H, d) float32. The sequence is padded to whole chunks with
    β = g = 0 and zero keys, which change no state."""
    B, S, H, d = k.shape
    C = chunk
    pad = -S % C
    n = (S + pad) // C
    Z = B * H

    def lay(t):          # (B, S, H, e) → (Z·n, C, e) float32, one copy
        out = t.new_empty((B, H, S + pad, t.shape[-1]), dtype=torch.float32)
        if pad:
            out[:, :, S:] = 0.0
            out[:, :, :S].copy_(t.transpose(1, 2))
        else:
            out.copy_(t.transpose(1, 2))
        return out.view(Z * n, C, t.shape[-1])

    q, k, v, g, beta = (lay(t) for t in (q, k, v, g, beta[..., None]))
    sums, place = _plan(C, g.device)
    L2 = (len(sums) - 2 * C) // 2
    ex = torch.exp(torch.bmm(sums.expand(Z * n, -1, -1), g))
    e1, e2, E, after = ex.split([L2, L2, C, C], dim=1)   # E = e^{G_t}
    A, P = _pairs(q, k, e1, e2, place)
    P = P + torch.diag_embed(torch.sum(q * k, dim=-1))
    # T = (I + diag(β) A)⁻¹ diag(β): the chunk's corrections W = T [K̃ ‖ V]
    # (unitriangular: the solve takes the unit diagonal as given)
    T = torch.linalg.solve_triangular(
        beta * A, torch.diag_embed(beta[..., 0]), upper=False,
        unitriangular=True)
    kt, qt = k * E, q * E
    Y = torch.bmm((k * after).transpose(1, 2), T)             # K̂ᵀ T
    M = torch.diag_embed(E[:, -1]) - torch.bmm(Y, kt)
    states = carry(M.view(Z, n, d, d), torch.bmm(Y, v).view(Z, n, d, d))
    PT = torch.bmm(P, T)
    o = torch.baddbmm(torch.bmm(PT, v), qt - torch.bmm(PT, kt),
                      states.view(Z * n, d, d))
    o = o.view(B, H, n * C, d)
    return (o[:, :, :S] if pad else o).transpose(1, 2)


def kda_apply(p, x: torch.Tensor, cfg: ModelConfig, mesh=None
              ) -> torch.Tensor:
    """Full-sequence KDA of x (B, S, D) → (B, S, D)."""
    if mesh is not None:
        raise NotImplementedError("KDA runs on one device: no mesh")
    with trace.span("kda.mixer", x):
        B, S, D = x.shape
        H, d = cfg.kda_heads, cfg.kda_head_dim
        dt = x.dtype
        qkv = x @ p["w_qkv"].reshape(D, -1).to(dt)
        qkv, _ = _causal_conv(qkv, p["conv_w"], None)
        q, k, v = (t.reshape(B, S, H, d) for t in qkv.split(H * d, dim=-1))
        q = _l2norm(q, d ** -0.5)
        k = _l2norm(k)
        g = decay(p, x, cfg)
        beta = torch.sigmoid((x @ p["w_b"].to(dt)).float())
        with trace.span("kda.chunk", x):
            o = chunk_scan(q, k, v, g, beta, CHUNK)
        gate = (x @ p["w_ga"].to(dt)) @ p["w_gb"].to(dt)
        o = rms_norm(o, p["o_norm"]["w"], cfg.norm_eps, False) \
            * torch.sigmoid(gate.float()).reshape(B, S, H, d)
        return o.reshape(B, S, H * d).to(dt) @ p["wo"].to(dt)
