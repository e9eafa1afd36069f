"""Shared transformer layer library (the attention-family kinds).

Pure functions over dicts of tensors, as in the JAX package:
``*_schema(cfg)`` declares parameters, ``*_apply`` runs a full sequence,
``*_decode`` runs one token against a cache. Attention is chunked over
queries (scores never materialise at (S, T) for long sequences). With
``LayerCtx.use_flash`` set, full-sequence self-attention (the encoder's,
``loss_fn``'s and the prefill's) goes through the flash kernel
(``repro_torch.kernels.flash_attention``) instead, on a mesh on the rank's
local heads; cross-attention and decode attention stay plain. (The JAX
package's prefill attention is plain XLA; ROADMAP Queue 3 row 3.)

**On a mesh** (``LayerCtx.mesh``, a ``launch.mesh.Mesh``) each parameter is
this rank's block under ``common.logical`` (``shard_params``), and a layer
readies its blocks right before use (``ready_params``): a dimension
sharded over ``data`` (ZeRO-3) is all-gathered, with a reduce-scatter as
its backward; a dimension sharded over ``model`` stays sharded where the
compute is tensor-parallel, and is otherwise all-gathered for a compute
every ``model`` rank repeats (its backward takes the rank's block). The
policy is the JAX package's ``_qkv``: attention heads split over ``model``
when ``H % tp == 0``, kv heads when ``Hkv % tp == 0``, else replicated;
the output projection is row-parallel and ends in one ``psum`` over
``model``; the MLP is column-parallel (gate / up over ``ff``), then
row-parallel, then one ``psum``; the recurrent mixers split their heads
(``models/ssm.py``, ``ssm_heads``) or width (``models/griffin.py``,
``lru``) the same way, with one more all-reduce each where the JAX
program holds it (SSD's norm statistic over the whole d_inner, RG-LRU's
gate partials). Over ``model`` the replicated activations
and their cotangents are the same on every rank: a tensor entering a
tensor-parallel compute passes ``pvary`` (its backward sums the ranks'
parts), a ``psum``'s cotangent is the cotangent, and so the gradient of a
leaf replicated over ``model`` is the same on every ``model`` rank and
needs no reduction there. Over the batch axes each rank's cotangents are
its rows' part (``train.step`` sums them).

**Decode caches on a mesh** take one of two layouts (``cache_layout``,
``LayerCtx.cache_layout``; the two are the same tensors off a mesh):

* ``"seq"``, the JAX package's and the default: a full cache holds the
  rank's ``T/tp`` sequence slots of every kv head (logical spec
  ``("batch", "seq_kv", None, None)``); a ring (a local layer whose window
  is shorter than the cache) and a cross-attention cache hold every kv
  head on every ``model`` rank. The prefill computes k and v on the
  rank's heads and lays them out with one counted ``all_to_all`` over
  ``model`` (``cache_relayout``) where the kv heads split, else a plain
  slice; a replicated cache gathers the heads (``cache_gather``). A
  decode step gathers the one-token q (and k, v where they split) over
  ``model`` (``decode_qkv_gather``), the rank owning slot ``pos`` writes
  it, every rank attends over its slice, and the flash-decode combine
  (``combine_partials``: one ``decode_max`` and one ``decode_sum``
  all-reduce of (B, H) statistics) gives every rank the whole output,
  whose heads of the rank go through the row-parallel ``wo``.
* ``"heads"``: every sequence slot of the kv heads the rank's attention
  reads (``cache_heads``); prefill and decode need no collective of
  their own.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.logical import axes_of, batch_axes, to_physical
from repro_torch.common.schema import ParamDef
from repro_torch.core import collectives

NEG_INF = -2.3819763e38  # the finite mask value of the JAX package
CACHE_LAYOUTS = ("seq", "heads")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float,
             zero_centered: bool) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = (1.0 + w) if zero_centered else w
    return (x * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def norm_schema(cfg: ModelConfig, d: int) -> Dict[str, ParamDef]:
    if cfg.norm_type == "ln":
        return {"w": ParamDef((d,), (None,), init="ones"),
                "b": ParamDef((d,), (None,), init="zeros")}
    init = "zeros" if cfg.rms_zero_centered else "ones"
    return {"w": ParamDef((d,), (None,), init=init)}


def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_type == "ln":
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps, cfg.rms_zero_centered)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, hd: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables, shape positions.shape + (hd//2,). float32."""
    dev = positions.device
    freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=dev) / hd))
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (S, hd//2) or broadcastable."""
    dt = x.dtype
    x = x.float()
    x1, x2 = torch.chunk(x, 2, dim=-1)
    # tables broadcast over the head axis: (S, hd/2) -> (S, 1, hd/2)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# layer context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerCtx:
    cfg: ModelConfig
    rope_local: Tuple[torch.Tensor, torch.Tensor]   # window/default theta
    rope_global: Tuple[torch.Tensor, torch.Tensor]  # gemma3 global theta
    memory: Optional[torch.Tensor] = None   # encoder memory (B, M, D)
    pos: Optional[int] = None               # decode: current position
    q_chunk: int = 1024
    use_flash: bool = False                 # full attn through the kernel
    mesh: Optional[Any] = None              # a launch.mesh.Mesh
    rules: Optional[dict] = None            # logical rules (None: default)
    cache_layout: str = "seq"               # decode caches on a mesh


# ---------------------------------------------------------------------------
# parameters on a mesh
# ---------------------------------------------------------------------------

def tp_size(mesh) -> int:
    if mesh is not None and "model" in mesh.axis_names:
        return mesh.shape["model"]
    return 1


def _gather_dim(w: torch.Tensor, dim: int, mesh, axes, invariant: bool):
    moved = w.movedim(dim, 0).contiguous()
    gather = (collectives.all_gather_invariant if invariant
              else collectives.all_gather)
    parts = gather(moved, mesh, axis=axes)
    return parts.reshape((-1,) + tuple(moved.shape[1:])).movedim(0, dim)


def ready_leaf(w: torch.Tensor, logical, mesh, keep=()) -> torch.Tensor:
    """This rank's block ``w`` of a leaf with logical axes ``logical`` as
    the compute reads it: every sharded dimension gathered except those
    whose logical name is in ``keep`` (a tensor-parallel compute reads its
    block of them). A gather over batch axes takes a reduce-scatter as its
    backward, one over ``model`` the rank's block of the cotangent."""
    if mesh is None:
        return w
    # Weight axes, not rows: ``embed`` is sharded over the physical data
    # axes (ZeRO-3) whatever a shape's rule table does with the logical
    # ``batch`` axis, so this reads the default table's data axes and not
    # the caller's rules.
    dp = set(batch_axes(mesh))
    for dim, (name, entry) in enumerate(zip(logical,
                                            to_physical(logical, mesh))):
        axes = axes_of(entry)
        if not axes or name in keep:
            continue
        if set(axes) <= dp:
            w = _gather_dim(w, dim, mesh, axes, invariant=False)
        elif axes == ("model",):
            w = _gather_dim(w, dim, mesh, axes, invariant=True)
        else:
            raise ValueError(f"dimension {dim} of a {tuple(logical)} leaf "
                             f"is sharded over {axes}: batch and model "
                             f"axes on one dimension")
    return w


def ready_params(p: Dict[str, Any], schema: Dict[str, Any], mesh,
                 keep=()) -> Dict[str, Any]:
    """``ready_leaf`` over every leaf of ``p`` (a dict nested as
    ``schema``, which may declare keys ``p`` lacks)."""
    if mesh is None:
        return p
    return {k: (ready_leaf(v, schema[k].logical, mesh, keep)
                if torch.is_tensor(v) else
                ready_params(v, schema[k], mesh, keep))
            for k, v in p.items()}


def _pvary(x, mesh):
    return collectives.pvary(x, mesh, axis="model")


def _psum(x, mesh):
    return collectives.psum(x, mesh, axis="model")


def tp_vary(x, mesh):
    """``x``, replicated over ``model``, entering a tensor-parallel compute
    (``pvary``) where the mesh splits ``model``; else ``x``."""
    return _pvary(x, mesh) if tp_size(mesh) > 1 else x


def tp_sum(x, mesh):
    """The sum of the ranks' parts ``x`` over ``model`` (``psum``) where
    the mesh splits it; else ``x``."""
    return _psum(x, mesh) if tp_size(mesh) > 1 else x


def rope_for(kind: str, ctx: LayerCtx):
    if kind == "attn" and ctx.cfg.rope_theta_global:
        return ctx.rope_global
    return ctx.rope_local


# ---------------------------------------------------------------------------
# core chunked attention
# ---------------------------------------------------------------------------

def _mask_bias(qpos, kpos, *, causal: bool, window: int) -> torch.Tensor:
    """(len(qpos), len(kpos)) additive bias of 0 / NEG_INF."""
    ok = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= qpos[:, None] >= kpos[None, :]
    if window:
        ok &= qpos[:, None] - kpos[None, :] < window
    return torch.where(ok, 0.0, NEG_INF).float()


def _softmax_pv(s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax over the last axis of f32 scores, rounded to v's dtype, times
    v: (b, k, g, q, t) · (b, t, k, h) → (b, q, k, g, h)."""
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgqt,btkh->bqkgh", p, v)


def _scores(qi: torch.Tensor, k: torch.Tensor, softcap: float) -> torch.Tensor:
    """(b, q, k, g, h) · (b, t, k, h) → f32 scores (b, k, g, q, t)."""
    s = torch.einsum("bqkgh,btkh->bkgqt", qi.float(), k.float())
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    return s


def chunked_attention(
    q: torch.Tensor,             # (B, S, H, hd) — already scaled
    k: torch.Tensor,             # (B, T, Hkv, hd)
    v: torch.Tensor,             # (B, T, Hkv, hd)
    *,
    causal: bool,
    window: int = 0,
    softcap: float = 0.0,
    q_chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qc = q_chunk if S % q_chunk == 0 else S
    qr = q.reshape(B, S // qc, qc, Hkv, G, hd)
    kpos = torch.arange(T, device=q.device)
    # under autograd each chunk is checkpointed, as the JAX package's
    # jax.checkpoint per chunk: its (qc, T) f32 scores are recomputed in
    # the backward instead of stored for every chunk
    remat = torch.is_grad_enabled()
    outs = []
    for i in range(S // qc):
        qpos = q_offset + i * qc + torch.arange(qc, device=q.device)
        args = (qr[:, i], k, v, qpos, kpos, causal, window, softcap)
        outs.append(checkpoint(_chunk_attention, *args, use_reentrant=False)
                    if remat else _chunk_attention(*args))
    return torch.stack(outs, dim=1).reshape(B, S, H, hd)


def _chunk_attention(qi, k, v, qpos, kpos, causal: bool, window: int,
                     softcap: float) -> torch.Tensor:
    """One query chunk: (b, q, k, g, h) against all keys."""
    s = _scores(qi, k, softcap)
    s = s + _mask_bias(qpos, kpos, causal=causal, window=window)
    return _softmax_pv(s, v)


def decode_attention(
    q: torch.Tensor,             # (B, 1, H, hd) — already scaled
    k: torch.Tensor,             # (B, T, Hkv, hd) cache
    v: torch.Tensor,
    kv_positions: torch.Tensor,  # (T,) absolute token position per slot, -1 invalid
    pos: int,                    # current position
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    s = _scores(q.reshape(B, 1, Hkv, G, hd), k, softcap)
    ok = (kv_positions >= 0) & (kv_positions <= pos)
    if window:
        ok &= kv_positions > pos - window
    s = torch.where(ok, s, torch.tensor(NEG_INF, device=s.device))
    return _softmax_pv(s, v).reshape(B, 1, H, hd)


def decode_partials(
    q: torch.Tensor,             # (B, 1, H, hd) — already scaled
    k: torch.Tensor,             # (B, T, Hkv, hd) one slice of a cache
    v: torch.Tensor,
    kv_positions: torch.Tensor,  # (T,) absolute position per slot
    pos: int,
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``decode_attention``'s softmax over one slice of the cache, left
    unnormalised: (m, l, o), f32, m and l (B, 1, Hkv, G, 1), o (B, 1, Hkv,
    G, hd) — the largest masked score, the sum of exp(s − m) and the sum
    of exp(s − m)·v. Masked slots score the finite ``NEG_INF``, so a slice
    with no valid slot has m = NEG_INF and finite l and o, and
    ``combine_partials`` weighs it exp(NEG_INF − M) = 0."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    s = _scores(q.reshape(B, 1, Hkv, G, hd), k, softcap)   # (b,k,g,1,t)
    ok = (kv_positions >= 0) & (kv_positions <= pos)
    if window:
        ok &= kv_positions > pos - window
    s = torch.where(ok, s, torch.tensor(NEG_INF, device=s.device))
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    o = torch.einsum("bkgqt,btkh->bqkgh", e.to(v.dtype), v).float()
    to_q = lambda t: t.permute(0, 3, 1, 2, 4)              # noqa: E731
    return to_q(m), to_q(torch.sum(e, dim=-1, keepdim=True)), o


def combine_partials(m: torch.Tensor, ssum: torch.Tensor,
                     o: torch.Tensor, mesh=None) -> torch.Tensor:
    """The flash-decode combine: o = Σ_r e^{m_r−M}·o_r / Σ_r e^{m_r−M}·l_r
    with M = max_r m_r (``ssum`` is l), as (B, 1, Hkv, G, hd) f32. With
    ``mesh``, the slices r are the ranks of ``model`` and (m, l, o) this
    rank's: one max all-reduce of m (``decode_max``) and one sum of the
    rescaled [l | o] (``decode_sum``), both over (B, H) rows. Without, the
    slices are stacked on a leading axis of the three."""
    if mesh is None:
        M = torch.amax(m, dim=0)
        w = torch.exp(m - M)
        return torch.sum(o * w, dim=0) / torch.sum(ssum * w, dim=0)
    M = collectives.all_reduce(m, mesh, axis="model", op="max",
                               name="decode_max")
    w = torch.exp(m - M)
    both = collectives.all_reduce(torch.cat([ssum * w, o * w], dim=-1),
                                  mesh, axis="model", name="decode_sum")
    return both[..., 1:] / both[..., :1]


# ---------------------------------------------------------------------------
# attention layer (kinds: attn, local, enc, and the attention of dec)
# ---------------------------------------------------------------------------

def attn_schema(cfg: ModelConfig, *, cross: bool = False,
                gated: bool = False) -> Dict[str, Any]:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s: Dict[str, Any] = {
        "wq": ParamDef((D, H * hd), ("embed", "heads"), init="lecun"),
        "wk": ParamDef((D, Hkv * hd), ("embed", "kv_heads"), init="lecun"),
        "wv": ParamDef((D, Hkv * hd), ("embed", "kv_heads"), init="lecun"),
        "wo": ParamDef((H * hd, D), ("heads", "embed"), init="lecun"),
    }
    if cfg.qkv_bias or cfg.mlp_bias:
        s["bq"] = ParamDef((H * hd,), ("heads",), init="zeros")
        s["bk"] = ParamDef((Hkv * hd,), ("kv_heads",), init="zeros")
        s["bv"] = ParamDef((Hkv * hd,), ("kv_heads",), init="zeros")
    if cfg.mlp_bias:
        s["bo"] = ParamDef((D,), (None,), init="zeros")
    norm_init = "zeros" if cfg.rms_zero_centered else "ones"
    if cfg.qk_norm:
        s["q_norm"] = ParamDef((hd,), (None,), init=norm_init)
        s["k_norm"] = ParamDef((hd,), (None,), init=norm_init)
    if gated:  # llama-3.2-vision cross-attn gates
        s["gate_attn"] = ParamDef((1,), (None,), init="zeros")
    return s


def _proj(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., D) @ w (D, N) [+ b] in x's dtype."""
    out = x @ w.to(x.dtype)
    return out if b is None else out + b.to(x.dtype)


def _splits(cfg: ModelConfig, tp: int) -> Tuple[bool, bool]:
    """(q heads split over a ``model`` axis of ``tp`` ranks?, kv heads?)."""
    return (tp > 1 and cfg.n_heads % tp == 0,
            tp > 1 and cfg.n_kv_heads % tp == 0)


def _head_split(cfg: ModelConfig, mesh) -> Tuple[int, bool, bool]:
    """(tp, q heads split over model?, kv heads split over model?)."""
    tp = tp_size(mesh)
    return (tp, *_splits(cfg, tp))


def _attn_params(p, cfg: ModelConfig, mesh):
    """The attention weights as this rank's compute reads them."""
    if mesh is None:
        return p
    _, q_split, kv_split = _head_split(cfg, mesh)
    keep = (("heads",) if q_split else ()) + \
        (("kv_heads",) if kv_split else ())
    return ready_params(p, attn_schema(cfg, gated=True), mesh, keep)


def _local_kv(t: torch.Tensor, cfg: ModelConfig, mesh) -> torch.Tensor:
    """Where the q heads split over ``model`` and the kv heads do not:
    the kv head of each of this rank's q heads, from the replicated
    (B, T, Hkv, hd) keys or values (GQA ratio 1 after the pick)."""
    tp = tp_size(mesh)
    Hl = cfg.n_heads // tp
    G = cfg.n_heads // cfg.n_kv_heads
    first = mesh.axis_index("model") * Hl
    idx = torch.div(torch.arange(first, first + Hl, device=t.device), G,
                    rounding_mode="floor")
    return _pvary(t, mesh)[:, :, idx]


def _q_proj(p, x, cfg: ModelConfig, mesh=None):
    """q (B, S, H_local, hd) from x, q_norm applied."""
    B, S, _ = x.shape
    _, q_split, _ = _head_split(cfg, mesh)
    xq = _pvary(x, mesh) if q_split else x
    q = _proj(xq, p["wq"], p.get("bq")).reshape(B, S, -1, cfg.hd)
    if "q_norm" in p:
        # a replicated weight read by the rank's heads only: its cotangent
        # is the rank's part
        w = _pvary(p["q_norm"], mesh) if q_split else p["q_norm"]
        q = rms_norm(q, w, cfg.norm_eps, cfg.rms_zero_centered)
    return q, xq


def _kv_proj(p, mem, cfg: ModelConfig, mesh=None, mem_in=None,
             pick: bool = True):
    """k, v (B, M, Hkv_local, hd) from mem, k_norm applied; on a mesh
    the rank's kv heads (``_local_kv`` where only the q heads split;
    with ``pick=False`` every kv head there instead). ``mem_in`` is
    ``mem`` already through ``pvary``, when it is."""
    B, M, _ = mem.shape
    _, q_split, kv_split = _head_split(cfg, mesh)
    if kv_split:
        xm = mem_in if mem_in is not None else _pvary(mem, mesh)
    else:
        xm = mem
    k = _proj(xm, p["wk"], p.get("bk")).reshape(B, M, -1, cfg.hd)
    v = _proj(xm, p["wv"], p.get("bv")).reshape(B, M, -1, cfg.hd)
    if "k_norm" in p:
        w = _pvary(p["k_norm"], mesh) if kv_split else p["k_norm"]
        k = rms_norm(k, w, cfg.norm_eps, cfg.rms_zero_centered)
    if pick and q_split and not kv_split:
        k, v = _local_kv(k, cfg, mesh), _local_kv(v, cfg, mesh)
    return k, v


def _qkv(p, x, mem, cfg: ModelConfig, mesh=None, pick: bool = True):
    """Project q from x and k, v from mem (mem = x for self-attention);
    ``pick`` as in ``_kv_proj``."""
    q, xq = _q_proj(p, x, cfg, mesh)
    _, q_split, kv_split = _head_split(cfg, mesh)
    share = mem is x and q_split and kv_split
    k, v = _kv_proj(p, mem, cfg, mesh, mem_in=xq if share else None,
                    pick=pick)
    return q, k, v


def _q_scale(cfg: ModelConfig) -> float:
    if cfg.query_pre_attn_scalar:
        return cfg.query_pre_attn_scalar ** -0.5
    return cfg.hd ** -0.5


def _out_proj(p, o, x_dtype, cfg: ModelConfig, mesh=None):
    """o (B, S, H_local, hd) through wo; on a mesh with split heads a
    row-parallel projection, then one psum over ``model``."""
    B, S = o.shape[0], o.shape[1]
    out = o.reshape(B, S, -1).to(x_dtype) @ p["wo"].to(x_dtype)
    if _head_split(cfg, mesh)[1]:
        out = _psum(out, mesh)
    return out if "bo" not in p else out + p["bo"].to(x_dtype)


def _self_attn_args(p, x, ctx: LayerCtx, kind: str, pick: bool = True):
    cfg = ctx.cfg
    q, k, v = _qkv(p, x, x, cfg, ctx.mesh, pick)
    cos, sin = rope_for(kind, ctx)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    mask = dict(causal=kind != "enc",
                window=cfg.window if kind == "local" else 0,
                softcap=cfg.attn_logit_softcap)
    return q, k, v, mask


def _attend(q, k, v, mask, ctx: LayerCtx):
    if ctx.use_flash:
        from repro_torch.kernels.flash_attention import ops as flash_ops
        return flash_ops.flash_attention(q, k, v, **mask)
    return chunked_attention(q, k, v, **mask, q_chunk=ctx.q_chunk)


def attn_apply(p, x, ctx: LayerCtx, *, kind: str) -> torch.Tensor:
    """Full-sequence attention for kinds attn/local/enc. Returns (B,S,D)."""
    p = _attn_params(p, ctx.cfg, ctx.mesh)
    q, k, v, mask = _self_attn_args(p, x, ctx, kind)
    o = _attend(q * _q_scale(ctx.cfg), k, v, mask, ctx)
    return _out_proj(p, o, x.dtype, ctx.cfg, ctx.mesh)


def _gated(p, out, x_dtype):
    if "gate_attn" in p:
        out = torch.tanh(p["gate_attn"].to(x_dtype)) * out
    return out


def cross_attn_apply(p, x, ctx: LayerCtx, cache=None) -> torch.Tensor:
    """Cross-attention to ctx.memory. No rope, no causal mask. ``cache``:
    the memory's keys and values, when ``cross_build_cache`` has them
    already (a prefill; in ``ctx.cache_layout``)."""
    cfg = ctx.cfg
    p = _attn_params(p, cfg, ctx.mesh)
    if cache is None:
        q, k, v = _qkv(p, x, ctx.memory.to(x.dtype), cfg, ctx.mesh)
    else:
        (q, _), k, v = _q_proj(p, x, cfg, ctx.mesh), cache["k"], cache["v"]
        if _seq_layout(ctx):
            k = _rank_kv_heads(k, cfg, ctx.mesh)
            v = _rank_kv_heads(v, cfg, ctx.mesh)
    o = chunked_attention(q * _q_scale(cfg), k, v, causal=False,
                          q_chunk=ctx.q_chunk)
    return _gated(p, _out_proj(p, o, x.dtype, cfg, ctx.mesh), x.dtype)


# --- caches ----------------------------------------------------------------

def check_cache_layout(layout: str) -> str:
    if layout not in CACHE_LAYOUTS:
        raise ValueError(f"cache_layout={layout!r}: one of {CACHE_LAYOUTS}")
    return layout


def cache_heads(cfg: ModelConfig, tp: int = 1) -> Tuple[int, Optional[str]]:
    """(heads, logical axis) of a KV cache in the ``"heads"`` layout for a
    ``model`` axis of ``tp`` ranks, as ``attn_prefill`` builds it there:
    the kv heads split over ``model`` where they divide (``kv_heads``);
    where only the q heads do, one kv head per q head, split with them
    (``heads``, the ``_local_kv`` pick); else every kv head on every
    rank."""
    q_split, kv_split = _splits(cfg, tp)
    if kv_split:
        return cfg.n_kv_heads, "kv_heads"
    if q_split:
        return cfg.n_heads, "heads"
    return cfg.n_kv_heads, None


def _cache_def(cfg: ModelConfig, batch: int, T: int, tp: int, layout: str,
               seq_sharded: bool) -> ParamDef:
    if check_cache_layout(layout) == "seq":
        heads, spec = cfg.n_kv_heads, (
            "batch", "seq_kv" if seq_sharded else None, None, None)
    else:
        heads, axis = cache_heads(cfg, tp)
        spec = ("batch", None, axis, None)
    return ParamDef((batch, T, heads, cfg.hd), spec, init="zeros",
                    dtype=compute_dtype(cfg))


def attn_cache_schema(cfg: ModelConfig, batch: int, seq_len: int, *,
                      kind: str, tp: int = 1,
                      layout: str = "seq") -> Dict[str, ParamDef]:
    """Decode KV cache; a local layer whose window is shorter than the
    sequence keeps a ring of ``window`` slots. ``layout="seq"`` (the JAX
    package's schema): a full cache's sequence over ``seq_kv`` (→
    ``model``), a ring replicated over ``model``, every kv head in both;
    ``"heads"``: the heads laid out for a ``model`` axis of ``tp`` ranks
    (``cache_heads``). Off a mesh the two are the same tensors."""
    is_ring = bool(kind == "local" and cfg.window and cfg.window < seq_len)
    T = cfg.window if is_ring else seq_len
    return {name: _cache_def(cfg, batch, T, tp, layout, not is_ring)
            for name in ("k", "v")}


def cross_cache_schema(cfg: ModelConfig, batch: int, mem_len: int, *,
                       tp: int = 1, layout: str = "seq"
                       ) -> Dict[str, ParamDef]:
    """The encoder-memory (cross-attention) cache: under ``"seq"`` every
    kv head on every ``model`` rank, as in the JAX schema."""
    return {name: _cache_def(cfg, batch, mem_len, tp, layout, False)
            for name in ("k", "v")}


def _ring_slots(pos: int, W: int, device=None) -> torch.Tensor:
    """Absolute token position held by each ring slot at decode position
    pos."""
    j = torch.arange(W, device=device)
    return pos - torch.remainder(pos - j, W)


def _seq_layout(ctx: LayerCtx) -> bool:
    """Whether this layer's caches take the ``"seq"`` layout on a split
    ``model`` axis (elsewhere the two layouts are the same tensors)."""
    return (check_cache_layout(ctx.cache_layout) == "seq"
            and tp_size(ctx.mesh) > 1)


def _gather_heads(parts, mesh, name: str):
    """Each (B, M, h, hd) tensor of ``parts``, the rank's block of h heads,
    as every rank's blocks in head order (B, M, tp·h, hd): one all-gather
    over ``model`` of the parts side by side, counted under ``name``."""
    sizes = [t.shape[2] for t in parts]
    both = torch.cat(parts, dim=2).contiguous()
    got = collectives.all_gather(both, mesh, axis="model", name=name)
    out, lo = [], 0
    for h in sizes:
        blk = got[:, :, :, lo:lo + h]                # (tp, B, M, h, hd)
        out.append(blk.permute(1, 2, 0, 3, 4).reshape(
            blk.shape[1], blk.shape[2], -1, blk.shape[4]))
        lo += h
    return out


def _rank_kv_heads(t: torch.Tensor, cfg: ModelConfig, mesh) -> torch.Tensor:
    """From a cache holding every kv head, the heads the rank's q heads
    read (its block where the kv heads split, the ``_local_kv`` pick
    where only the q heads do)."""
    tp, q_split, kv_split = _head_split(cfg, mesh)
    if kv_split:
        h = cfg.n_kv_heads // tp
        r = mesh.axis_index("model")
        return t[:, :, r * h:(r + 1) * h]
    if q_split:
        return _local_kv(t, cfg, mesh)
    return t


def _seq_slice(k, v, cfg: ModelConfig, mesh):
    """(B, T, h, hd) keys and values on the rank's kv heads (all of them
    where they do not split over ``model``) as the rank's ``T/tp``
    sequence slots of every kv head: one ``all_to_all`` over ``model``
    (``cache_relayout``) where the heads split, else a slice."""
    tp, _, kv_split = _head_split(cfg, mesh)
    B, T, h, hd = k.shape
    if T % tp:
        raise ValueError(f"a cache of {T} slots does not split over a "
                         f"model axis of {tp} ranks")
    Tl = T // tp
    r = mesh.axis_index("model")
    if not kv_split:
        # copies: a slice of one row is contiguous already, and as a view
        # it would keep the whole padded cache alive
        return (k[:, r * Tl:(r + 1) * Tl].clone(),
                v[:, r * Tl:(r + 1) * Tl].clone())
    # block j (slots of rank j) goes to rank j; block i arrives from rank
    # i, its heads of this rank's slots
    blocks = torch.stack([t.reshape(B, tp, Tl, h, hd).movedim(1, 0)
                          for t in (k, v)], dim=1)   # (tp, 2, B, Tl, h, hd)
    got = collectives.all_to_all(blocks, mesh, axis="model",
                                 name="cache_relayout")
    full = got.permute(1, 2, 3, 0, 4, 5).reshape(2, B, Tl, tp * h, hd)
    return full[0], full[1]


def attn_prefill(p, x, ctx: LayerCtx, *, kind: str, cache_len: int):
    """Full-seq attention that also returns the populated decode cache, in
    ``ctx.cache_layout``."""
    cfg = ctx.cfg
    mesh = ctx.mesh
    p = _attn_params(p, cfg, mesh)
    seq = _seq_layout(ctx)
    # under "seq" the cache takes every kv head the rank computed
    q, k, v, mask = _self_attn_args(p, x, ctx, kind, pick=not seq)
    ka, va = k, v
    _, q_split, kv_split = _head_split(cfg, mesh)
    if seq and q_split and not kv_split:
        ka, va = _local_kv(k, cfg, mesh), _local_kv(v, cfg, mesh)
    o = _attend(q * _q_scale(cfg), ka, va, mask, ctx)
    del ka, va
    S = x.shape[1]
    if kind == "local" and cfg.window and cfg.window < cache_len:
        W = cfg.window
        slots = (S - W + torch.arange(W, device=x.device)) % W
        cache = {}
        for name, t in (("k", k), ("v", v)):
            ring = torch.zeros_like(t[:, S - W:])
            ring[:, slots] = t[:, S - W:]
            cache[name] = ring
        if seq and kv_split:
            cache["k"], cache["v"] = _gather_heads(
                [cache["k"], cache["v"]], mesh, "cache_gather")
    else:
        pad = (0, 0, 0, 0, 0, cache_len - S)
        k, v = F.pad(k, pad), F.pad(v, pad)
        if seq:
            k, v = _seq_slice(k, v, cfg, mesh)
        cache = {"k": k, "v": v}
    return _out_proj(p, o, x.dtype, cfg, mesh), cache


def _write_slot(cache, slot: int, k, v) -> None:
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)


def attn_decode(p, x, cache, ctx: LayerCtx, *, kind: str):
    """One-token attention against the cache. x: (B,1,D). Writes the new
    key and value into ``cache`` in place (one slot each) and returns
    (output, cache)."""
    if _seq_layout(ctx):
        return _attn_decode_seq(p, x, cache, ctx, kind=kind)
    cfg = ctx.cfg
    pos = ctx.pos
    p = _attn_params(p, cfg, ctx.mesh)
    q, k, v = _qkv(p, x, x, cfg, ctx.mesh)
    cos, sin = rope_for(kind, ctx)  # tables for the single current position
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    T = cache["k"].shape[1]
    is_ring = kind == "local" and cfg.window and cfg.window == T
    _write_slot(cache, (pos % T) if is_ring else pos, k, v)
    if is_ring:
        kv_pos = _ring_slots(pos, T, x.device)
    else:
        kv_pos = torch.arange(T, device=x.device)
    o = decode_attention(q * _q_scale(cfg), cache["k"], cache["v"], kv_pos,
                         pos, window=cfg.window if kind == "local" else 0,
                         softcap=cfg.attn_logit_softcap)
    return _out_proj(p, o, x.dtype, cfg, ctx.mesh), cache


def _attn_decode_seq(p, x, cache, ctx: LayerCtx, *, kind: str):
    """``attn_decode`` against a ``"seq"`` cache on a split ``model``
    axis. The one-token projections run on the rank's heads as the
    prefill's do; one gather over ``model`` then gives every rank every
    head of q (and of k and v where those split), the choice of a
    gathered (B, 1, H, hd) row over the replicated projection, which would
    gather the whole of wq, wk and wv. A ring (replicated) writes its slot
    on every rank and attends on the rank's heads; a full cache's slot
    ``pos`` is written by the rank that holds it, at ``pos − r·T/tp``, and
    every rank attends over its slice, then ``combine_partials``."""
    cfg, pos, mesh = ctx.cfg, ctx.pos, ctx.mesh
    p = _attn_params(p, cfg, mesh)
    tp, q_split, kv_split = _head_split(cfg, mesh)
    q, xq = _q_proj(p, x, cfg, mesh)
    k, v = _kv_proj(p, x, cfg, mesh, pick=False,
                    mem_in=xq if q_split and kv_split else None)
    cos, sin = rope_for(kind, ctx)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    q = q * _q_scale(cfg)
    T = cache["k"].shape[1]
    window = cfg.window if kind == "local" else 0
    softcap = cfg.attn_logit_softcap
    if kind == "local" and cfg.window and cfg.window == T:
        if kv_split:
            k, v = _gather_heads([k, v], mesh, "decode_qkv_gather")
        _write_slot(cache, pos % T, k, v)
        o = decode_attention(q, _rank_kv_heads(cache["k"], cfg, mesh),
                             _rank_kv_heads(cache["v"], cfg, mesh),
                             _ring_slots(pos, T, x.device), pos,
                             window=window, softcap=softcap)
        return _out_proj(p, o, x.dtype, cfg, mesh), cache
    if kv_split:
        q, k, v = _gather_heads([q, k, v], mesh, "decode_qkv_gather")
    elif q_split:
        (q,) = _gather_heads([q], mesh, "decode_qkv_gather")
    r = mesh.axis_index("model")
    lo = r * T
    if lo <= pos < lo + T:
        _write_slot(cache, pos - lo, k, v)
    B, _, H, hd = q.shape
    parts = decode_partials(q, cache["k"], cache["v"],
                            lo + torch.arange(T, device=x.device), pos,
                            window=window, softcap=softcap)
    o = combine_partials(*parts, mesh=mesh).reshape(B, 1, H, hd)
    o = o.to(cache["v"].dtype)
    if q_split:
        hl = H // tp
        o = o[:, :, r * hl:(r + 1) * hl]
    return _out_proj(p, o, x.dtype, cfg, mesh), cache


def cross_attn_decode(p, x, cache, ctx: LayerCtx):
    """Cross-attention during decode: static precomputed memory K/V (under
    ``"seq"`` every kv head, of which the rank's q heads read theirs)."""
    cfg = ctx.cfg
    p = _attn_params(p, cfg, ctx.mesh)
    q, _ = _q_proj(p, x, cfg, ctx.mesh)
    k, v = cache["k"], cache["v"]
    if _seq_layout(ctx):
        k = _rank_kv_heads(k, cfg, ctx.mesh)
        v = _rank_kv_heads(v, cfg, ctx.mesh)
    T = k.shape[1]
    o = decode_attention(q * _q_scale(cfg), k, v,
                         torch.arange(T, device=x.device), T)
    return _gated(p, _out_proj(p, o, x.dtype, cfg, ctx.mesh), x.dtype), \
        cache


def cross_build_cache(p, memory, cfg: ModelConfig, mesh=None,
                      layout: str = "seq"):
    """Precompute cross-attention K/V from encoder memory: on a mesh in
    ``layout`` (``"heads"``: the rank's kv heads; ``"seq"``: every kv
    head, gathered over ``model`` where they split)."""
    p = _attn_params(p, cfg, mesh)
    seq = check_cache_layout(layout) == "seq" and tp_size(mesh) > 1
    k, v = _kv_proj(p, memory, cfg, mesh, pick=not seq)
    if seq and _head_split(cfg, mesh)[2]:
        k, v = _gather_heads([k, v], mesh, "cache_gather")
    dt = compute_dtype(cfg)
    return {"k": k.to(dt), "v": v.to(dt)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_schema(cfg: ModelConfig, d_ff: Optional[int] = None, *,
               gated_tag: bool = False) -> Dict[str, Any]:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    if cfg.mlp_gated:
        # gate and up fused into one (D, 2, F) projection, as in the JAX
        # package
        s = {"w_gateup": ParamDef((D, 2, Fd), ("embed", None, "ff"),
                                  init="lecun"),
             "w_down": ParamDef((Fd, D), ("ff", "embed"), init="lecun")}
    else:
        s = {"w_up": ParamDef((D, Fd), ("embed", "ff"), init="lecun"),
             "w_down": ParamDef((Fd, D), ("ff", "embed"), init="lecun")}
        if cfg.mlp_bias:
            s["b_up"] = ParamDef((Fd,), ("ff",), init="zeros")
            s["b_down"] = ParamDef((D,), (None,), init="zeros")
    if gated_tag:  # llama-3.2-vision cross layers gate their FFN too
        s["gate_ffn"] = ParamDef((1,), (None,), init="zeros")
    return s


def _act(x, kind: str):
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp_apply(p, x, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """The FFN; on a mesh column-parallel over ``ff`` (gate and up), then
    row-parallel (down), then one psum over ``model``."""
    tp = tp_size(mesh)
    if mesh is not None:
        p = ready_params(p, mlp_schema(cfg, gated_tag=True), mesh,
                         keep=("ff",))
        if tp > 1:
            x = _pvary(x, mesh)
    if cfg.mlp_gated:
        gu = torch.einsum("bsd,dtf->bstf", x, p["w_gateup"].to(x.dtype))
        out = _proj(_act(gu[:, :, 0], cfg.act) * gu[:, :, 1], p["w_down"])
    else:
        u = _proj(x, p["w_up"], p.get("b_up"))
        out = _proj(_act(u, cfg.act), p["w_down"])
    if tp > 1:
        out = _psum(out, mesh)
    if "b_down" in p:
        out = out + p["b_down"].to(out.dtype)
    if "gate_ffn" in p:
        out = torch.tanh(p["gate_ffn"].to(x.dtype)) * out
    return out
