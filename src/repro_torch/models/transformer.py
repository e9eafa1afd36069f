"""Model assembly: block-pattern stacks for the attention-family kinds.

The per-layer pattern (local/global attention, encoder-decoder layers) is
a repeating block; parameters are stacked per pattern position over block
repetitions, as in the JAX package, and the stack runs as a Python loop
over the leading block axis where the JAX package runs ``lax.scan``.
Remainder layers are unrolled around it.

Two serving entry points: ``prefill`` (last-token logits + populated
cache) and ``decode_step`` (one token against the cache). The layer kinds
``attn``, ``local``, ``enc`` and ``dec`` are ported; ``moe``, ``cross``,
``rglru`` and ``ssd`` raise (ROADMAP Queue 1 row 10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.schema import ParamDef, stack as stack_schema
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers
from repro_torch.models.embedding import embed_lookup, logits_matmul
from repro_torch.models.layers import (LayerCtx, apply_norm, compute_dtype,
                                       norm_schema, rope_tables)

_PORTED_KINDS = ("attn", "local", "enc", "dec")


def _cdt(cfg: ModelConfig) -> torch.dtype:
    return compute_dtype(cfg)


def _check_kind(kind: str) -> None:
    if kind not in _PORTED_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (ROADMAP Queue 1 row 10, "
            f"the LM stack); ported: {_PORTED_KINDS}")


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet: the port's LM path runs on one device "
            "(ROADMAP Queue 1 row 10, the LM stack)")


# ---------------------------------------------------------------------------
# per-layer schema / apply / prefill / decode, dispatched on kind
# ---------------------------------------------------------------------------

def layer_schema(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    _check_kind(kind)
    n = lambda: norm_schema(cfg, cfg.d_model)
    if kind == "dec":
        return {"norm": n(), "self_attn": layers.attn_schema(cfg),
                "norm_x": n(),
                "cross_attn": layers.attn_schema(cfg, cross=True),
                "norm2": n(), "mlp": layers.mlp_schema(cfg)}
    dff = cfg.d_ff_dense or cfg.d_ff
    is_prefix_dense = kind == "attn" and cfg.first_k_dense > 0
    s = {"norm": n(), "attn": layers.attn_schema(cfg), "norm2": n(),
         "mlp": layers.mlp_schema(cfg, dff if is_prefix_dense else cfg.d_ff)}
    if cfg.post_norms:
        s["post_attn_norm"] = n()
        s["post_mlp_norm"] = n()
    return s


def layer_cache_schema(cfg: ModelConfig, kind: str, batch: int,
                       seq_len: int) -> Dict[str, Any]:
    _check_kind(kind)
    if kind == "dec":
        return {"self_attn": layers.attn_cache_schema(cfg, batch, seq_len,
                                                      kind="attn"),
                "cross_attn": layers.cross_cache_schema(cfg, batch,
                                                        cfg.enc_seq)}
    if kind == "enc":
        raise ValueError("encoder layers keep no decode cache")
    return {"attn": layers.attn_cache_schema(cfg, batch, seq_len, kind=kind)}


def _residual(x, delta, p, cfg, post_key):
    if cfg.post_norms and post_key in p:
        delta = apply_norm(p[post_key], delta, cfg)
    return x + delta


def _mlp_block(cfg, p, x):
    h = apply_norm(p["norm2"], x, cfg)
    return _residual(x, layers.mlp_apply(p["mlp"], h, cfg), p, cfg,
                     "post_mlp_norm")


def layer_apply(cfg: ModelConfig, kind: str, p, x, ctx: LayerCtx):
    """Full-sequence layer. Returns (x, aux)."""
    _check_kind(kind)
    aux = 0.0
    if kind == "dec":
        h = apply_norm(p["norm"], x, cfg)
        x = x + layers.attn_apply(p["self_attn"], h, ctx, kind="attn")
        h = apply_norm(p["norm_x"], x, cfg)
        x = x + layers.cross_attn_apply(p["cross_attn"], h, ctx)
        return _mlp_block(cfg, p, x), aux
    h = apply_norm(p["norm"], x, cfg)
    x = _residual(x, layers.attn_apply(p["attn"], h, ctx, kind=kind), p, cfg,
                  "post_attn_norm")
    return _mlp_block(cfg, p, x), aux


def layer_prefill(cfg: ModelConfig, kind: str, p, x, ctx: LayerCtx,
                  cache_len: int):
    """Full-sequence layer that also emits the decode cache."""
    _check_kind(kind)
    if kind == "dec":
        h = apply_norm(p["norm"], x, cfg)
        a, self_cache = layers.attn_prefill(p["self_attn"], h, ctx,
                                            kind="attn", cache_len=cache_len)
        x = x + a
        cross_cache = layers.cross_build_cache(
            p["cross_attn"], ctx.memory.to(x.dtype), cfg)
        h = apply_norm(p["norm_x"], x, cfg)
        x = x + layers.cross_attn_apply(p["cross_attn"], h, ctx)
        return (_mlp_block(cfg, p, x),
                {"self_attn": self_cache, "cross_attn": cross_cache})
    if kind == "enc":
        raise ValueError("encoder layers run in _encode, not in a prefill "
                         "stack")
    h = apply_norm(p["norm"], x, cfg)
    a, cache = layers.attn_prefill(p["attn"], h, ctx, kind=kind,
                                   cache_len=cache_len)
    x = _residual(x, a, p, cfg, "post_attn_norm")
    return _mlp_block(cfg, p, x), {"attn": cache}


def layer_decode(cfg: ModelConfig, kind: str, p, x, cache, ctx: LayerCtx):
    """One-token step. x: (B,1,D). Returns (x, cache), the cache updated in
    place."""
    _check_kind(kind)
    if kind == "dec":
        h = apply_norm(p["norm"], x, cfg)
        a, sc = layers.attn_decode(p["self_attn"], h, cache["self_attn"], ctx,
                                   kind="attn")
        x = x + a
        h = apply_norm(p["norm_x"], x, cfg)
        a, cc = layers.cross_attn_decode(p["cross_attn"], h,
                                         cache["cross_attn"], ctx)
        return _mlp_block(cfg, p, x + a), {"self_attn": sc, "cross_attn": cc}
    if kind == "enc":
        raise ValueError("encoder layers do not decode")
    h = apply_norm(p["norm"], x, cfg)
    a, c = layers.attn_decode(p["attn"], h, cache["attn"], ctx, kind=kind)
    x = _residual(x, a, p, cfg, "post_attn_norm")
    return _mlp_block(cfg, p, x), {"attn": c}


# ---------------------------------------------------------------------------
# stack layout: prefix (unrolled) + blocks (looped) + suffix (unrolled)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackLayout:
    prefix: Tuple[str, ...]      # layer kinds, unrolled
    pattern: Tuple[str, ...]     # one block of the loop
    n_blocks: int
    suffix: Tuple[str, ...]      # remainder layers, unrolled


def stack_layout(cfg: ModelConfig) -> StackLayout:
    kinds = cfg.layer_kinds()
    pre = kinds[:cfg.first_k_dense]
    body = kinds[cfg.first_k_dense:]
    pattern = cfg.pattern * max(cfg.block_repeat, 1)
    period = len(pattern)
    if not cfg.scan_layers:
        return StackLayout(tuple(kinds), pattern, 0, ())
    n_blocks = len(body) // period
    if n_blocks <= 1:  # a single block is unrolled, as in the JAX package
        return StackLayout(tuple(kinds), pattern, 0, ())
    suffix = body[n_blocks * period:]
    return StackLayout(tuple(pre), pattern, n_blocks, tuple(suffix))


def stack_schema_for(cfg: ModelConfig) -> Dict[str, Any]:
    lay = stack_layout(cfg)
    s: Dict[str, Any] = {}
    for i, kind in enumerate(lay.prefix):
        s[f"prefix_{i}"] = layer_schema(cfg, kind)
    if lay.n_blocks:
        block = {f"p{j}": layer_schema(cfg, k)
                 for j, k in enumerate(lay.pattern)}
        s["blocks"] = stack_schema(block, lay.n_blocks)
    for i, kind in enumerate(lay.suffix):
        s[f"suffix_{i}"] = layer_schema(cfg, kind)
    return s


def stack_cache_schema_for(cfg: ModelConfig, batch: int,
                           seq_len: int) -> Dict[str, Any]:
    lay = stack_layout(cfg)
    s: Dict[str, Any] = {}
    for i, kind in enumerate(lay.prefix):
        s[f"prefix_{i}"] = layer_cache_schema(cfg, kind, batch, seq_len)
    if lay.n_blocks:
        block = {f"p{j}": layer_cache_schema(cfg, k, batch, seq_len)
                 for j, k in enumerate(lay.pattern)}
        s["blocks"] = stack_schema(block, lay.n_blocks)
    for i, kind in enumerate(lay.suffix):
        s[f"suffix_{i}"] = layer_cache_schema(cfg, kind, batch, seq_len)
    return s


def _at(tree, i: int):
    """Block ``i`` of a tree of stacked tensors (views, no copies)."""
    if torch.is_tensor(tree):
        return tree[i]
    return {k: _at(v, i) for k, v in tree.items()}


def _stacked(trees):
    """Stack a list of same-shaped trees along a new leading axis."""
    if torch.is_tensor(trees[0]):
        return torch.stack(trees)
    return {k: _stacked([t[k] for t in trees]) for k in trees[0]}


def _run_stack_apply(cfg: ModelConfig, params, x, ctx: LayerCtx):
    lay = stack_layout(cfg)
    aux = 0.0
    for i, kind in enumerate(lay.prefix):
        x, a = layer_apply(cfg, kind, params[f"prefix_{i}"], x, ctx)
        aux = aux + a
    for b in range(lay.n_blocks):
        bp = _at(params["blocks"], b)
        for j, kind in enumerate(lay.pattern):
            x, a = layer_apply(cfg, kind, bp[f"p{j}"], x, ctx)
            aux = aux + a
    for i, kind in enumerate(lay.suffix):
        x, a = layer_apply(cfg, kind, params[f"suffix_{i}"], x, ctx)
        aux = aux + a
    return x, aux


def _run_stack_prefill(cfg: ModelConfig, params, x, ctx: LayerCtx,
                       cache_len: int):
    lay = stack_layout(cfg)
    caches: Dict[str, Any] = {}
    for i, kind in enumerate(lay.prefix):
        x, caches[f"prefix_{i}"] = layer_prefill(
            cfg, kind, params[f"prefix_{i}"], x, ctx, cache_len)
    blocks = []
    for b in range(lay.n_blocks):
        bp = _at(params["blocks"], b)
        cs = {}
        for j, kind in enumerate(lay.pattern):
            x, cs[f"p{j}"] = layer_prefill(cfg, kind, bp[f"p{j}"], x, ctx,
                                           cache_len)
        blocks.append(cs)
    if blocks:
        caches["blocks"] = _stacked(blocks)
    for i, kind in enumerate(lay.suffix):
        x, caches[f"suffix_{i}"] = layer_prefill(
            cfg, kind, params[f"suffix_{i}"], x, ctx, cache_len)
    return x, caches


def _run_stack_decode(cfg: ModelConfig, params, x, caches, ctx: LayerCtx):
    """One token through the stack; every layer writes its cache slot in
    place, so the stacked caches come back updated."""
    lay = stack_layout(cfg)
    for i, kind in enumerate(lay.prefix):
        x, _ = layer_decode(cfg, kind, params[f"prefix_{i}"], x,
                            caches[f"prefix_{i}"], ctx)
    for b in range(lay.n_blocks):
        bp, bc = _at(params["blocks"], b), _at(caches["blocks"], b)
        for j, kind in enumerate(lay.pattern):
            x, _ = layer_decode(cfg, kind, bp[f"p{j}"], x, bc[f"p{j}"], ctx)
    for i, kind in enumerate(lay.suffix):
        x, _ = layer_decode(cfg, kind, params[f"suffix_{i}"], x,
                            caches[f"suffix_{i}"], ctx)
    return x, caches


# ---------------------------------------------------------------------------
# whole-model schema and parameters
# ---------------------------------------------------------------------------

def model_schema(cfg: ModelConfig, *, max_seq: int = 0) -> Dict[str, Any]:
    D = cfg.d_model
    V = cfg.vocab_padded
    s: Dict[str, Any] = {
        "embed": {"table": ParamDef((V, D), ("vocab", "embed"),
                                    init="normal", scale=1.0)},
        "final_norm": norm_schema(cfg, D),
        "stack": stack_schema_for(cfg),
    }
    if not cfg.tie_embeddings:
        s["unembed"] = {"table": ParamDef((V, D), ("vocab", "embed"),
                                          init="lecun")}
    if cfg.is_encoder_decoder:
        enc_block = {"p0": layer_schema(cfg, "enc")}
        s["encoder"] = {"blocks": stack_schema(enc_block, cfg.n_enc_layers),
                        "norm": norm_schema(cfg, D)}
        s["dec_pos"] = {"table": ParamDef(
            (max_seq or cfg.max_dec_pos or 448, D), (None, "embed"),
            init="normal", scale=0.02)}
    return s


def params_from_jax(tree: Mapping[str, Any], *,
                    device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Carry a JAX parameter tree across: the same nesting and stacked
    leading axes, every leaf (numpy or array-like, float32 or bfloat16) a
    tensor on ``device`` with its values and dtype unchanged."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return {k: params_from_jax(v, device=dev) if isinstance(v, Mapping)
            else leaf(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# encoder, embeddings, context
# ---------------------------------------------------------------------------

def _sincos_pos(S: int, D: int, dtype, device) -> torch.Tensor:
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _make_ctx(cfg: ModelConfig, positions: torch.Tensor, memory=None,
              pos: Optional[int] = None, use_flash: bool = False) -> LayerCtx:
    hd = cfg.hd
    rope_l = rope_tables(positions, hd, cfg.rope_theta)
    rope_g = (rope_tables(positions, hd, cfg.rope_theta_global)
              if cfg.rope_theta_global else rope_l)
    return LayerCtx(cfg=cfg, rope_local=rope_l, rope_global=rope_g,
                    memory=memory, pos=pos, use_flash=use_flash)


def _encode(cfg: ModelConfig, params, frames: torch.Tensor,
            use_flash: bool = False) -> torch.Tensor:
    """Whisper encoder over stubbed frame embeddings (B, enc_seq, D)."""
    x = frames.to(_cdt(cfg))
    x = x + _sincos_pos(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    ctx = _make_ctx(cfg, torch.arange(x.shape[1], device=x.device),
                    use_flash=use_flash)
    blocks = params["encoder"]["blocks"]
    for b in range(cfg.n_enc_layers):
        x, _ = layer_apply(cfg, "enc", _at(blocks, b)["p0"], x, ctx)
    return apply_norm(params["encoder"]["norm"], x, cfg)


def _embed_tokens(cfg, params, tokens, mesh=None):
    x = embed_lookup(params["embed"]["table"], tokens, mesh=mesh,
                     compute_dtype=_cdt(cfg))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _memory_from_batch(cfg, params, batch, use_flash=False):
    if cfg.is_encoder_decoder:
        return _encode(cfg, params, batch["frames"], use_flash)
    if cfg.vision_seq:
        raise NotImplementedError(
            "vision memory (cross layers) is not ported yet (ROADMAP Queue 1 "
            "row 10)")
    return None


def _unembed_table(cfg, params):
    return (params["unembed"]["table"] if not cfg.tie_embeddings
            else params["embed"]["table"])


def _on(x, device: torch.device) -> torch.Tensor:
    return (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
            ).to(device)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def prefill(params, batch: Mapping[str, Any], cfg: ModelConfig, *,
            cache_len: int, mesh=None, use_flash: bool = False):
    """Full-sequence forward building the decode cache. ``batch``: tokens
    (B, S) and, for an encoder-decoder, frames (B, enc_seq, D), as tensors
    or arrays (moved to the parameters' device).

    Returns (last_token_logits (B,V) f32, caches).
    """
    _no_mesh(mesh)
    dev = params["embed"]["table"].device
    tokens = _on(batch["tokens"], dev)
    B, S = tokens.shape
    x = _embed_tokens(cfg, params, tokens)
    if cfg.is_encoder_decoder:
        x = x + params["dec_pos"]["table"][:S].to(x.dtype)[None]
    memory = _memory_from_batch(
        cfg, params, {k: _on(v, dev) for k, v in batch.items()
                      if k != "tokens"}, use_flash)
    ctx = _make_ctx(cfg, torch.arange(S, device=dev), memory=memory,
                    use_flash=use_flash)
    x, caches = _run_stack_prefill(cfg, params["stack"], x, ctx, cache_len)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = logits_matmul(x[:, -1], _unembed_table(cfg, params),
                           softcap=cfg.final_logit_softcap,
                           valid_vocab=cfg.vocab)
    return logits, caches


def decode_step(params, token, caches, pos: int, cfg: ModelConfig, *,
                mesh=None):
    """token: (B,1) integer; pos: the position being decoded (uniform
    static-batch decode). The caches are updated in place.

    Returns (logits (B,V) f32, caches).
    """
    _no_mesh(mesh)
    dev = params["embed"]["table"].device
    pos = int(pos)
    x = _embed_tokens(cfg, params, _on(token, dev))
    if cfg.is_encoder_decoder:
        x = x + params["dec_pos"]["table"][pos].to(x.dtype)[None, None, :]
    ctx = _make_ctx(cfg, torch.tensor([pos], device=dev), pos=pos)
    x, caches = _run_stack_decode(cfg, params["stack"], x, caches, ctx)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = logits_matmul(x[:, -1], _unembed_table(cfg, params),
                           softcap=cfg.final_logit_softcap,
                           valid_vocab=cfg.vocab)
    return logits, caches
