"""Model assembly: block-pattern stacks for every layer kind.

The per-layer heterogeneity (local/global attention, cross-attention,
MoE-vs-dense, recurrent-vs-attention, encoder-decoder) is a repeating
block pattern; parameters are stacked per pattern position over block
repetitions, as in the JAX package, and the stack runs as a Python loop
over the leading block axis where the JAX package runs ``lax.scan``.
Remainder layers and MoE first-k-dense prefixes are unrolled around it.
Each stacked leaf is split into its blocks once per call
(``torch.unbind``), so under autograd the backward stacks each leaf's
gradient once instead of zero-filling a whole stacked leaf per block.

Three entry points, as in the JAX package: ``loss_fn`` (train; with
``cfg.remat == "block"`` each block of the loop is checkpointed, as
``jax.checkpoint`` wraps the scan body; with ``cfg.remat == "layer"`` each
layer, the unrolled ones too; one ``lm.loss`` span), ``prefill``
(last-token logits + populated cache) and ``decode_step`` (one token
against the cache). A model with latent attention (``cfg.kv_lora_rank``,
``models/mla.py``) takes it in every self-attention layer in place of
multi-head attention, and trains only: its prefill and decode raise, as
they do for a model with Kimi Delta Attention layers (``kda``,
``kda_dense``; ``models/kda.py``). A config that gives its layers outright
(``cfg.layers``, a hybrid stack) loops the longest periodic run of them
after the dense prefix and unrolls the rest (``stack_layout``).

Each takes ``mesh=`` (a ``launch.mesh.Mesh``): then the parameters are
this rank's blocks (``common.schema.shard_params``), the batch is this
rank's rows over the batch axes, the layers run tensor- and
expert-parallel over ``model`` (``models/layers.py``, ``models/moe.py``),
the embedding is the CGTrans lookup on the vocab shard and the loss the
vocab-parallel cross-entropy (``models/embedding.py``). ``loss_fn`` sums
the loss and the label count over the batch axes before it divides, so
its gradients are the rank's part of the unsharded gradient.

``rules=`` is the shape's logical rule table (default ``DEFAULT_RULES``):
the batch axes are where the logical ``"batch"`` axis resolves under it,
so a long-context table's ``batch=()`` leaves every rank the whole batch
and sums nothing over ``pod`` or ``data``. ``cache_layout=`` is the decode
caches' layout on a mesh (``models/layers.py``): ``"seq"`` (default), the
JAX cache schema's, each rank's rows of a ``T/tp`` sequence slice of every
kv head with a flash-decode combine over ``model``; ``"heads"``, every
sequence slot of the kv heads the rank's attention reads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.logical import batch_axes, dp_size
from repro_torch.common.schema import ParamDef, stack as stack_schema
from repro_torch.core import collectives
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import griffin, kda, layers, mla, moe, ssm
from repro_torch.launch.mesh import check_named_mesh
from repro_torch.models.embedding import (chunked_softmax_xent, embed_lookup,
                                          vocab_logits)
from repro_torch.models.layers import (LayerCtx, apply_norm, compute_dtype,
                                       norm_schema, ready_leaf, rope_tables)
from repro_torch.runtime import trace


def _cdt(cfg: ModelConfig) -> torch.dtype:
    return compute_dtype(cfg)


# ---------------------------------------------------------------------------
# per-layer schema / apply / prefill / decode, dispatched on kind
# ---------------------------------------------------------------------------

def _self_attn_schema(cfg: ModelConfig) -> Dict[str, Any]:
    return mla.mla_schema(cfg) if cfg.kv_lora_rank else layers.attn_schema(cfg)


def _self_attn(cfg: ModelConfig, p, h, ctx: LayerCtx, kind: str):
    if cfg.kv_lora_rank:
        return mla.mla_apply(p, h, ctx)
    return layers.attn_apply(p, h, ctx, kind=kind)


def layer_schema(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    n = lambda: norm_schema(cfg, cfg.d_model)
    if kind == "ssd":
        return {"norm": n(), "mixer": ssm.ssd_schema(cfg)}
    if kind == "rglru":
        return {"norm": n(), "mixer": griffin.rglru_schema(cfg),
                "norm2": n(), "mlp": layers.mlp_schema(cfg)}
    if kind in ("attn", "local", "enc"):
        dff = cfg.d_ff_dense or cfg.d_ff
        is_prefix_dense = kind == "attn" and cfg.first_k_dense > 0
        s = {"norm": n(), "attn": _self_attn_schema(cfg), "norm2": n(),
             "mlp": layers.mlp_schema(cfg, dff if is_prefix_dense
                                      else cfg.d_ff)}
        if cfg.post_norms:
            s["post_attn_norm"] = n()
            s["post_mlp_norm"] = n()
        return s
    if kind == "moe":
        return {"norm": n(), "attn": _self_attn_schema(cfg),
                "norm2": n(), "moe": moe.moe_schema(cfg)}
    if kind == "kda":
        return {"norm": n(), "mixer": kda.kda_schema(cfg),
                "norm2": n(), "moe": moe.moe_schema(cfg)}
    if kind == "kda_dense":
        return {"norm": n(), "mixer": kda.kda_schema(cfg), "norm2": n(),
                "mlp": layers.mlp_schema(cfg, cfg.d_ff_dense or cfg.d_ff)}
    if kind == "cross":
        return {"norm": n(),
                "attn": layers.attn_schema(cfg, cross=True, gated=True),
                "norm2": n(),
                "mlp": layers.mlp_schema(cfg, gated_tag=True)}
    if kind == "dec":
        return {"norm": n(), "self_attn": layers.attn_schema(cfg),
                "norm_x": n(),
                "cross_attn": layers.attn_schema(cfg, cross=True),
                "norm2": n(), "mlp": layers.mlp_schema(cfg)}
    raise ValueError(kind)


def layer_cache_schema(cfg: ModelConfig, kind: str, batch: int,
                       seq_len: int, tp: int = 1,
                       layout: str = "seq") -> Dict[str, Any]:
    """One layer's decode cache in ``layout`` (``layers.attn_cache_schema``:
    ``"seq"``, the JAX package's schema; ``"heads"``, its kv heads laid
    out for a ``model`` axis of ``tp`` ranks, ``layers.cache_heads``). The
    layout concerns attention caches only: a recurrent layer's state takes
    the JAX schema's specs in both, its heads or channels split over
    ``model``."""
    kw = dict(tp=tp, layout=layout)
    if kind == "ssd":
        return {"mixer": ssm.ssd_cache_schema(cfg, batch)}
    if kind == "rglru":
        return {"mixer": griffin.rglru_cache_schema(cfg, batch)}
    if kind in ("attn", "local", "moe"):
        return {"attn": layers.attn_cache_schema(cfg, batch, seq_len,
                                                 kind=kind, **kw)}
    if kind == "cross":
        return {"attn": layers.cross_cache_schema(cfg, batch,
                                                  cfg.vision_seq, **kw)}
    if kind == "dec":
        return {"self_attn": layers.attn_cache_schema(cfg, batch, seq_len,
                                                      kind="attn", **kw),
                "cross_attn": layers.cross_cache_schema(cfg, batch,
                                                        cfg.enc_seq, **kw)}
    if kind == "enc":
        raise ValueError("encoder layers keep no decode cache")
    if kind in ("kda", "kda_dense"):
        raise ValueError("KDA layers keep no decode cache in the port")
    raise ValueError(kind)


def _residual(x, delta, p, cfg, post_key):
    if cfg.post_norms and post_key in p:
        delta = apply_norm(p[post_key], delta, cfg)
    return x + delta


def _mlp_block(cfg, p, x, mesh):
    h = apply_norm(p["norm2"], x, cfg)
    return _residual(x, layers.mlp_apply(p["mlp"], h, cfg, mesh), p, cfg,
                     "post_mlp_norm")


def _write(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]):
    """Copy a recurrent layer's new state into its cache tensors (the
    port's decode updates caches in place)."""
    for k, v in new.items():
        cache[k].copy_(v)
    return cache


def layer_apply(cfg: ModelConfig, kind: str, p, x, ctx: LayerCtx):
    """Full-sequence layer. Returns (x, aux): aux is 0.0, or an MoE
    layer's f32 load-balance loss."""
    m = ctx.mesh
    aux = 0.0
    if kind == "ssd":
        h = apply_norm(p["norm"], x, cfg)
        return x + ssm.ssd_apply(p["mixer"], h, cfg, mesh=m), aux
    if kind == "rglru":
        h = apply_norm(p["norm"], x, cfg)
        x = x + griffin.rglru_apply(p["mixer"], h, cfg, mesh=m)
        h = apply_norm(p["norm2"], x, cfg)
        return x + layers.mlp_apply(p["mlp"], h, cfg, m), aux
    if kind in ("attn", "local", "enc"):
        h = apply_norm(p["norm"], x, cfg)
        x = _residual(x, _self_attn(cfg, p["attn"], h, ctx, kind),
                      p, cfg, "post_attn_norm")
        return _mlp_block(cfg, p, x, m), aux
    if kind == "moe":
        h = apply_norm(p["norm"], x, cfg)
        x = x + _self_attn(cfg, p["attn"], h, ctx, "attn")
        h = apply_norm(p["norm2"], x, cfg)
        out, aux = moe.moe_apply(p["moe"], h, cfg, mesh=m, rules=ctx.rules)
        return x + out, aux
    if kind in ("kda", "kda_dense"):
        h = apply_norm(p["norm"], x, cfg)
        x = x + kda.kda_apply(p["mixer"], h, cfg, mesh=m)
        h = apply_norm(p["norm2"], x, cfg)
        if kind == "kda_dense":
            return x + layers.mlp_apply(p["mlp"], h, cfg, m), aux
        out, aux = moe.moe_apply(p["moe"], h, cfg, mesh=m, rules=ctx.rules)
        return x + out, aux
    if kind == "cross":
        h = apply_norm(p["norm"], x, cfg)
        x = x + layers.cross_attn_apply(p["attn"], h, ctx)
        h = apply_norm(p["norm2"], x, cfg)
        return x + layers.mlp_apply(p["mlp"], h, cfg, m), aux
    if kind == "dec":
        h = apply_norm(p["norm"], x, cfg)
        x = x + layers.attn_apply(p["self_attn"], h, ctx, kind="attn")
        h = apply_norm(p["norm_x"], x, cfg)
        x = x + layers.cross_attn_apply(p["cross_attn"], h, ctx)
        return _mlp_block(cfg, p, x, m), aux
    raise ValueError(kind)


def layer_prefill(cfg: ModelConfig, kind: str, p, x, ctx: LayerCtx,
                  cache_len: int):
    """Full-sequence layer that also emits the decode cache."""
    m = ctx.mesh
    if kind == "ssd":
        h = apply_norm(p["norm"], x, cfg)
        out, cache = ssm.ssd_apply(p["mixer"], h, cfg, return_cache=True,
                                       mesh=m)
        return x + out, {"mixer": cache}
    if kind == "rglru":
        h = apply_norm(p["norm"], x, cfg)
        out, cache = griffin.rglru_apply(p["mixer"], h, cfg,
                                         return_cache=True, mesh=m)
        x = x + out
        h = apply_norm(p["norm2"], x, cfg)
        return x + layers.mlp_apply(p["mlp"], h, cfg, m), {"mixer": cache}
    if kind in ("attn", "local"):
        h = apply_norm(p["norm"], x, cfg)
        a, cache = layers.attn_prefill(p["attn"], h, ctx, kind=kind,
                                       cache_len=cache_len)
        x = _residual(x, a, p, cfg, "post_attn_norm")
        return _mlp_block(cfg, p, x, m), {"attn": cache}
    if kind == "moe":
        h = apply_norm(p["norm"], x, cfg)
        a, cache = layers.attn_prefill(p["attn"], h, ctx, kind="attn",
                                       cache_len=cache_len)
        x = x + a
        h = apply_norm(p["norm2"], x, cfg)
        out, _ = moe.moe_apply(p["moe"], h, cfg, capacity_factor=2.0,
                               mesh=m, rules=ctx.rules)
        return x + out, {"attn": cache}
    if kind == "cross":
        cache = layers.cross_build_cache(p["attn"], ctx.memory.to(x.dtype),
                                         cfg, m, ctx.cache_layout)
        h = apply_norm(p["norm"], x, cfg)
        x = x + layers.cross_attn_apply(p["attn"], h, ctx, cache)
        h = apply_norm(p["norm2"], x, cfg)
        return x + layers.mlp_apply(p["mlp"], h, cfg, m), {"attn": cache}
    if kind == "dec":
        h = apply_norm(p["norm"], x, cfg)
        a, self_cache = layers.attn_prefill(p["self_attn"], h, ctx,
                                            kind="attn", cache_len=cache_len)
        x = x + a
        cross_cache = layers.cross_build_cache(
            p["cross_attn"], ctx.memory.to(x.dtype), cfg, m,
            ctx.cache_layout)
        h = apply_norm(p["norm_x"], x, cfg)
        x = x + layers.cross_attn_apply(p["cross_attn"], h, ctx, cross_cache)
        return (_mlp_block(cfg, p, x, m),
                {"self_attn": self_cache, "cross_attn": cross_cache})
    if kind == "enc":
        raise ValueError("encoder layers run in _encode, not in a prefill "
                         "stack")
    raise ValueError(kind)


def layer_decode(cfg: ModelConfig, kind: str, p, x, cache, ctx: LayerCtx):
    """One-token step. x: (B,1,D). Returns (x, cache), the cache updated in
    place."""
    m = ctx.mesh
    if kind == "ssd":
        h = apply_norm(p["norm"], x, cfg)
        out, c = ssm.ssd_decode(p["mixer"], h, cache["mixer"], cfg, m)
        return x + out, {"mixer": _write(cache["mixer"], c)}
    if kind == "rglru":
        h = apply_norm(p["norm"], x, cfg)
        out, c = griffin.rglru_decode(p["mixer"], h, cache["mixer"], cfg,
                                        m)
        x = x + out
        h = apply_norm(p["norm2"], x, cfg)
        return (x + layers.mlp_apply(p["mlp"], h, cfg, m),
                {"mixer": _write(cache["mixer"], c)})
    if kind in ("attn", "local"):
        h = apply_norm(p["norm"], x, cfg)
        a, c = layers.attn_decode(p["attn"], h, cache["attn"], ctx,
                                  kind=kind)
        x = _residual(x, a, p, cfg, "post_attn_norm")
        return _mlp_block(cfg, p, x, m), {"attn": c}
    if kind == "moe":
        h = apply_norm(p["norm"], x, cfg)
        a, c = layers.attn_decode(p["attn"], h, cache["attn"], ctx,
                                  kind="attn")
        x = x + a
        h = apply_norm(p["norm2"], x, cfg)
        out, _ = moe.moe_apply(p["moe"], h, cfg, capacity_factor=2.0,
                               group_size=64, mesh=m, rules=ctx.rules)
        return x + out, {"attn": c}
    if kind == "cross":
        h = apply_norm(p["norm"], x, cfg)
        a, c = layers.cross_attn_decode(p["attn"], h, cache["attn"], ctx)
        x = x + a
        h = apply_norm(p["norm2"], x, cfg)
        return x + layers.mlp_apply(p["mlp"], h, cfg, m), {"attn": c}
    if kind == "dec":
        h = apply_norm(p["norm"], x, cfg)
        a, sc = layers.attn_decode(p["self_attn"], h, cache["self_attn"], ctx,
                                   kind="attn")
        x = x + a
        h = apply_norm(p["norm_x"], x, cfg)
        a, cc = layers.cross_attn_decode(p["cross_attn"], h,
                                         cache["cross_attn"], ctx)
        return _mlp_block(cfg, p, x + a, m), {"self_attn": sc, "cross_attn": cc}
    if kind == "enc":
        raise ValueError("encoder layers do not decode")
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# stack layout: prefix (unrolled) + blocks (looped) + suffix (unrolled)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackLayout:
    prefix: Tuple[str, ...]      # layer kinds, unrolled
    pattern: Tuple[str, ...]     # one block of the loop
    n_blocks: int
    suffix: Tuple[str, ...]      # remainder layers, unrolled


def _period(body: Tuple[str, ...]) -> Tuple[str, ...]:
    """The shortest run that, repeated from the start of ``body``, covers
    the most of it at least twice (the whole of ``body`` where none
    repeats)."""
    best, cover = tuple(body), 0
    for p in range(1, len(body) // 2 + 1):
        n = 1
        while body[n * p:(n + 1) * p] == body[:p]:
            n += 1
        if n >= 2 and n * p > cover:
            best, cover = tuple(body[:p]), n * p
    return best


def stack_layout(cfg: ModelConfig) -> StackLayout:
    kinds = cfg.layer_kinds()
    pre = kinds[:cfg.first_k_dense]
    body = kinds[cfg.first_k_dense:]
    base = _period(body) if cfg.layers else cfg.pattern
    pattern = base * max(cfg.block_repeat, 1)
    period = len(pattern)
    if not cfg.scan_layers:
        return StackLayout(tuple(kinds), pattern, 0, ())
    n_blocks = len(body) // period
    while n_blocks and body[:n_blocks * period] != pattern * n_blocks:
        n_blocks -= 1
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


def stack_cache_schema_for(cfg: ModelConfig, batch: int, seq_len: int,
                           tp: int = 1, layout: str = "seq"
                           ) -> Dict[str, Any]:
    """The stack's decode caches, nested as ``prefill`` returns them, in
    ``layout`` (``"heads"``: laid out for a ``model`` axis of ``tp``
    ranks; the two layouts' global shapes are the same)."""
    lay = stack_layout(cfg)

    def one(kind):
        return layer_cache_schema(cfg, kind, batch, seq_len, tp, layout)

    s: Dict[str, Any] = {}
    for i, kind in enumerate(lay.prefix):
        s[f"prefix_{i}"] = one(kind)
    if lay.n_blocks:
        s["blocks"] = stack_schema({f"p{j}": one(k)
                                    for j, k in enumerate(lay.pattern)},
                                   lay.n_blocks)
    for i, kind in enumerate(lay.suffix):
        s[f"suffix_{i}"] = one(kind)
    return s


def _blocks(tree, n: int) -> List[Any]:
    """The ``n`` blocks of a tree of stacked tensors, each leaf split once
    with ``torch.unbind`` (views, no copies; under autograd one
    ``UnbindBackward`` per leaf stacks its blocks' gradients once)."""
    if torch.is_tensor(tree):
        return list(torch.unbind(tree, 0))
    parts = {k: _blocks(v, n) for k, v in tree.items()}
    return [{k: v[b] for k, v in parts.items()} for b in range(n)]


def _stacked(trees):
    """Stack a list of same-shaped trees along a new leading axis."""
    if torch.is_tensor(trees[0]):
        return torch.stack(trees)
    return {k: _stacked([t[k] for t in trees]) for k in trees[0]}


def _run_stack_apply(cfg: ModelConfig, params, x, ctx: LayerCtx):
    """Returns (x, aux): aux the f32 sum of the MoE layers' load-balance
    losses, in layer order."""
    lay = stack_layout(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    grad = torch.is_grad_enabled()

    def one(kind, p, x, aux):
        x, a = layer_apply(cfg, kind, p, x, ctx)
        return x, aux + a

    def layer(kind, p, x, aux):
        if cfg.remat == "layer" and grad:
            return checkpoint(one, kind, p, x, aux, use_reentrant=False)
        return one(kind, p, x, aux)

    for i, kind in enumerate(lay.prefix):
        x, aux = layer(kind, params[f"prefix_{i}"], x, aux)

    def block_fn(x, aux, bp):
        for j, kind in enumerate(lay.pattern):
            x, aux = layer(kind, bp[f"p{j}"], x, aux)
        return x, aux

    remat = cfg.remat == "block" and grad
    if lay.n_blocks:
        for bp in _blocks(params["blocks"], lay.n_blocks):
            if remat:
                x, aux = checkpoint(block_fn, x, aux, bp,
                                    use_reentrant=False)
            else:
                x, aux = block_fn(x, aux, bp)
    for i, kind in enumerate(lay.suffix):
        x, aux = layer(kind, params[f"suffix_{i}"], x, aux)
    return x, aux


def _run_stack_prefill(cfg: ModelConfig, params, x, ctx: LayerCtx,
                       cache_len: int):
    lay = stack_layout(cfg)
    caches: Dict[str, Any] = {}
    for i, kind in enumerate(lay.prefix):
        x, caches[f"prefix_{i}"] = layer_prefill(
            cfg, kind, params[f"prefix_{i}"], x, ctx, cache_len)
    blocks = []
    if lay.n_blocks:
        for bp in _blocks(params["blocks"], lay.n_blocks):
            cs = {}
            for j, kind in enumerate(lay.pattern):
                x, cs[f"p{j}"] = layer_prefill(cfg, kind, bp[f"p{j}"], x,
                                               ctx, cache_len)
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
    if lay.n_blocks:
        for bp, bc in zip(_blocks(params["blocks"], lay.n_blocks),
                          _blocks(caches["blocks"], lay.n_blocks)):
            for j, kind in enumerate(lay.pattern):
                x, _ = layer_decode(cfg, kind, bp[f"p{j}"], x, bc[f"p{j}"],
                                    ctx)
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
              pos: Optional[int] = None, use_flash: bool = False,
              mesh=None, rules=None, cache_layout: str = "seq") -> LayerCtx:
    hd = cfg.rope_dim
    rope_l = rope_tables(positions, hd, cfg.rope_theta)
    rope_g = (rope_tables(positions, hd, cfg.rope_theta_global)
              if cfg.rope_theta_global else rope_l)
    return LayerCtx(cfg=cfg, rope_local=rope_l, rope_global=rope_g,
                    memory=memory, pos=pos, use_flash=use_flash, mesh=mesh,
                    rules=rules,
                    cache_layout=layers.check_cache_layout(cache_layout))


def _encode(cfg: ModelConfig, params, frames: torch.Tensor,
            use_flash: bool = False, mesh=None) -> torch.Tensor:
    """Whisper encoder over stubbed frame embeddings (B, enc_seq, D)."""
    x = frames.to(_cdt(cfg))
    x = x + _sincos_pos(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    ctx = _make_ctx(cfg, torch.arange(x.shape[1], device=x.device),
                    use_flash=use_flash, mesh=mesh)
    for bp in _blocks(params["encoder"]["blocks"], cfg.n_enc_layers):
        x, _ = layer_apply(cfg, "enc", bp["p0"], x, ctx)
    return apply_norm(params["encoder"]["norm"], x, cfg)


def _tables(cfg, params, mesh):
    """(embedding table, output table) as the compute reads them: on a
    mesh each the rank's vocab shard, gathered over ``data`` (ZeRO-3)
    once for both of its uses."""
    spec = ("vocab", "embed")
    emb = ready_leaf(params["embed"]["table"], spec, mesh, keep=("vocab",))
    if cfg.tie_embeddings:
        return emb, emb
    return emb, ready_leaf(params["unembed"]["table"], spec, mesh,
                           keep=("vocab",))


def _embed_tokens(cfg, table, tokens, mesh=None, impl="ref"):
    # on a mesh the table's data gather sums its gradient over data
    x = embed_lookup(table, tokens, mesh=mesh, cgtrans=cfg.cgtrans_embedding,
                     compute_dtype=_cdt(cfg), impl=impl, grad_psum=False)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _dec_pos(params, mesh) -> torch.Tensor:
    return ready_leaf(params["dec_pos"]["table"], (None, "embed"), mesh)


def _memory_from_batch(cfg, params, batch, use_flash=False, mesh=None):
    if cfg.is_encoder_decoder:
        return _encode(cfg, params, batch["frames"], use_flash, mesh)
    if cfg.vision_seq:
        return batch["vision"]
    return None


def _on(x, device: torch.device) -> torch.Tensor:
    return (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
            ).to(device)


def _valid_mesh(mesh):
    if mesh is not None:
        check_named_mesh(mesh)
    return mesh


def _no_decode_cache(cfg: ModelConfig):
    """Refuse a model whose decode state the port does not build: the
    latent (MLA) KV cache, the KDA state cache, naming each missing."""
    kinds = set(cfg.layer_kinds())
    missing = [what for what, needed in (
        ("the latent attention (MLA) KV cache", cfg.kv_lora_rank),
        ("the Kimi Delta Attention (KDA) state cache",
         kinds & {"kda", "kda_dense"})) if needed]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port has no {' and no '.join(missing)} yet, "
            "so it has no prefill or decode; train it with loss_fn")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def loss_fn(params, batch: Mapping[str, Any], cfg: ModelConfig, *,
            mesh=None, use_flash: bool = False, impl: str = "ref",
            rules=None):
    """batch: tokens (B,S), labels (B,S) (-1 = padding); + frames / vision
    for audio / vlm, as tensors or arrays (moved to the parameters'
    device). On a mesh: this rank's parameter blocks and batch rows, and
    ``impl`` the backend of the CGTrans lookup's owner-side gradient
    (``embedding.embed_lookup``).

    Returns (total loss, {"loss", "aux_loss", "tokens"}): the mean
    cross-entropy over the labelled tokens (of every rank) plus
    ``router_aux_coef`` times the MoE layers' load-balance loss, all f32
    scalars.
    """
    mesh = _valid_mesh(mesh)
    dev = params["embed"]["table"].device
    with trace.span("lm.loss", params["embed"]["table"]):
        return _loss(params, batch, cfg, mesh, use_flash, impl, rules, dev)


def _loss(params, batch, cfg: ModelConfig, mesh, use_flash: bool, impl: str,
          rules, dev):
    tokens = _on(batch["tokens"], dev)
    B, S = tokens.shape
    emb, out_table = _tables(cfg, params, mesh)
    x = _embed_tokens(cfg, emb, tokens, mesh, impl)
    if cfg.is_encoder_decoder:
        x = x + _dec_pos(params, mesh)[:S].to(x.dtype)[None]
    memory = _memory_from_batch(
        cfg, params, {k: _on(v, dev) for k, v in batch.items()
                      if k not in ("tokens", "labels")}, use_flash, mesh)
    ctx = _make_ctx(cfg, torch.arange(S, device=dev), memory=memory,
                    use_flash=use_flash, mesh=mesh, rules=rules)
    x, aux = _run_stack_apply(cfg, params["stack"], x, ctx)
    x = apply_norm(params["final_norm"], x, cfg)
    loss_sum, cnt = chunked_softmax_xent(
        x, out_table, _on(batch["labels"], dev),
        softcap=cfg.final_logit_softcap, valid_vocab=cfg.vocab, mesh=mesh)
    if mesh is not None and dp_size(mesh, rules) > 1:
        both = collectives.psum(torch.stack([loss_sum, cnt]), mesh,
                                axis=batch_axes(mesh, rules))
        loss_sum, cnt = both[0], both[1]
    loss = loss_sum / torch.clamp(cnt, min=1.0)
    total = loss + cfg.router_aux_coef * aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": cnt}


def prefill(params, batch: Mapping[str, Any], cfg: ModelConfig, *,
            cache_len: int, mesh=None, use_flash: bool = False,
            rules=None, cache_layout: str = "seq"):
    """Full-sequence forward building the decode cache. ``batch``: tokens
    (B, S) and, for an encoder-decoder, frames (B, enc_seq, D), as tensors
    or arrays (moved to the parameters' device). ``use_flash`` runs every
    full-sequence self-attention, the encoder's and the prefill's, through
    the flash kernel (on a mesh on the rank's heads).

    Returns (last_token_logits (B,V) f32, caches); on a mesh the rank's
    rows of both (its rows under ``rules``, every vocab column of the
    logits), the caches in ``cache_layout``.
    """
    _no_decode_cache(cfg)
    mesh = _valid_mesh(mesh)
    dev = params["embed"]["table"].device
    tokens = _on(batch["tokens"], dev)
    B, S = tokens.shape
    emb, out_table = _tables(cfg, params, mesh)
    x = _embed_tokens(cfg, emb, tokens, mesh)
    if cfg.is_encoder_decoder:
        x = x + _dec_pos(params, mesh)[:S].to(x.dtype)[None]
    memory = _memory_from_batch(
        cfg, params, {k: _on(v, dev) for k, v in batch.items()
                      if k != "tokens"}, use_flash, mesh)
    ctx = _make_ctx(cfg, torch.arange(S, device=dev), memory=memory,
                    use_flash=use_flash, mesh=mesh, rules=rules,
                    cache_layout=cache_layout)
    x, caches = _run_stack_prefill(cfg, params["stack"], x, ctx, cache_len)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = vocab_logits(x[:, -1], out_table, mesh=mesh,
                          softcap=cfg.final_logit_softcap,
                          valid_vocab=cfg.vocab)
    return logits, caches


def decode_step(params, token, caches, pos: int, cfg: ModelConfig, *,
                mesh=None, rules=None, cache_layout: str = "seq"):
    """token: (B,1) integer; pos: the position being decoded (uniform
    static-batch decode). The caches are updated in place. On a mesh:
    this rank's rows of the token (under ``rules``) and of the caches, in
    the ``cache_layout`` the prefill built them in.

    Returns (logits (B,V) f32, caches).
    """
    _no_decode_cache(cfg)
    mesh = _valid_mesh(mesh)
    dev = params["embed"]["table"].device
    pos = int(pos)
    emb, out_table = _tables(cfg, params, mesh)
    x = _embed_tokens(cfg, emb, _on(token, dev), mesh)
    if cfg.is_encoder_decoder:
        x = x + _dec_pos(params, mesh)[pos].to(x.dtype)[None, None, :]
    ctx = _make_ctx(cfg, torch.tensor([pos], device=dev), pos=pos,
                    mesh=mesh, rules=rules, cache_layout=cache_layout)
    x, caches = _run_stack_decode(cfg, params["stack"], x, caches, ctx)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = vocab_logits(x[:, -1], out_table, mesh=mesh,
                          softcap=cfg.final_logit_softcap,
                          valid_vocab=cfg.vocab)
    return logits, caches
