"""Vocab embedding lookup, the output logits and the chunked
cross-entropy, on one device or over the ``model`` axis of a mesh.

On a mesh the table is sharded over ``model`` on the vocab dim — the
storage tier — and every function takes this rank's view, as a
``shard_map`` body of the JAX package does: the vocab shard ``(V/tp, D)``
of the table and the rank's rows of the batch. Two lookup dataflows:

* **cgtrans**: every rank resolves only the ids it owns (a range mask,
  the CAM-match analogue), takes them from its shard, and the only
  cross-rank traffic is one ``psum`` over ``model`` of the (B, S, D)
  result — aggregated before transmitted. The gradient is the mirror: the
  output cotangent is scatter-added into the owned rows at the owner and
  summed over the batch axes, and no table row moves. ``impl="kernel"``
  scatters through the FAST-GAS kernel (``core.gas.gas_scatter_weighted``,
  the dense grid); ``impl="ref"`` through ``index_add_``.
  ``request_chunk`` streams the flattened tokens through the same resolve
  ``request_chunk`` at a time (the SSD command-queue analogue).
* **baseline** (``cgtrans=False``): a plain take on the whole table. The
  JAX program takes on the sharded table and GSPMD moves the table when
  it compiles; the port moves it itself, with one counted ``all_gather``
  under the name ``table_gather`` (``analysis/budgets.py``).

``chunked_softmax_xent`` on a mesh computes vocab-parallel logits against
the rank's shard; the row max, the sum of exponentials and the gold logit
(taken on the owner) are reduced over ``model``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.logical import batch_axes, dp_size
from repro_torch.core import collectives, gas
from repro_torch.core.cgtrans import scan_request_chunks
from repro_torch.launch.mesh import check_named_mesh


def model_axis(mesh) -> Optional[str]:
    """``"model"`` where the mesh splits it over more than one rank."""
    if (mesh is not None and "model" in mesh.axis_names
            and mesh.shape["model"] > 1):
        return "model"
    return None


def _owned(ids: torch.Tensor, lo: int, shard: int):
    """(row in the shard, owned?) of every id."""
    rel = ids.long() - lo
    ok = (rel >= 0) & (rel < shard)
    return torch.clamp(rel, 0, shard - 1), ok


class _OwnerLookup(torch.autograd.Function):
    """The cgtrans lookup: forward, the owned rows taken in the compute
    dtype and summed over ``model`` (in ``request_chunk`` token chunks);
    backward, the f32 cotangent scatter-added into the owned rows (the
    kernel or ``index_add_``), then summed over the batch axes."""

    @staticmethod
    def forward(ctx, table, rel, ok, mesh, axis, dtype, impl, chunk,
                grad_axes):

        def resolve(r, m):
            part = table[r].to(dtype) * m[..., None].to(dtype)
            return collectives.psum(part, mesh, axis=axis)

        if chunk is None:
            out = resolve(rel, ok)
        else:
            flat = scan_request_chunks(
                lambda r, m: resolve(r[:, 0], m[:, 0]),
                rel.reshape(-1, 1), ok.reshape(-1, 1), chunk)
            out = flat.reshape(*rel.shape, table.shape[-1])
        ctx.save_for_backward(rel, ok)
        ctx.args = (mesh, impl, grad_axes, table.shape, table.dtype)
        return out

    @staticmethod
    def backward(ctx, g):

        rel, ok = ctx.saved_tensors
        mesh, impl, grad_axes, shape, dtype = ctx.args
        gf = g.reshape(-1, shape[-1]).to(torch.float32)
        if impl == "kernel":
            dtab = gas.gas_scatter_weighted(
                rel.reshape(-1).to(torch.int32), gf,
                torch.ones(gf.shape[0], dtype=torch.float32,
                           device=gf.device),
                ok.reshape(-1), shape[0], op="add", impl="kernel")
        else:
            # ids another rank owns add into a spare last row, dropped
            # after: the same sums as taking the owned ids alone, with no
            # shape that depends on the ids
            idx = torch.where(ok.reshape(-1), rel.reshape(-1), shape[0])
            dtab = torch.zeros((shape[0] + 1, shape[1]), dtype=torch.float32,
                               device=gf.device)
            dtab = dtab.index_add_(0, idx, gf)[:shape[0]]
        if grad_axes:
            dtab = collectives.all_reduce(dtab, mesh, axis=grad_axes)
        return (dtab.to(dtype),) + (None,) * 8


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, *, mesh=None,
                 cgtrans: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 impl: str = "ref", request_chunk: Optional[int] = None,
                 grad_psum: bool = True, rules=None) -> torch.Tensor:
    """ids: (B, S) integer → (B, S, D) in ``compute_dtype``.

    On a mesh ``table`` is this rank's vocab shard ``(V/tp, D)`` and
    ``ids`` its rows of the batch. ``impl`` is the backend of the
    owner-side gradient scatter and ``request_chunk`` streams the
    flattened tokens through the lookup; both are inert off the cgtrans
    path, as in the JAX package. The table gradient is summed over the
    batch axes of ``rules`` (default ``DEFAULT_RULES``; the table is
    replicated over them, and under ``batch=()`` every rank holds the same
    rows, so nothing is summed); ``grad_psum=False``
    leaves each rank its rows' part, for a caller whose table arrived
    through a gather that sums it (the LM's ZeRO-3 gather over ``data``).
    """
    if impl not in ("ref", "kernel"):
        raise ValueError(f"unknown impl {impl!r}: 'ref' or 'kernel'")
    if mesh is None:
        return table[ids.long()].to(compute_dtype)
    check_named_mesh(mesh)

    axis = model_axis(mesh)
    dp = batch_axes(mesh, rules)
    grad_axes = dp if grad_psum and dp_size(mesh, rules) > 1 else None
    # the shard is (V/tp, D), so V splits evenly over model by construction
    # (local_block refuses an uneven split): JAX's V % tp fallback to a
    # plain take cannot arise here
    if not cgtrans or axis is None:
        if grad_axes:
            table = collectives.pvary(table, mesh, axis=grad_axes)
        if axis is not None:
            parts = collectives.all_gather_invariant(
                table, mesh, axis=axis, name="table_gather")
            table = parts.reshape(-1, table.shape[-1])
        return table[ids.long()].to(compute_dtype)
    shard = table.shape[0]
    rel, ok = _owned(ids, mesh.axis_index(axis) * shard, shard)
    return _OwnerLookup.apply(table, rel, ok, mesh, axis, compute_dtype,
                              impl, request_chunk, grad_axes)


def logits_matmul(x: torch.Tensor, table: torch.Tensor, *,
                  softcap: float = 0.0, valid_vocab: int = 0,
                  vocab_offset: int = 0) -> torch.Tensor:
    """(…, D) @ (V, D)ᵀ → (…, V), float32 accumulation and output.

    ``valid_vocab``: padded table rows (≥ valid_vocab) get -1e30 so the
    vocab padding never leaks into softmax or sampling. ``table`` may be a
    vocab shard whose first row is row ``vocab_offset`` of the whole
    table.
    """
    logits = x.float() @ table.to(x.dtype).float().T
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    V = table.shape[0]
    if valid_vocab and valid_vocab < vocab_offset + V:
        pad = (torch.arange(V, device=x.device) + vocab_offset
               ) >= valid_vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits


def vocab_logits(x: torch.Tensor, table: torch.Tensor, *, mesh=None,
                 softcap: float = 0.0, valid_vocab: int = 0
                 ) -> torch.Tensor:
    """``logits_matmul`` over the whole vocabulary: on a mesh ``table``
    is the rank's vocab shard, and the shards' logits are gathered over
    ``model`` (no gradient: the serving path)."""
    axis = model_axis(mesh)
    if axis is None:
        return logits_matmul(x, table, softcap=softcap,
                             valid_vocab=valid_vocab)
    lo = mesh.axis_index(axis) * table.shape[0]
    part = logits_matmul(x, table, softcap=softcap, valid_vocab=valid_vocab,
                         vocab_offset=lo)
    parts = collectives.all_gather_invariant(part.movedim(-1, 0).contiguous(),
                                             mesh, axis=axis)
    return parts.reshape(-1, *part.shape[:-1]).movedim(0, -1)


def _chunk_loss(xi, table, li, softcap: float, valid_vocab: int):
    """(sum of -log p(label), count of labels ≥ 0) over one chunk."""
    logits = logits_matmul(xi, table, softcap=softcap,
                           valid_vocab=valid_vocab)     # (B, chunk, V) f32
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, torch.clamp(li, min=0).long()[..., None]
                        )[..., 0]
    valid = (li >= 0).to(torch.float32)
    return torch.sum((lse - gold) * valid), torch.sum(valid)


def _chunk_loss_sharded(xi, table, li, softcap: float, valid_vocab: int,
                        mesh, axis: str):
    """``_chunk_loss`` with vocab-parallel logits: this rank's shard's
    logits, the row max and the sums of exponentials and of the owner's
    gold logit reduced over ``axis``."""

    lo = mesh.axis_index(axis) * table.shape[0]
    logits = logits_matmul(collectives.pvary(xi, mesh, axis=axis), table,
                           softcap=softcap, valid_vocab=valid_vocab,
                           vocab_offset=lo)         # (B, chunk, V/tp) f32
    m = collectives.all_reduce(logits.detach().amax(-1), mesh, axis=axis,
                               op="max")
    rel, own = _owned(torch.clamp(li, min=0), lo, table.shape[0])
    own = own & (li >= 0)
    gold = torch.gather(logits, -1, rel[..., None])[..., 0] * own
    sums = collectives.psum(torch.stack(
        [torch.exp(logits - m[..., None]).sum(-1), gold], -1), mesh,
        axis=axis)
    lse = m + torch.log(sums[..., 0])
    valid = (li >= 0).to(torch.float32)
    return torch.sum((lse - sums[..., 1]) * valid), torch.sum(valid)


def xent_chunk(B: int, S: int, V: int, *, dp: int = 1, tp: int = 1,
               max_chunk: int = 512, byte_budget: int = 1 << 28) -> int:
    """The JAX package's sequence chunk: the largest divisor of S at most
    ``min(max_chunk, byte_budget // ((B/dp)·(V/tp)·4))`` — the logits block
    one device holds."""
    dev_bytes = max((B // max(dp, 1)) * (V // max(tp, 1)) * 4, 1)
    chunk = max(1, min(max_chunk, byte_budget // dev_bytes))
    while S % chunk:
        chunk -= 1
    return chunk


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

    The chunk is the JAX package's (``xent_chunk``), so the loss sums the
    same chunks in the same order. Under autograd each chunk is
    checkpointed (its logits recomputed in the backward, as
    ``jax.checkpoint`` does), so the backward holds one (B, chunk, V) f32
    block at a time. On a mesh ``x`` and ``labels`` are this rank's rows,
    ``table`` its vocab shard, the logits vocab-parallel, and the sums
    cover this rank's rows (``loss_fn`` sums them over the batch axes).
    """
    B, S, _ = x.shape
    axis = None
    if mesh is not None:
        check_named_mesh(mesh)
        axis = model_axis(mesh)
    # x and table are already this rank's rows and vocab shard
    chunk = xent_chunk(B, S, table.shape[0], max_chunk=max_chunk,
                       byte_budget=byte_budget)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    fn, extra = ((_chunk_loss, ()) if axis is None
                 else (_chunk_loss_sharded, (mesh, axis)))
    for lo in range(0, S, chunk):
        args = (x[:, lo:lo + chunk], table, labels[:, lo:lo + chunk],
                softcap, valid_vocab, *extra)
        l, c = (checkpoint(fn, *args, use_reentrant=False)
                if remat else fn(*args))
        loss_sum = loss_sum + l
        cnt = cnt + c
    return loss_sum, cnt
