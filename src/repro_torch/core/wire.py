"""Wire formats for the CGTrans collectives — the "C" made literal.

A pure codec layer: encode / decode transforms with no collectives of their
own. The one collective they wrap lives in ``repro_torch.core.cgtrans``
(``_wire_all_to_all``), beside every other counted collective. Three wire
formats, selected per dataflow call (``wire=`` on the ``aggregate_*``
entry points, ``GCNConfig.wire``, ``ServingEngine(wire=)``):

* ``"f32"``  — the raw wire; no codec runs.
* ``"bf16"`` — cast the partials to bfloat16 and ship the bits as int16
  (the JAX package's integer bitcast; the port's collectives ship int16 as
  a byte view, the same bytes), cast back and accumulate in f32 on
  arrival. Integer-valued payloads with ``|x| ≤ 256`` round-trip bit for
  bit; ±inf identity rows survive as themselves.
* ``"int8"`` — symmetric per-row quantization: each row gets
  ``scale = max|finite x| / 127`` in f32 and ships ``round(x / scale)`` as
  int8 (``torch.round`` rounds half to even, as ``jnp.round`` does). The
  f32 scale rides the row as 4 bitcast int8 columns, non-finite entries
  ship as the reserved code −128 and decode to the op identity, and
  ``n_exact`` trailing columns (the add path's contribution counts) ride
  as 4 bitcast int8 columns each, so a mean never divides by a quantized
  count.

The request broadcast compresses too: ``delta_encode_ids`` turns the
``-1``-encoded id stream into first-order deltas shipped as int16, lossless
whenever ``delta_ids_fit`` holds for the vertex range (ids in ``[-1, V)``
have deltas in ``[-V, V]``); the decode is an int32 cumsum. The encoded
bytes equal the JAX package's ``encode_payload`` on the same block.
"""

from __future__ import annotations

import torch

#: the wire formats every ``wire=`` knob accepts
WIRE_FORMATS = ("f32", "bf16", "int8")

#: ids in [-1, V) have deltas in [-V, V]; int16 holds them iff V ≤ this
ID_DELTA_MAX_V = 2**15 - 1

#: the reserved int8 code for non-finite payload entries (±inf identity
#: rows); quantized values clip to [-127, 127] so it never collides
INT8_SENTINEL = -128

#: bitcast width of one f32 column carried exactly inside an int8 block
_F32_BYTES = 4


def validate(wire: str) -> str:
    """The one place a wire-format string is checked."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"unknown wire format {wire!r} (have {WIRE_FORMATS})")
    return wire


# ---------------------------------------------------------------------------
# the request broadcast: delta-encoded id streams (the all_gather half)
# ---------------------------------------------------------------------------

def delta_ids_fit(n_vertices: int) -> bool:
    """Static gate: can a [-1, n_vertices) id stream ship as int16 deltas?"""
    return int(n_vertices) <= ID_DELTA_MAX_V


def delta_encode_ids(ids: torch.Tensor) -> torch.Tensor:
    """(…, N) int32 id stream (``-1`` dead ids included) → int16 first-order
    deltas along the last axis. Lossless whenever ``delta_ids_fit`` holds
    for the stream's vertex range; the caller checks."""
    d = ids.to(torch.int32)
    d = torch.cat([d[..., :1], d[..., 1:] - d[..., :-1]], dim=-1)
    return d.to(torch.int16)


def delta_decode_ids(deltas: torch.Tensor) -> torch.Tensor:
    """Inverse of ``delta_encode_ids``: int32 cumsum along the last axis."""
    return torch.cumsum(deltas.to(torch.int32), dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# the result shipment: quantized partial blocks (the all_to_all half)
# ---------------------------------------------------------------------------

def _as_int8(x: torch.Tensor) -> torch.Tensor:
    """(…, k) float32 → (…, 4·k) int8, the same bytes."""
    return x.to(torch.float32).contiguous().view(torch.int8)


def _as_f32(x: torch.Tensor) -> torch.Tensor:
    """(…, 4·k) int8 → (…, k) float32, the same bytes."""
    return x.contiguous().view(torch.float32)


def _scale(x: torch.Tensor) -> torch.Tensor:
    """max|finite x| / 127 per row, in f32 (0 for a row with none)."""
    zero = torch.zeros((), device=x.device)
    return torch.where(torch.isfinite(x), x.abs(), zero).amax(dim=-1) / 127.0


def int8_row_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-row quantization scale ``encode_payload`` divides by (1
    where a row has no finite nonzero), for the round-trip bound
    ``|decode(encode(x)) − x| ≤ scale / 2``."""
    scale = _scale(x.to(torch.float32))
    return torch.where(scale > 0, scale, torch.ones((), device=x.device))


def encode_payload(x: torch.Tensor, wire: str, *, identity: float = 0.0,
                   n_exact: int = 0) -> torch.Tensor:
    """Encode a float partial block ``(…, C)`` for transport.

    ``n_exact`` trailing columns are carried exactly: cast along on the
    bf16 wire, bitcast to raw bytes on the int8 wire. ``identity`` is what
    non-finite entries decode back to (int8 wire only; bf16 holds ±inf)."""
    validate(wire)
    if wire == "f32":
        return x
    if wire == "bf16":
        return x.to(torch.bfloat16).view(torch.int16)
    C = x.shape[-1] - n_exact
    feat = x[..., :C].to(torch.float32)
    finite = torch.isfinite(feat)
    scale = _scale(feat)                 # shipped as is, 0 included
    safe = torch.where(scale > 0, scale, torch.ones((), device=x.device))
    # non-finite entries never reach the int cast: they ship the sentinel
    q = torch.clamp(torch.round(torch.where(
        finite, feat / safe[..., None], torch.zeros((), device=x.device))),
        -127, 127).to(torch.int8)
    q = torch.where(finite, q, torch.full((), INT8_SENTINEL, dtype=torch.int8,
                                          device=x.device))
    cols = [q, _as_int8(scale[..., None])]
    if n_exact:
        cols.append(_as_int8(x[..., C:]))
    return torch.cat(cols, dim=-1)


def decode_payload(enc: torch.Tensor, wire: str, *, identity: float = 0.0,
                   n_exact: int = 0, out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``encode_payload``, always into f32 math (``out_dtype``
    only recasts at the end)."""
    validate(wire)
    if wire == "f32":
        return enc
    if wire == "bf16":
        return enc.view(torch.bfloat16).to(out_dtype)
    C = enc.shape[-1] - _F32_BYTES - _F32_BYTES * n_exact
    q = enc[..., :C]
    scale = _as_f32(enc[..., C:C + _F32_BYTES])            # (…, 1)
    vals = torch.where(q == INT8_SENTINEL,
                       torch.full((), identity, dtype=torch.float32,
                                  device=enc.device),
                       q.to(torch.float32) * scale)
    if n_exact:
        vals = torch.cat([vals, _as_f32(enc[..., C + _F32_BYTES:])], dim=-1)
    return vals.to(out_dtype)
