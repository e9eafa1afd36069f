"""Port parity: the compressed wire codecs (``core/wire.py``).

The encoded payload must be byte-equal to the JAX package's
``encode_payload`` on the same block — f32, bf16 and int8, with
``identity=`` and ``n_exact=`` — and the decode equal to its
``decode_payload``. Also the delta-encoded id stream and its range gate,
bf16 bit-exactness on |x| ≤ 256, the int8 round-trip bound and the int8
sentinel. JAX is imported only where the reference is computed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import wire

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)


def _block(seed, shape=(3, 5, 9), inf_rows=True):
    """Normal data with a zero row, a tiny row, and (optionally) ±inf
    identity cells, as max / min partials hold them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    x[0, 0] = 0.0
    x[0, 1] *= 1e-3
    if inf_rows:
        x[1, 2] = -np.inf
        x[2, 3, :4] = np.inf
    return x


def _jax_codec(x, w, identity, n_exact):
    import jax.numpy as jnp

    from repro.core import wire as jwire

    enc = jwire.encode_payload(jnp.asarray(x), w, identity=identity,
                               n_exact=n_exact)
    dec = jwire.decode_payload(enc, w, identity=identity, n_exact=n_exact)
    return np.asarray(enc), np.asarray(dec)


@pytest.mark.parametrize("w,identity,n_exact", [
    ("f32", 0.0, 0), ("bf16", 0.0, 0), ("bf16", 0.0, 1),
    ("int8", 0.0, 0), ("int8", 0.0, 1), ("int8", float("-inf"), 0),
    ("int8", float("inf"), 2)])
def test_encode_payload_is_byte_equal_to_reference(w, identity, n_exact):
    x = _block(1, inf_rows=w != "f32" and n_exact == 0)
    if n_exact:
        # trailing exact columns: the add path's contribution counts
        x[..., -n_exact:] = np.arange(x[..., -n_exact:].size).reshape(
            x[..., -n_exact:].shape) % 7
    jenc, jdec = _jax_codec(x, w, identity, n_exact)
    enc = wire.encode_payload(torch.from_numpy(x), w, identity=identity,
                              n_exact=n_exact)
    got = enc.numpy()
    assert got.dtype == jenc.dtype and got.shape == jenc.shape
    assert got.tobytes() == jenc.tobytes()
    dec = wire.decode_payload(enc, w, identity=identity, n_exact=n_exact)
    np.testing.assert_array_equal(dec.numpy(), jdec)


@pytest.mark.parametrize("shape", [(2, 2), (4, 7), (2, 3, 33)])
def test_int8_scale_and_bound_equal_reference(shape):
    from repro.core import wire as jwire

    x = _block(2, shape, inf_rows=False)
    scale = wire.int8_row_scale(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(scale, np.asarray(jwire.int8_row_scale(x)))
    dec = wire.decode_payload(wire.encode_payload(torch.from_numpy(x),
                                                  "int8"), "int8").numpy()
    assert (np.abs(dec - x) <= scale[..., None] / 2 * (1 + 1e-6)).all()


def test_int8_sentinel_decodes_to_the_op_identity():
    x = np.array([[1.0, -np.inf, 2.0], [np.inf, np.inf, np.inf],
                  [np.nan, 0.5, -4.0]], np.float32)
    for identity in (float("-inf"), float("inf"), 0.0):
        enc = wire.encode_payload(torch.from_numpy(x), "int8",
                                  identity=identity)
        q = enc[:, :3].numpy()
        assert (q[~np.isfinite(x)] == wire.INT8_SENTINEL).all()
        assert (np.abs(q[np.isfinite(x)]) <= 127).all()
        dec = wire.decode_payload(enc, "int8", identity=identity).numpy()
        assert (dec[~np.isfinite(x)] == identity).all()
        # an all-non-finite row has scale 1, not 0 or NaN
        assert np.isfinite(dec[np.isfinite(x)]).all()


def test_bf16_is_bit_exact_on_integers_up_to_256():
    v = np.arange(-256, 257, dtype=np.float32).reshape(-1, 1)
    x = np.concatenate([v, v / 2, np.full_like(v, -np.inf)], axis=1)
    enc = wire.encode_payload(torch.from_numpy(x), "bf16")
    assert enc.dtype == torch.int16
    np.testing.assert_array_equal(wire.decode_payload(enc, "bf16").numpy(), x)
    # 257 needs a ninth mantissa bit
    odd = torch.tensor([[257.0]])
    assert wire.decode_payload(wire.encode_payload(odd, "bf16"), "bf16") != odd


@pytest.mark.parametrize("V", [2, 1000, wire.ID_DELTA_MAX_V])
def test_delta_ids_round_trip_and_equal_reference(V):
    import jax.numpy as jnp

    from repro.core import wire as jwire

    rng = np.random.default_rng(V)
    ids = rng.integers(-1, V, (3, 40)).astype(np.int32)
    ids[:, 0] = V - 1
    ids[:, 1] = -1               # a dead id after the largest one
    enc = wire.delta_encode_ids(torch.from_numpy(ids))
    assert enc.dtype == torch.int16
    np.testing.assert_array_equal(enc.numpy(), np.asarray(
        jwire.delta_encode_ids(jnp.asarray(ids))))
    dec = wire.delta_decode_ids(enc)
    assert dec.dtype == torch.int32
    np.testing.assert_array_equal(dec.numpy(), ids)


def test_delta_gate_boundary():
    assert wire.delta_ids_fit(wire.ID_DELTA_MAX_V)
    assert not wire.delta_ids_fit(wire.ID_DELTA_MAX_V + 1)
    # over the gate an id stream would wrap: the gate is what keeps it out
    ids = torch.tensor([[0, 40000]], dtype=torch.int32)
    assert not torch.equal(
        wire.delta_decode_ids(wire.delta_encode_ids(ids)), ids)


def test_unknown_wire_raises():
    with pytest.raises(ValueError, match="unknown wire"):
        wire.validate("fp4")
    with pytest.raises(ValueError):
        wire.encode_payload(torch.zeros(2, 2), "fp8")
