"""Port parity: blocked flash attention (``kernels/flash_attention``).

On the CPU the port's wrapper runs its plain PyTorch version, the same
blocked online-softmax walk as the TPU kernel. It is held against the JAX
package's ``flash_attention`` (the Pallas kernel in interpret mode) and its
oracle ``flash_attention_ref`` on the same numpy inputs, over the cases and
the property test of ``tests/test_kernels_flash.py``:

* float32 within atol = 3e-5, rtol = 1e-4, as there;
* bfloat16 within atol = 2e-2, rtol = 1e-2: p is rounded to bf16 before
  the PV product in every version, so a probability whose f32 value
  differs in the last bits can round to the neighbouring bf16 value.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _propcheck import given, settings, strategies as st

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention import flash_attention_ref as j_ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import kernel as FK

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores.
torch.set_num_threads(1)

TOL = {"float32": dict(atol=3e-5, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=1e-2)}

CASES = [
    dict(B=1, S=256, T=256, H=4, Hkv=2, hd=32, causal=True),
    dict(B=2, S=128, T=128, H=2, Hkv=1, hd=64, causal=True, window=64),
    dict(B=1, S=200, T=200, H=4, Hkv=4, hd=16, causal=True, softcap=50.0),
    dict(B=1, S=128, T=384, H=2, Hkv=2, hd=32, causal=False),
    dict(B=1, S=130, T=130, H=2, Hkv=2, hd=8, causal=True),     # odd pad
    dict(B=1, S=256, T=256, H=8, Hkv=2, hd=16, causal=True, window=100,
         softcap=30.0),                                          # everything
]


def _inputs(rng, B, S, T, H, Hkv, hd, dtype):
    """q, k, v as numpy float32 holding values exact in ``dtype``."""
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32) * hd ** -0.5
    k = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    return [torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
            for x in (q, k, v)]


def _both(arrays, dtype):
    """The same values as JAX arrays and as torch tensors of ``dtype``."""
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _np(x):
    return (x.float().numpy() if torch.is_tensor(x)
            else np.asarray(x.astype(jnp.float32)))


def _check_against_jax(arrays, dtype, kw, *, with_pallas=True):
    jx, tx = _both(arrays, dtype)
    got = _np(flash_attention(*tx, **kw))
    want_ref = _np(j_ref(*jx, **kw))
    np.testing.assert_allclose(got, want_ref, **TOL[dtype])
    np.testing.assert_allclose(_np(flash_attention_ref(*tx, **kw)), want_ref,
                               **TOL[dtype])
    if with_pallas:
        np.testing.assert_allclose(got, _np(j_flash(*jx, **kw)),
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_plain_version_matches_jax_flash_and_oracle(rng, case, dtype):
    kw = {k: case[k] for k in ("causal", "window", "softcap") if k in case}
    arrays = _inputs(rng, *(case[k] for k in ("B", "S", "T", "H", "Hkv",
                                              "hd")), dtype)
    _check_against_jax(arrays, dtype, kw)


def test_row_softmax_property(rng):
    """Output is a convex combination of V rows: bounded by min/max of v."""
    B, S, H, hd = 1, 128, 2, 16
    q = torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, H, hd)).astype(np.float32))
    v = torch.full((B, S, H, hd), 3.0)
    out = flash_attention(q, k, v, causal=True)
    np.testing.assert_allclose(out.numpy(), 3.0, atol=1e-4)


@settings(max_examples=10, deadline=None)
@given(
    s=st.sampled_from([64, 96, 128, 200, 256]),
    h=st.sampled_from([1, 2, 4]),
    g=st.sampled_from([1, 2]),
    hd=st.sampled_from([8, 16, 32]),
    causal=st.booleans(),
    window=st.sampled_from([0, 32, 100]),
    seed=st.integers(0, 2**31 - 1),
)
def test_property_matches_jax(s, h, g, hd, causal, window, seed):
    if window and not causal:
        window = 0
    rng = np.random.default_rng(seed)
    arrays = _inputs(rng, 1, s, s, h * g, h, hd, "float32")
    _check_against_jax(arrays, "float32", dict(causal=causal, window=window))


@pytest.mark.parametrize("S,T,causal,window", [
    (130, 130, True, 0),      # odd pad on both sides
    (96, 200, False, 0),      # fewer queries than keys
    (200, 72, True, 0),       # more queries than keys: padded keys masked
    (130, 300, False, 40),    # window without causal, both padded
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_pads_and_slices(rng, S, T, causal, window, dtype):
    arrays = _inputs(rng, 2, S, T, 4, 2, 16, dtype)
    kw = dict(causal=causal, window=window)
    _, tx = _both(arrays, dtype)
    out = flash_attention(*tx, **kw)
    assert out.shape == (2, S, 4, 16) and out.dtype == tx[0].dtype
    _check_against_jax(arrays, dtype, kw, with_pallas=False)


def test_plain_version_walks_the_tpu_blocks(rng):
    """The raw entry on (B·H, S, hd): kv_len masks the padded keys, GQA maps
    query head h of batch row b to kv head b·Hkv + h // G, and fully masked
    query rows (past T + window) stay finite."""
    BH, S, T, hd, Hkv = 2 * 4, 256, 256, 16, 2
    q = torch.from_numpy(rng.standard_normal((BH, S, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2 * Hkv, T, hd)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((2 * Hkv, T, hd)).astype(
        np.float32))
    kw = dict(causal=False, window=0, softcap=0.0, n_kv_heads=Hkv)
    out = FK.flash_attention_fwd(q, k, v, kv_len=200, **kw)
    want = flash_attention_ref(q.reshape(2, 4, S, hd).transpose(1, 2),
                               k[:, :200].reshape(2, Hkv, 200, hd).transpose(
                                   1, 2),
                               v[:, :200].reshape(2, Hkv, 200, hd).transpose(
                                   1, 2), causal=False)
    np.testing.assert_allclose(out.reshape(2, 4, S, hd).transpose(1, 2),
                               want, atol=3e-5, rtol=1e-4)
    far = FK.flash_attention_fwd(q, k, v, kv_len=100, causal=True, window=8,
                                 softcap=0.0, n_kv_heads=Hkv)
    assert torch.isfinite(far).all()


def test_wrapper_counts_and_checks():
    """CPU tensors run the plain version (a call, not a launch); shapes the
    kernel does not take raise before anything runs."""
    FK.reset_launch_counts()
    q = torch.zeros((2, 128, 16))
    kv = torch.zeros((2, 128, 16))
    FK.flash_attention_fwd(q, kv, kv, causal=True, window=0, softcap=0.0,
                           kv_len=128, n_kv_heads=1)
    assert FK.launch_counts() == {"flash_attention": 0}
    assert FK.flash_attention_plain.calls == 1
    kw = dict(causal=True, window=0, softcap=0.0, kv_len=128, n_kv_heads=1)
    with pytest.raises(ValueError, match="multiples of 128"):
        FK.flash_attention_fwd(torch.zeros((2, 100, 16)), kv, kv, **kw)
    with pytest.raises(ValueError, match="multiple of 8"):
        FK.flash_attention_fwd(torch.zeros((2, 128, 12)),
                               torch.zeros((2, 128, 12)),
                               torch.zeros((2, 128, 12)), **kw)
    with pytest.raises(ValueError, match="up to 256"):
        big = torch.zeros((1, 128, 264))
        FK.flash_attention_fwd(big, big, big, **kw)
    with pytest.raises(TypeError, match="one dtype"):
        FK.flash_attention_fwd(q.half(), kv.half(), kv.half(), **kw)
    with pytest.raises(TypeError, match="one dtype"):
        FK.flash_attention_fwd(q, kv.to(torch.bfloat16), kv, **kw)
    with pytest.raises(ValueError, match="kv_len"):
        FK.flash_attention_fwd(q, kv, kv, **{**kw, "kv_len": 129})
    with pytest.raises(ValueError, match="kv heads"):
        FK.flash_attention_fwd(torch.zeros((3, 128, 16)), kv, kv, **kw)
    FK.reset_launch_counts()
    assert FK.flash_attention_plain.calls == 0
