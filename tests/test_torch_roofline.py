"""Port parity: the roofline arithmetic (``launch/roofline.py``) and the
card's spec (``common/hw.py``). The terms equal the JAX package's on the
same numbers when the port is given the JAX chip's constants; the H100
spec holds its data sheet's numbers."""

import dataclasses
import types

import pytest

from repro_torch.common.hw import H100, ChipSpec
from repro_torch.launch import roofline as R

COLLS = {"all-gather": {"count": 2, "bytes": 4096.0},
         "all-to-all": {"count": 1, "bytes": 33024.0}}


def _jax():
    from repro.common.hw import V5E
    from repro.launch import roofline as JR
    return V5E, JR


@pytest.mark.parametrize("flops,nbytes,model_flops", [
    (1e12, 1e9, 0.0), (3e9, 8e10, 2.5e9), (0.0, 1.0, 0.0)])
def test_terms_equal_the_reference_at_its_chip(flops, nbytes, model_flops):
    V5E, JR = _jax()
    chip = ChipSpec(name=V5E.name, peak_flops_bf16=V5E.peak_flops_bf16,
                    hbm_bw=V5E.hbm_bw, ici_link_bw=V5E.ici_link_bw,
                    hbm_bytes=V5E.hbm_bytes)
    want = JR.roofline_terms(flops, nbytes, COLLS, chip=V5E,
                             model_flops=model_flops).as_dict()
    got = R.roofline_terms(flops, nbytes, COLLS, chip=chip,
                           model_flops=model_flops).as_dict()
    assert got == want


def test_h100_spec_is_the_data_sheet():
    assert (H100.sm_count, H100.smem_per_sm) == (132, 228 * 1024)
    assert (H100.hbm_bytes, H100.hbm_bw) == (80e9, 3.35e12)
    assert (H100.peak_flops_f32, H100.peak_flops_bf16) == (67e12, 989e12)
    assert H100.ici_link_bw == 900e9
    assert dataclasses.is_dataclass(H100) and "H100" in H100.name


def test_terms_default_to_the_h100_and_pick_the_peak_by_dtype():
    t = R.roofline_terms(67e9, 3.35e9, dtype="f32")
    assert (t.t_compute, t.t_memory, t.t_collective) == (1e-3, 1e-3, 0.0)
    b = R.roofline_terms(989e9, 0.0)
    assert b.t_compute == 1e-3 and b.dominant == "compute"
    m = R.roofline_terms(1.0, 3.35e12)
    assert m.dominant == "memory" and m.bound_s == 1.0
    with pytest.raises(ValueError, match="peak dtype"):
        R.roofline_terms(1.0, 1.0, dtype="f16")


@pytest.mark.parametrize("kind", ["train", "fwd", "decode"])
def test_model_flops_estimate_equals_the_reference(kind):
    _, JR = _jax()
    for n, active, tokens in ((1000, 0, 64.0), (5000, 1200, 8.0)):
        assert R.model_flops_estimate(n, active, kind, tokens) == \
            JR.model_flops_estimate(n, active, kind, tokens)


@pytest.mark.parametrize("n_experts", [0, 8])
def test_active_params_equals_the_reference(n_experts):
    _, JR = _jax()
    kinds = ("attn", "moe", "moe", "attn")
    cfg = types.SimpleNamespace(n_experts=n_experts, top_k=2, d_model=64,
                                d_ff=128, layer_kinds=lambda: kinds)
    assert R.active_params(cfg, 10**7) == JR.active_params(cfg, 10**7)
