"""Port parity: the dataflow contract registry, checked by counting runs.

* the grid: the port's contract names are the JAX package's
  ``CONTRACTS``, all 57 (``WAITING`` is empty);
* every budget equals the JAX registry's static dict (the kernel
  route's forward + backward through ``budgets.held``: the pallas tables'
  psums are not in the reference's grad program, except the lookup's,
  which are real; the baseline lookup's ``table_gather`` is counted
  outside the JAX program's keys). The reference's own
  live check cannot run on the installed JAX (its alias table does not
  know ``psum_invariant``), so the static dicts are the reference here;
* ``verify_all`` is clean on 8 CPU gloo ranks, one case per contract and
  pass, and each kernel-route contract runs the GAS kernel
  ``kernel_of`` names (its plain version, on the CPU) in the pass
  ``kernel_pass`` names;
* a planted extra collective fails with the exact budget / counted line,
  and an unknown budget key raises;
* the ``/sched`` and forward + backward rules of the JAX registry.

One spawn of 8 ranks serves the whole file (module fixture); the ranks
import ``torch`` and ``repro_torch`` only.
"""

import sys

import pytest
import torch

from repro_torch.analysis import budgets
from repro_torch.analysis import contracts as C
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.counts import OUTSIDE_KEYS

# One intra-op thread: the tier-1 run puts several pytest workers on one
# host, and torch's default thread pool in each of them oversubscribes
# its cores (every spawned rank sets the same).
torch.set_num_threads(1)

TIMEOUT_S = 600
NAMES = C.covered_configurations()
PLANTED = "planted/extra_all_to_all"


def _jax_contracts():
    from repro.analysis.contracts import CONTRACTS
    return CONTRACTS


def _foreign_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def _planted_build(mesh):
    """``aggregate_sampled/cgtrans/xla`` with one extra all_to_all."""
    from repro_torch.core import collectives
    fn, args = C.CONTRACTS["aggregate_sampled/cgtrans/xla"].build(mesh)

    def extra(*a):
        out = fn(*a)
        return out, collectives.all_to_all(out.reshape(mesh.size, -1), mesh)
    return extra, args


def _contracts_rank(mesh):
    from repro_torch.kernels.gas_scatter import kernel as K
    from repro_torch.launch.counts import count_run

    verified = C.verify_rank(mesh)
    # the kernel route's plain versions stand in for the kernels on the
    # CPU: count which one each contract's forward runs
    plain = {}
    for kind in ("banded", "dense"):
        real = getattr(K, f"gas_scatter_{kind}_plain")

        def counted(*a, _real=real, _kind=kind, **kw):
            plain[_kind] = plain.get(_kind, 0) + 1
            return _real(*a, **kw)
        setattr(K, f"gas_scatter_{kind}_plain", counted)
    plains = {}
    for name in NAMES:
        fn, args = C.CONTRACTS[name].build(mesh)
        plain.clear()
        count_run(fn, *args, fwd_bwd=C.kernel_pass(name) == "fwd+bwd")
        plains[name] = dict(plain)
    planted = C.verify_contract(C.DataflowContract(
        PLANTED, _planted_build,
        C.CONTRACTS["aggregate_sampled/cgtrans/xla"].forward), mesh)
    return {**verified, "plain": plains, "planted": planted,
            "modules": _foreign_modules()}


@pytest.fixture(scope="module")
def ranks():
    return meshlib.spawn(_contracts_rank, C.WAYS, backend="gloo",
                         device="cpu", timeout_s=TIMEOUT_S)


# ---------------------------------------------------------------------------
# the registry against the JAX package's
# ---------------------------------------------------------------------------

def test_grid_is_the_reference_grid_minus_waiting():
    """Nothing waits any more: the grid is the JAX registry's, all 57."""
    jax_names = set(_jax_contracts())
    assert len(jax_names) == 57 and len(C.CONTRACTS) == 57
    assert C.WAITING == {}
    assert set(C.CONTRACTS) == jax_names - set(C.WAITING)


def _without_outside(budget):
    return {k: v for k, v in budget.items() if k not in OUTSIDE_KEYS}


@pytest.mark.parametrize("name", NAMES)
def test_budget_is_the_reference_static_budget(name):
    want = _jax_contracts()[name]
    got = C.CONTRACTS[name]
    assert _without_outside(got.forward) == dict(want.forward)
    assert got.dtype_waivers == want.dtype_waivers
    if want.fwd_bwd is None:
        assert got.fwd_bwd is None
    elif name.startswith("embed_lookup/"):
        # the lookup's backward psum over the batch axes is real
        assert got.fwd_bwd == dict(want.fwd_bwd)
    elif got.impl == "kernel":
        # the pallas table's psums are dropped through budgets.held: the
        # xla twin's collectives, the pallas table's dispatches
        twin = _jax_contracts()[name.replace("/pallas", "/xla")]
        assert got.fwd_bwd == budgets.held(twin.fwd_bwd, want.fwd_bwd)
        assert got.fwd_bwd == {k: v for k, v in want.fwd_bwd.items()
                               if k != "psum"}
    else:
        assert got.fwd_bwd == dict(want.fwd_bwd)


def test_outside_keys_only_on_the_train_step():
    for name, c in C.CONTRACTS.items():
        outside = {k: v for k, v in c.forward.items() if k in OUTSIDE_KEYS}
        if name.startswith("train_step/"):
            assert outside == {"grad_all_reduce": 1, "metric_all_reduce": 1}
        elif name == "embed_lookup/baseline/xla":
            # GSPMD's table movement, outside the JAX program
            assert outside == {"table_gather": 1}
        else:
            assert outside == {}


def test_unknown_budget_key_raises():
    with pytest.raises(ValueError, match="unknown budget key 'psum2'"):
        C.DataflowContract("x", lambda mesh: None, {"psum2": 1})
    with pytest.raises(ValueError, match="unknown budget key 'findz'"):
        C.DataflowContract("x", lambda mesh: None, {}, {"findz": 1})


def test_unknown_waiver_raises():
    with pytest.raises(ValueError, match="unknown dtype rule"):
        C.DataflowContract("x", lambda mesh: None, {},
                           dtype_waivers=("narrow-wires",))


def test_sched_variants_pin_forward_only_and_grad_families_budget_bwd():
    """The JAX registry's rules: a ``/sched`` variant pins the forward
    only (scheduling is collective- and dispatch-neutral); every fetch
    entry point that training differentiates budgets forward + backward."""
    grad_families = ("aggregate_sampled/", "aggregate_multi/",
                     "sage_forward/")
    for name, c in C.CONTRACTS.items():
        if name.endswith("/sched"):
            assert c.fwd_bwd is None, name
            assert c.forward == C.CONTRACTS[name[:-len("/sched")]].forward
        elif name.startswith(grad_families):
            assert c.fwd_bwd is not None, name


def test_sage_tables_agree_with_sage_contracts():
    for form in ("separate", "coalesced"):
        fwd = C.CONTRACTS[f"sage_forward/{form}/xla"].forward
        for key, n in {**budgets.SAGE_FETCH_COLLECTIVES[form],
                       **budgets.SAGE_FETCH_DISPATCH[form]}.items():
            assert fwd[key] == n, (form, key)


def test_chunked_budget_streams_each_segment():
    fwd = C.CONTRACTS["sage_forward/coalesced/pallas/sched"].forward
    assert C.chunked(fwd, 2) == {"all_gather": 2, "all_to_all": 2,
                                 "find": 2, "reduce": 1, "kernel_scatter": 1}


def test_verify_all_on_cpu_ranks():
    """The entry point itself: its own spawn of 8 CPU ranks, merged."""
    assert C.verify_all(["aggregate_multi/cgtrans/xla",
                         "train_step/coalesced/pallas"], device="cpu") == {}


def test_verify_all_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        C.verify_all()


# ---------------------------------------------------------------------------
# the runs: 8 CPU gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_contract_holds_on_8_ranks(ranks, name):
    """What ``verify_all`` returns (``verify_rank`` on every rank, merged)
    names no failure of this contract; each rank ran both passes."""
    assert all(res["modules"] == [] for res in ranks)
    assert C.merge_ranks(ranks).get(name) is None
    passes = {"forward"} | ({"fwd+bwd"} if C.CONTRACTS[name].fwd_bwd
                            is not None else set())
    assert all(set(res["launches"][name]) == passes for res in ranks)


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if C.CONTRACTS[n].impl == "kernel"])
def test_kernel_route_runs_the_named_kernel(ranks, name):
    """Each kernel-route contract's run (its forward, or forward +
    backward where ``kernel_pass`` says so) runs the GAS kernel
    ``kernel_of`` names on every rank (its plain version on the CPU), and
    no other; the reference route runs neither."""
    kind = C.kernel_of(name).removeprefix("gas_scatter_")
    for res in ranks:
        assert set(res["plain"][name]) == {kind}, res["plain"][name]


def test_reference_route_runs_no_kernel(ranks):
    for name in NAMES:
        if C.CONTRACTS[name].impl == "ref":
            assert C.kernel_of(name) is None
            assert all(res["plain"][name] == {} for res in ranks), name


def test_planted_extra_collective_fails_with_the_exact_line(ranks):
    for res in ranks:
        assert res["planted"] == [
            f"{PLANTED} [forward] collective all_to_all: budget 1, "
            f"counted 2"]


def test_merge_ranks_reports_each_line_once():
    line = "a [forward] collective psum: budget 0, counted 1"
    merged = C.merge_ranks([{"failures": {"a": [line]}},
                            {"failures": {"a": [line, "b"]}},
                            {"failures": {}}])
    assert merged == {"a": [line, "b"]}
