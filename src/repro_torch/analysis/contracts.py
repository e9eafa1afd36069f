"""Dataflow contracts: the communication and dispatch budget of every
sharded entry point configuration, checked by counting real runs.

The registry of the JAX package's ``repro.analysis.contracts``, name for
name: ``.../xla`` runs the port's ``impl="ref"``, ``.../pallas``
``impl="kernel"``. A ``DataflowContract`` pins, for one configuration
(dataflow × impl × coalesce × scheduled × wire × features):

* the exact **collective counts** of one run, by the JAX primitives'
  canonical names (``launch.counts.COLLECTIVE_PRIMITIVES``), plus the
  collectives JAX issues outside its traced program under keys of their
  own (``launch.counts.OUTSIDE_KEYS``: the train step's gradient and
  metric all-reduces);
* the exact **GAS dispatch budget**: ``find``, ``reduce`` and
  ``kernel_scatter``;
* the **forward vs. forward + backward split**: ``fwd_bwd`` budgets the
  backward with respect to the first argument of the summed float
  outputs;
* the **dtype waivers**: the ``analysis.dtype_flow`` rules the
  configuration relaxes on purpose, with the reason in ``note``.

Where JAX traces ``build()``'s abstract arguments, the port runs the entry
point once on a ``DataMesh`` of ``WAYS`` ranks (``verify_all`` spawns
them, gloo on the CPU or ranks sharing one card) on inputs drawn with
numpy from a seed, at the JAX registry's shapes, and counts the run
(``launch.counts.count_run``). Budgets are exact including implicit
zeros: a counted key the budget does not name fails. Every number comes
from ``analysis/budgets.py``; the kernel route's forward + backward is
held through ``budgets.held`` (the pallas tables' ``psum`` entries are
not in the reference's grad program; ``budgets.py`` says why).

JAX registers 57 contracts and so does the port. The three
``embed_lookup/*`` contracts run on a 2 × 4 (data × model) ``Mesh`` of the
same ranks; the baseline's table gather, which GSPMD inserts outside the
JAX program, is counted under ``table_gather`` (``launch.counts
.OUTSIDE_KEYS``). Their kernel-route backward launches the dense grid:
``kernel_pass`` names the pass a kernel-route contract launches in.
"""

from __future__ import annotations

import dataclasses
import traceback
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis import budgets
from repro_torch.analysis.budgets import merge
from repro_torch.analysis.dtype_flow import check_dtype_flow, validate_waivers
from repro_torch.device import DeviceLike
from repro_torch.launch.counts import (COLLECTIVE_PRIMITIVES, DISPATCH_KEYS,
                                       OUTSIDE_KEYS, count_run)

#: the JAX contracts the port does not register yet, and the ROADMAP row
#: that brings them
WAITING: Dict[str, str] = {}

#: the JAX backend names of the port's routes
IMPLS = {"xla": "ref", "pallas": "kernel"}


@dataclasses.dataclass(frozen=True)
class DataflowContract:
    """One entry point configuration's committed budget.

    ``build(mesh)`` returns ``(fn, args)`` for this rank of ``mesh``, its
    tensors on ``mesh.device``; gradients for ``fwd_bwd`` are taken with
    respect to ``args[0]`` through the summed float outputs.
    ``forward`` / ``fwd_bwd`` map collective and dispatch keys to exact
    counts — unnamed keys mean zero.
    """
    name: str
    build: Callable
    forward: Mapping[str, int]
    fwd_bwd: Optional[Mapping[str, int]] = None
    dtype_waivers: Tuple[str, ...] = ()
    note: str = ""

    def __post_init__(self):
        legal = set(COLLECTIVE_PRIMITIVES) | set(OUTSIDE_KEYS) | \
            set(DISPATCH_KEYS)
        for tag, budget in (("forward", self.forward),
                            ("fwd_bwd", self.fwd_bwd)):
            for k in (budget or {}):
                if k not in legal:
                    raise ValueError(
                        f"{self.name}: unknown budget key {k!r} in {tag} "
                        f"(canonical collectives: "
                        f"{sorted(COLLECTIVE_PRIMITIVES)}; outside the "
                        f"traced program: {sorted(OUTSIDE_KEYS)}; "
                        f"dispatches: {DISPATCH_KEYS})")
        validate_waivers(self.dtype_waivers)

    @property
    def impl(self) -> str:
        """The port's route: ``kernel`` for ``.../pallas``, else ``ref``."""
        return "kernel" if "/pallas" in self.name else "ref"


#: the entry points whose builder leaves ``scheduled`` at its default,
#: which is on for the kernel route (as JAX's builders leave it)
_DEFAULT_SCHEDULED = ("aggregate_edges/", "serving_fetch/",
                      "separate_fetch/")


#: the entry points whose kernel launches in the backward only (the
#: lookup's owner-side gradient scatter)
_BACKWARD_KERNEL = ("embed_lookup/",)


def kernel_pass(name: str) -> str:
    """The pass whose run launches ``kernel_of(name)``: ``"forward"``,
    or ``"fwd+bwd"`` where only the backward launches it."""
    return "fwd+bwd" if name.startswith(_BACKWARD_KERNEL) else "forward"


def kernel_of(name: str) -> Optional[str]:
    """The GAS kernel a kernel-route contract launches on the card (in
    its ``kernel_pass``): none on the ``ref`` route; the banded walk where
    the run is scheduled (every ``/sched`` variant and
    ``_DEFAULT_SCHEDULED``), else the dense grid."""
    if CONTRACTS[name].impl != "kernel":
        return None
    if name.endswith("/sched") or name.startswith(_DEFAULT_SCHEDULED):
        return "gas_scatter_banded"
    return "gas_scatter_dense"


def _check_counts(name: str, tag: str, budget: Mapping[str, int],
                  run) -> List[str]:
    failures = []
    keys = list(COLLECTIVE_PRIMITIVES) + list(OUTSIDE_KEYS)
    keys += sorted(k for k in run.calls if k not in keys)
    for key in keys:
        want, got = int(budget.get(key, 0)), int(run.calls.get(key, 0))
        if want != got:
            failures.append(f"{name} [{tag}] collective {key}: "
                            f"budget {want}, counted {got}")
    for key in DISPATCH_KEYS:
        want, got = int(budget.get(key, 0)), int(run.dispatches[key])
        if want != got:
            failures.append(f"{name} [{tag}] dispatch {key}: "
                            f"budget {want}, counted {got}")
    return failures


def verify_contract(contract: DataflowContract, mesh,
                    launches: Optional[dict] = None) -> List[str]:
    """Run the entry point on this rank of ``mesh`` and check each pass
    against its budget and the dtype rules. Returns failure strings
    (empty = the contract holds), each naming the contract, the pass
    (``forward`` / ``fwd+bwd``) and the key with budget and count.
    ``launches``, when given, receives the GAS kernels' launch counts of
    each pass (``{tag: {kernel: n}}``; zero on the CPU)."""
    from repro_torch.kernels.gas_scatter import kernel as K

    failures: List[str] = []
    for tag, budget in (("forward", contract.forward),
                        ("fwd+bwd", contract.fwd_bwd)):
        if budget is None:
            continue
        try:
            fn, args = contract.build(mesh)
            K.reset_launch_counts()
            run = count_run(fn, *args, fwd_bwd=tag == "fwd+bwd")
        except Exception as e:  # noqa: BLE001 — a run that fails is itself
            failures.append(f"{contract.name} [{tag}] failed to run: {e!r}"
                            f"\n{traceback.format_exc()}")
            continue            # a contract violation, not a crash
        if launches is not None:
            launches[tag] = K.launch_counts()
        failures += _check_counts(contract.name, tag, budget, run)
        for issue in check_dtype_flow(run, waive=contract.dtype_waivers):
            failures.append(f"{contract.name} [{tag}] dtype {issue}")
    return failures


def verify_rank(mesh, names: Optional[Sequence[str]] = None) -> dict:
    """One rank's check of every registered contract (or ``names``):
    ``{"failures": {name: [...]}, "launches": {name: {tag: counts}}}``.
    Every rank of ``mesh`` calls it with the same ``names``."""
    failures, launches = {}, {}
    for name in (names if names is not None else CONTRACTS):
        launches[name] = {}
        fails = verify_contract(CONTRACTS[name], mesh, launches[name])
        if fails:
            failures[name] = fails
    return {"failures": failures, "launches": launches}


def merge_ranks(results: Sequence[dict]) -> Dict[str, List[str]]:
    """name → the failures any rank reported, each line once."""
    out: Dict[str, List[str]] = {}
    for res in results:
        for name, fails in res["failures"].items():
            have = out.setdefault(name, [])
            have.extend(f for f in fails if f not in have)
    return out


def verify_all(names: Optional[Sequence[str]] = None, *,
               device: DeviceLike = "cuda", timeout_s: float = 900
               ) -> Dict[str, List[str]]:
    """Verify every registered contract (or ``names``) on ``WAYS`` gloo
    ranks on ``device`` (ranks share one card, or run on the CPU with
    ``device="cpu"``); returns name → failures for the ones that failed."""
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import spawn

    dev = resolve_device(device)
    results = spawn(verify_rank, WAYS, backend="gloo", device=str(dev),
                    timeout_s=timeout_s,
                    args=(None if names is None else list(names),))
    return merge_ranks(results)


# ---------------------------------------------------------------------------
# argument builders: the JAX registry's shapes, inputs from a numpy seed,
# each rank holding its [rank:rank + 1] slice
# ---------------------------------------------------------------------------

WAYS = 8                  # the data mesh every sharded budget uses
_PART, _F = 32, 64
_B, _K1, _K2 = 8, 3, 10
_R1 = _B * (1 + _K1)      # rows of the sage-shaped 2-hop block
#: static packed width of the sparse fixtures: 16 + 2 bitmap words < F=64,
#: so ``sparse_fits`` passes and the sparse path runs
_SPARSE_CAP = 16
_SEED = 0


def _mine(mesh, x: np.ndarray):
    import torch
    return torch.from_numpy(np.ascontiguousarray(
        x[mesh.rank:mesh.rank + 1])).to(mesh.device)


def _table(rng, F: int = _F, sparse: bool = False) -> np.ndarray:
    """A (WAYS, part, F) integer-valued table; ``sparse`` keeps at most
    ``_SPARSE_CAP`` nonzeros per row, within the packed capacity."""
    x = rng.integers(-4, 5, (WAYS, _PART, F)).astype(np.float32)
    if sparse:
        keep = rng.random(x.shape).argsort(-1) < _SPARSE_CAP
        x = np.where(keep, x, 0.0).astype(np.float32)
    return x


def _block(rng, R: int, K: int):
    return (rng.integers(0, WAYS * _PART, (WAYS, R, K)).astype(np.int32),
            rng.random((WAYS, R, K)) < 0.8)


def _fetch_world(features: str = "dense"):
    """The sage-shaped request pair: the K=1 self-lookup and the fan-out
    2-hop block (the pair ``sage_forward`` coalesces)."""
    rng = np.random.default_rng(_SEED)
    return (_table(rng, sparse=features == "sparse"), _block(rng, _R1, 1),
            _block(rng, _R1, _K2))


def _cap(features: str):
    return _SPARSE_CAP if features == "sparse" else None


def _build_sampled(flow: str, impl: str, scheduled: bool, wire: str = "f32",
                   features: str = "dense"):
    def build(mesh):
        from repro_torch.core import cgtrans
        feats, _, (nb2, mk2) = _fetch_world(features)

        def fn(f, nb, mk):
            return cgtrans.aggregate_sampled(
                f, nb, mk, mesh=mesh, dataflow=flow, impl=IMPLS[impl],
                scheduled=scheduled, wire=wire, features=features,
                sparse_capacity=_cap(features))
        return fn, (_mine(mesh, feats), _mine(mesh, nb2), _mine(mesh, mk2))
    return build


def _build_multi(flow: str, impl: str, scheduled: bool, wire: str = "f32",
                 features: str = "dense"):
    def build(mesh):
        from repro_torch.core import cgtrans
        feats, b1, b2 = _fetch_world(features)

        def fn(f, blocks):
            return cgtrans.aggregate_multi(
                f, blocks, mesh=mesh, dataflow=flow, impl=IMPLS[impl],
                scheduled=scheduled, wire=wire, features=features,
                sparse_capacity=_cap(features))
        return fn, (_mine(mesh, feats),
                    tuple((_mine(mesh, n), _mine(mesh, m)) for n, m in
                          (b1, b2)))
    return build


def _build_separate_fetch(flow: str, impl: str):
    """The un-coalesced twin of ``_build_multi``: the same request pair as
    two ``aggregate_sampled`` streams (scheduled as the route defaults)."""
    def build(mesh):
        from repro_torch.core import cgtrans
        feats, b1, b2 = _fetch_world()

        def fn(f, blocks):
            (nb1, mk1), (nb2, mk2) = blocks
            return (cgtrans.aggregate_sampled(f, nb1, mk1, mesh=mesh,
                                              dataflow=flow,
                                              impl=IMPLS[impl]),
                    cgtrans.aggregate_sampled(f, nb2, mk2, mesh=mesh,
                                              dataflow=flow,
                                              impl=IMPLS[impl]))
        return fn, (_mine(mesh, feats),
                    tuple((_mine(mesh, n), _mine(mesh, m)) for n, m in
                          (b1, b2)))
    return build


def _serve_world(n_requests: int):
    """The serving drain: ``n_requests`` single-seed callers, each a K=1
    self-row lookup segment and a fan-out segment, one row per rank (the
    layout ``ServingEngine._build_blocks`` makes)."""
    rng = np.random.default_rng(_SEED)
    feats = _table(rng)
    blocks = []
    for _ in range(n_requests):
        blocks += [_block(rng, 1, 1), _block(rng, 1, _K2)]
    return feats, blocks


def _build_serving(impl: str, n_requests: int, fused: bool,
                   wire: str = "f32"):
    def build(mesh):
        from repro_torch.core import cgtrans
        feats, blocks = _serve_world(n_requests)

        def fn(f, blocks_):
            if fused:
                return cgtrans.aggregate_multi(
                    f, blocks_, mesh=mesh, dataflow="cgtrans",
                    impl=IMPLS[impl], wire=wire)
            outs = []       # the one-query-one-dispatch twin
            for j in range(n_requests):
                outs.extend(cgtrans.aggregate_multi(
                    f, blocks_[2 * j:2 * j + 2], mesh=mesh,
                    dataflow="cgtrans", impl=IMPLS[impl]))
            return tuple(outs)
        return fn, (_mine(mesh, feats),
                    tuple((_mine(mesh, n), _mine(mesh, m))
                          for n, m in blocks))
    return build


def _sage_world(impl: str, coalesce: bool, scheduled: bool, mesh):
    from repro_torch.common.schema import init_params
    from repro_torch.core.gcn import GCNConfig, gcn_schema
    B, K1, K2, F = 4, 3, 5, 16
    cfg = GCNConfig(n_features=F, hidden=8, n_classes=4, fanout=K2,
                    impl=IMPLS[impl], coalesce=coalesce, scheduled=scheduled)
    params = init_params(gcn_schema(cfg), _SEED, device=mesh.device)
    rng = np.random.default_rng(_SEED)
    V = WAYS * _PART
    feats = rng.integers(-4, 5, (WAYS, _PART, F)).astype(np.float32)
    batch = {
        "seeds": rng.integers(0, V, (WAYS, B)).astype(np.int32),
        "nbrs1": rng.integers(0, V, (WAYS, B, K1)).astype(np.int32),
        "mask1": rng.random((WAYS, B, K1)) < 0.8,
        "nbrs2": rng.integers(0, V, (WAYS, B * (1 + K1), K2)).astype(
            np.int32),
        "mask2": rng.random((WAYS, B * (1 + K1), K2)) < 0.8,
        "labels": rng.integers(0, 4, (WAYS, B)).astype(np.int32),
    }
    return cfg, params, _mine(mesh, feats), {k: _mine(mesh, v)
                                             for k, v in batch.items()}


def _build_sage(impl: str, coalesce: bool, scheduled: bool):
    def build(mesh):
        from repro_torch.core.gcn import sage_forward
        cfg, params, feats, batch = _sage_world(impl, coalesce, scheduled,
                                                mesh)
        batch.pop("labels")

        def fn(p, f, b):
            return sage_forward(p, f, b, cfg, mesh=mesh)
        return fn, (params, feats, batch)
    return build


def _build_train_step(impl: str, coalesce: bool, scheduled: bool):
    def build(mesh):
        import torch

        from repro_torch.common.config import TrainConfig
        from repro_torch.optim import adamw_init
        from repro_torch.train import make_sage_train_step
        cfg, params, feats, batch = _sage_world(impl, coalesce, scheduled,
                                                mesh)
        tc = TrainConfig(learning_rate=1e-3)
        state = {"params": params, "opt": adamw_init(params, tc),
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=mesh.device)}
        step = make_sage_train_step(cfg, tc, feats=feats, mesh=mesh)
        return step, (state, batch)
    return build


def _build_embed(cgtrans: bool, impl: str):
    """The JAX registry's lookup: a (64, 16) f32 table over a 2 × 4
    (data × model) mesh of the same ranks (vocab 16 per model rank), (4,
    8) ids split over data; each rank passes its vocab shard and its rows,
    as the lookup's ``shard_map`` body sees them."""
    def build(mesh):
        import torch
        from repro_torch.common.logical import local_block
        from repro_torch.models.embedding import embed_lookup
        m = _test_mesh(mesh)
        rng = np.random.default_rng(_SEED)
        table = rng.standard_normal((64, 16)).astype(np.float32)
        ids = rng.integers(0, 64, (4, 8)).astype(np.int32)
        tab = torch.from_numpy(np.ascontiguousarray(
            local_block(table, ("model", None), m))).to(m.device)
        mine = torch.from_numpy(np.ascontiguousarray(
            local_block(ids, ("data", None), m))).to(m.device)

        def fn(t, i):
            return embed_lookup(t, i, mesh=m, cgtrans=cgtrans, impl=impl)
        return fn, (tab, mine)
    return build


def _test_mesh(mesh):
    """The JAX registry's ``make_test_mesh(2, 4)`` over the ``WAYS`` ranks
    of ``mesh``."""
    return mesh.named((2, 4), ("data", "model"))


def _build_edges(flow: str, impl: str, op: str, wire: str = "f32",
                 features: str = "dense"):
    def build(mesh):
        from repro_torch.core import cgtrans
        E = 512
        rng = np.random.default_rng(_SEED)
        arrays = (_table(rng, sparse=features == "sparse"),
                  rng.integers(0, _PART, (WAYS, E)).astype(np.int32),
                  rng.integers(0, WAYS * _PART, (WAYS, E)).astype(np.int32),
                  rng.random((WAYS, E)).astype(np.float32),
                  rng.random((WAYS, E)) < 0.9)

        def fn(f, src, dst, w, m):
            return cgtrans.aggregate_edges(
                f, src, dst, w, m, mesh=mesh, dataflow=flow,
                impl=IMPLS[impl], op=op, wire=wire, features=features,
                sparse_capacity=_cap(features))
        return fn, tuple(_mine(mesh, a) for a in arrays)
    return build


# ---------------------------------------------------------------------------
# the registry: dataflow × impl × coalesce × scheduled, names as JAX's
# ---------------------------------------------------------------------------

CONTRACTS: Dict[str, DataflowContract] = {}


def _register(c: DataflowContract):
    if c.name in CONTRACTS:
        raise ValueError(f"duplicate contract {c.name}")
    CONTRACTS[c.name] = c


def _fwd_bwd(xla_table: Mapping[str, int], pallas_table: Mapping[str, int],
             impl: str) -> Dict[str, int]:
    """The forward + backward budget of a route: the xla table, or on the
    kernel route the xla table's collectives with the pallas table's
    dispatches (``budgets.held``)."""
    return budgets.held(xla_table, pallas_table if impl == "pallas" else None)


_SCHED_NOTE = ("scheduled is collective- and dispatch-neutral: the banded "
               "walk reorders kernel rounds, never traffic")

# -- aggregate_sampled: one fan-out-K request stream -------------------------
for _flow in ("cgtrans", "baseline"):
    for _impl in ("xla", "pallas"):
        _ks = {"kernel_scatter": 1} if _impl == "pallas" else {}
        for _sched in ((False, True) if _impl == "pallas" else (False,)):
            _register(DataflowContract(
                name=(f"aggregate_sampled/{_flow}/{_impl}"
                      + ("/sched" if _sched else "")),
                build=_build_sampled(_flow, _impl, _sched),
                forward=merge(budgets.SAMPLED_FWD[_flow], _ks),
                fwd_bwd=None if _sched else _fwd_bwd(
                    budgets.SAMPLED_BWD[_flow],
                    budgets.SAMPLED_BWD_PALLAS[_flow], _impl),
                note=_SCHED_NOTE if _sched else ""))

# -- aggregate_multi: the coalesced SSD command block ------------------------
for _flow in ("cgtrans", "baseline"):
    for _impl in ("xla", "pallas"):
        _ks1 = {"kernel_scatter": 1 if _flow == "cgtrans" else 2} \
            if _impl == "pallas" else {}
        for _sched in ((False, True) if _impl == "pallas" else (False,)):
            _register(DataflowContract(
                name=(f"aggregate_multi/{_flow}/{_impl}"
                      + ("/sched" if _sched else "")),
                build=_build_multi(_flow, _impl, _sched),
                forward=merge(budgets.MULTI_FWD[_flow], _ks1),
                fwd_bwd=None if _sched else _fwd_bwd(
                    budgets.MULTI_BWD[_flow],
                    budgets.MULTI_BWD_PALLAS[_flow], _impl),
                note=_SCHED_NOTE if _sched else ""))
        _register(DataflowContract(
            name=f"separate_fetch/{_flow}/{_impl}",
            build=_build_separate_fetch(_flow, _impl),
            forward=merge(budgets.SEPARATE_FWD[_flow], _ks1),
            note="the un-coalesced twin of aggregate_multi — the pair pins "
                 "the 2 → 1 coalescing claim as two committed budgets"))

# -- serving_fetch: the cross-request fused drain ----------------------------
_N = budgets.SERVE_CONTRACT_N
for _impl in ("xla", "pallas"):
    _ksN = {"kernel_scatter": _N} if _impl == "pallas" else {}
    _register(DataflowContract(
        name=f"serving_fetch/fused/{_impl}",
        build=_build_serving(_impl, _N, fused=True),
        forward=merge(budgets.SERVE_FETCH_COLLECTIVES["fused"],
                      {"find": budgets.SERVE_FETCH_FINDS["fused"],
                       "reduce": _N}, _ksN),
        note=f"one drain of N={_N} tenant-tagged request pairs — the "
             f"collective pair is N-independent"))
    _register(DataflowContract(
        name=f"serving_fetch/naive/{_impl}",
        build=_build_serving(_impl, _N, fused=False),
        forward=merge(
            {k: v * _N for k, v in
             budgets.SERVE_FETCH_COLLECTIVES["naive_per_query"].items()},
            {"find": budgets.SERVE_FETCH_FINDS["naive_per_query"] * _N,
             "reduce": _N}, _ksN),
        note="the one-query-one-dispatch twin: every caller pays the full "
             "collective pair"))

# -- sage_forward: the deployed 2-layer fetch --------------------------------
for _coal in (True, False):
    _form = "coalesced" if _coal else "separate"
    for _impl in ("xla", "pallas"):
        # only the fan-out segment scatters forward (the K=1 self-lookup is
        # a pure find), so both forms pay one kernel scatter
        _ks = {"kernel_scatter": 1} if _impl == "pallas" else {}
        for _sched in ((False, True) if _impl == "pallas" else (False,)):
            _register(DataflowContract(
                name=(f"sage_forward/{_form}/{_impl}"
                      + ("/sched" if _sched else "")),
                build=_build_sage(_impl, _coal, _sched),
                forward=merge(budgets.SAGE_FWD[_coal], _ks),
                # grad w.r.t. the params: the backward re-ships nothing
                fwd_bwd=None if _sched else merge(budgets.SAGE_FWD[_coal],
                                                  _ks)))

# -- make_sage_train_step: the full step (grad + AdamW inside) ---------------
_OUTSIDE_STEP = {"grad_all_reduce": budgets.GRAD_ALL_REDUCE_PER_STEP,
                 "metric_all_reduce": budgets.METRIC_ALL_REDUCE_PER_STEP}
for _coal in (True, False):
    _form = "coalesced" if _coal else "separate"
    for _impl in ("xla", "pallas"):
        for _sched in ((False, True) if _impl == "pallas" else (False,)):
            _register(DataflowContract(
                name=(f"train_step/{_form}/{_impl}"
                      + ("/sched" if _sched else "")),
                build=_build_train_step(_impl, _coal, _sched),
                forward=merge(budgets.TRAIN[(_coal, _impl)], _OUTSIDE_STEP),
                note="grad w.r.t. params only — feats is closed over, so "
                     "the backward re-ships nothing; the gradient and "
                     "metric all-reduces are GSPMD's in the JAX step"))

# -- embed_lookup: the model-axis storage tier --------------------------------
_register(DataflowContract(
    name="embed_lookup/cgtrans/xla",
    build=_build_embed(True, "ref"),
    forward=budgets.EMBED_FWD["cgtrans"],
    fwd_bwd=budgets.EMBED_BWD["cgtrans"],
    dtype_waivers=("accum", "narrow-wire"),
    note="bf16 transport by design (compute_dtype=bfloat16): the psum of "
         "bf16 partials is the compressed-wire precursor the ROADMAP "
         "tracks — transport narrow, accumulate-at-owner; waiver documents "
         "it instead of hiding it"))
_register(DataflowContract(
    name="embed_lookup/cgtrans/pallas",
    build=_build_embed(True, "kernel"),
    forward=budgets.EMBED_FWD["cgtrans"],
    fwd_bwd=budgets.EMBED_BWD_PALLAS["cgtrans"],
    dtype_waivers=("accum", "narrow-wire"),
    note="same bf16-transport waiver; the VJP GAS-scatters the cotangent "
         "at the owner shard through the FAST-GAS kernel"))
_register(DataflowContract(
    name="embed_lookup/baseline/xla",
    build=_build_embed(False, "ref"),
    forward=budgets.EMBED_FWD["baseline"],
    dtype_waivers=("accum",),
    note="plain take on the whole table: the JAX jaxpr carries zero "
         "explicit collectives (GSPMD moves the table when it compiles); "
         "the port gathers the vocab shards itself, counted as "
         "table_gather (budgets.EMBED_FWD)"))

# -- aggregate_edges: the full-graph COO dataflow ----------------------------
for _flow in ("cgtrans", "baseline"):
    for _op in ("add", "max"):
        for _impl in ("xla", "pallas"):
            _ks = {"kernel_scatter": 1} if _impl == "pallas" else {}
            _register(DataflowContract(
                name=f"aggregate_edges/{_flow}/{_op}/{_impl}",
                build=_build_edges(_flow, _impl, _op),
                forward=merge(budgets.EDGES_FWD[(_flow, _op)], _ks)))

# -- compressed wire variants (core/wire.py) ---------------------------------
_WIRE_NOTE = ("narrow transport by design (core/wire.py): int16 delta ids "
              "on the all_gather, {w} partials on the all_to_all, f32 "
              "accumulation on arrival — same budget as the f32 twin")
for _w in ("bf16", "int8"):
    _register(DataflowContract(
        name=f"aggregate_sampled/cgtrans/xla/{_w}",
        build=_build_sampled("cgtrans", "xla", False, wire=_w),
        forward=budgets.SAMPLED_FWD["cgtrans"],
        fwd_bwd=budgets.SAMPLED_BWD["cgtrans"],
        dtype_waivers=("narrow-wire",),
        note=_WIRE_NOTE.format(w=_w)))
    _register(DataflowContract(
        name=f"aggregate_multi/cgtrans/xla/{_w}",
        build=_build_multi("cgtrans", "xla", False, wire=_w),
        forward=budgets.MULTI_FWD["cgtrans"],
        fwd_bwd=budgets.MULTI_BWD["cgtrans"],
        dtype_waivers=("narrow-wire",),
        note=_WIRE_NOTE.format(w=_w)))
    _register(DataflowContract(
        name=f"aggregate_edges/cgtrans/add/xla/{_w}",
        build=_build_edges("cgtrans", "xla", "add", wire=_w),
        forward=budgets.EDGES_FWD_NARROW_ADD,
        dtype_waivers=("narrow-wire",),
        note="the one budget a narrow wire changes: quantized partials "
             "cannot sum on the wire, so psum_scatter 1→0 / all_to_all "
             "0→1 with local f32 accumulation"))
_register(DataflowContract(
    name="aggregate_multi/cgtrans/pallas/bf16",
    build=_build_multi("cgtrans", "pallas", False, wire="bf16"),
    forward=merge(budgets.MULTI_FWD["cgtrans"], {"kernel_scatter": 1}),
    fwd_bwd=_fwd_bwd(budgets.MULTI_BWD["cgtrans"],
                     budgets.MULTI_BWD_PALLAS["cgtrans"], "pallas"),
    dtype_waivers=("narrow-wire",),
    note="the kernel path under the narrow wire: the codec wraps the "
         "collective only, so the FAST-GAS dispatch budget is untouched"))
_register(DataflowContract(
    name="serving_fetch/fused/xla/bf16",
    build=_build_serving("xla", _N, fused=True, wire="bf16"),
    forward=merge(budgets.SERVE_FETCH_COLLECTIVES["fused"],
                  {"find": budgets.SERVE_FETCH_FINDS["fused"],
                   "reduce": _N}),
    dtype_waivers=("narrow-wire",),
    note=f"the serving drain on the bf16 wire: N={_N} fused callers, the "
         f"collective pair still N-independent, bytes halved"))

# -- compressed-sparse feature variants (core/sparse.py) ---------------------
_SPARSE_NOTE = ("compressed-sparse features by design (core/sparse.py): "
                "packed nonzeros + int32 occupancy bitmap on the {leg}, "
                "static capacity {cap} of F={f} — same budget as the dense "
                "twin")
_register(DataflowContract(
    name="aggregate_sampled/cgtrans/xla/sparse",
    build=_build_sampled("cgtrans", "xla", False, features="sparse"),
    forward=budgets.SAMPLED_FWD["cgtrans"],
    fwd_bwd=budgets.SAMPLED_BWD["cgtrans"],
    note=_SPARSE_NOTE.format(leg="table gather", cap=_SPARSE_CAP, f=_F)))
_register(DataflowContract(
    name="aggregate_sampled/cgtrans/pallas/sparse",
    build=_build_sampled("cgtrans", "pallas", False, features="sparse"),
    forward=merge(budgets.SAMPLED_FWD["cgtrans"], {"kernel_scatter": 1}),
    fwd_bwd=_fwd_bwd(budgets.SAMPLED_BWD["cgtrans"],
                     budgets.SAMPLED_BWD_PALLAS["cgtrans"], "pallas"),
    note=_SPARSE_NOTE.format(leg="table gather", cap=_SPARSE_CAP, f=_F)))
_register(DataflowContract(
    name="aggregate_sampled/baseline/xla/sparse",
    build=_build_sampled("baseline", "xla", False, features="sparse"),
    forward=budgets.SAMPLED_FWD["baseline"],
    fwd_bwd=budgets.SAMPLED_BWD["baseline"],
    note=_SPARSE_NOTE.format(leg="table gather and the raw-row all_to_all",
                             cap=_SPARSE_CAP, f=_F)))
_register(DataflowContract(
    name="aggregate_multi/cgtrans/xla/sparse",
    build=_build_multi("cgtrans", "xla", False, features="sparse"),
    forward=budgets.MULTI_FWD["cgtrans"],
    fwd_bwd=budgets.MULTI_BWD["cgtrans"],
    note=_SPARSE_NOTE.format(leg="combined table gather", cap=_SPARSE_CAP,
                             f=_F)))
_register(DataflowContract(
    name="aggregate_edges/cgtrans/add/xla/sparse",
    build=_build_edges("cgtrans", "xla", "add", features="sparse"),
    forward=budgets.EDGES_FWD_SPARSE_ADD,
    note=_SPARSE_NOTE.format(leg="edge-source gather", cap=_SPARSE_CAP,
                             f=_F)
    + "; partials have union support, so the psum_scatter stays dense"))
_register(DataflowContract(
    name="aggregate_sampled/baseline/xla/sparse-bf16",
    build=_build_sampled("baseline", "xla", False, wire="bf16",
                         features="sparse"),
    forward=budgets.SAMPLED_FWD["baseline"],
    fwd_bwd=budgets.SAMPLED_BWD["baseline"],
    dtype_waivers=("narrow-wire",),
    note="baseline + narrow wire is only legal with sparse features "
         "(packed nonzeros quantize like partials), still the dense twin's "
         "budget"))


def covered_configurations() -> List[str]:
    """Every registered (entry point, dataflow or form, impl, ...) name."""
    return sorted(CONTRACTS)


def chunked(budget: Mapping[str, int], n_segments: int,
            dataflow: str = "cgtrans") -> Dict[str, int]:
    """``budget`` for a run whose command block streams in chunks: each of
    its ``n_segments`` segments is its own command queue, with its own
    collectives (``budgets.chunked_fetch_collectives``) and its own find."""
    out = dict(budget)
    out.update(budgets.chunked_fetch_collectives(n_segments, dataflow),
               find=n_segments)
    return out
