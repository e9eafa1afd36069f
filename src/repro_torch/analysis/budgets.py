"""The sharded dataflows' static budgets: collectives and GAS dispatches.

A copy of the JAX package's tables (``repro.analysis.contracts``), as
constants: the counts a forward, a forward + backward (gradient in the
feature table) or a train step of each entry point issues on a ``data``
mesh of any size. Collective keys are the JAX primitive names
(``repro_torch.core.collectives.count_collectives``), dispatch keys those
of ``repro_torch.core.gas.count_dispatches``; an absent key means zero.
``xla`` / ``pallas`` are the JAX backends; the port's ``ref`` / ``kernel``
routes are held to them as ``held`` says.

**The psums of the pallas forward + backward tables.** ``SAMPLED_BWD_PALLAS``
and ``MULTI_BWD_PALLAS`` hold ``psum: 2`` (3 for the coalesced baseline),
which the xla tables, over the same math, do not. The grad jaxpr of
``aggregate_multi`` / ``aggregate_sampled`` with ``impl="pallas"`` on the
reference's own 8-device mesh, traced by the installed JAX, holds no
``psum`` at all (nor ``psum_invariant`` / ``pvary``): ``all_gather`` 1 and
``all_to_all`` 2, as the xla route; the reference's contract check itself
reports "budget 2, traced 0" for these rows. No cotangent of the dataflow
needs a cross-shard sum (each rank's table gradient is the scatter of
the cotangents that the backward ``all_to_all`` returned to it), so the
psums were an artefact of ``shard_map``'s transpose under
``check_vma=False`` in the JAX the tables were written against. The
port's kernel route is held to the xla table's collectives and the
pallas table's dispatches (``held``).
"""

from __future__ import annotations

from typing import Dict, Mapping

#: collectives per step of the sage-shaped fetch (K=1 self-lookup + 2-hop
#: block) on the cgtrans dataflow: two request streams vs one coalesced
#: ``aggregate_multi`` command block
SAGE_FETCH_COLLECTIVES: Dict[str, Dict[str, int]] = {
    "separate": {"all_gather": 2, "all_to_all": 2},
    "coalesced": {"all_gather": 1, "all_to_all": 1},
}

#: forward GAS dispatches of the same pair
SAGE_FETCH_DISPATCH: Dict[str, Dict[str, int]] = {
    "separate": {"find": 2, "reduce": 1},
    "coalesced": {"find": 1, "reduce": 1},
}

#: kernel scatters of the same pair per forward + backward
SAGE_FETCH_KERNEL_SCATTERS_FWD_BWD: Dict[str, int] = {
    "separate": 3, "coalesced": 2,
}

#: the serving drain: one fused command block per drain of any N requests,
#: the one-query-one-dispatch baseline the same pair per query
SERVE_FETCH_COLLECTIVES: Dict[str, Dict[str, int]] = {
    "fused": {"all_gather": 1, "all_to_all": 1},
    "naive_per_query": {"all_gather": 1, "all_to_all": 1},
}


def merge(*parts: Mapping[str, int]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0) + v
    return out


# -- aggregate_sampled: one fan-out-K request stream -------------------------
SAMPLED_FWD = {
    "cgtrans": {"all_gather": 1, "all_to_all": 1, "find": 1, "reduce": 1},
    "baseline": {"all_gather": 1, "all_to_all": 2, "find": 1, "reduce": 1},
}
SAMPLED_BWD = {       # fwd+bwd budgets, xla backend
    "cgtrans": {"all_gather": 1, "all_to_all": 2, "find": 1, "reduce": 1},
    "baseline": {"all_gather": 1, "all_to_all": 3, "find": 1, "reduce": 1},
}
SAMPLED_BWD_PALLAS = {
    "cgtrans": {"all_gather": 1, "all_to_all": 2, "psum": 2,
                "find": 1, "reduce": 2, "kernel_scatter": 2},
    "baseline": {"all_gather": 1, "all_to_all": 3, "psum": 2,
                 "find": 1, "reduce": 2, "kernel_scatter": 2},
}

# -- aggregate_multi: the coalesced command block ----------------------------
MULTI_FWD = {
    "cgtrans": merge(SAGE_FETCH_COLLECTIVES["coalesced"],
                     SAGE_FETCH_DISPATCH["coalesced"]),
    "baseline": {"all_gather": 1, "all_to_all": 2, "find": 1, "reduce": 2},
}
MULTI_BWD = {          # fwd+bwd, xla: forward collectives + cotangent a2a
    "cgtrans": {"all_gather": 1, "all_to_all": 2, "find": 1, "reduce": 1},
    "baseline": {"all_gather": 1, "all_to_all": 3, "find": 1, "reduce": 2},
}
MULTI_BWD_PALLAS = {
    "cgtrans": merge({"all_gather": 1, "all_to_all": 2, "psum": 2},
                     {"find": 1, "reduce": 2},
                     {"kernel_scatter":
                      SAGE_FETCH_KERNEL_SCATTERS_FWD_BWD["coalesced"]}),
    "baseline": {"all_gather": 1, "all_to_all": 3, "psum": 3,
                 "find": 1, "reduce": 3, "kernel_scatter": 3},
}

# -- make_sage_train_step: grad in the PARAMS, feats closed over -------------
SAGE_FWD = {
    True: merge(SAGE_FETCH_COLLECTIVES["coalesced"],
                SAGE_FETCH_DISPATCH["coalesced"]),
    False: merge(SAGE_FETCH_COLLECTIVES["separate"],
                 SAGE_FETCH_DISPATCH["separate"]),
}
TRAIN = {
    (True, "xla"): SAGE_FWD[True],
    (False, "xla"): SAGE_FWD[False],
    (True, "pallas"): merge(SAGE_FWD[True], {"kernel_scatter": 1}),
    (False, "pallas"): merge(SAGE_FWD[False], {"kernel_scatter": 1}),
}

#: collectives the JAX package issues outside its traced program, per
#: train step and per serving drain (keys of their own in the port)
GRAD_ALL_REDUCE_PER_STEP = 1
RESULT_GATHER_PER_DRAIN = 1

COLLECTIVE_KEYS = ("all_gather", "all_to_all", "psum", "psum_scatter")
DISPATCH_KEYS = ("find", "reduce", "kernel_scatter")


def held(table: Mapping[str, int], pallas_table: Mapping[str, int] = None
         ) -> Dict[str, int]:
    """The budget a port route is held to: ``table``'s collectives (the
    xla table's, see the module docstring for the psums) and, for the
    kernel route, ``pallas_table``'s dispatches."""
    dispatch = table if pallas_table is None else pallas_table
    out = {k: v for k, v in table.items() if k in COLLECTIVE_KEYS}
    out.update({k: v for k, v in dispatch.items() if k in DISPATCH_KEYS})
    return out


def chunked_fetch_collectives(n_segments: int, dataflow: str = "cgtrans"
                              ) -> Dict[str, int]:
    """Collective call sites of a chunked command block: each segment
    streams as its own command queue, whose scan body holds one
    ``all_gather`` and the dataflow's ``all_to_all`` (two on baseline)."""
    return {"all_gather": n_segments,
            "all_to_all": n_segments * (2 if dataflow == "baseline" else 1)}
