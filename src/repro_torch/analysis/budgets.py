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


#: GAS finds of the same pair: one combined table gather per drain of any
#: N; the naive baseline one per query
SERVE_FETCH_FINDS: Dict[str, int] = {"fused": 1, "naive_per_query": 1}

#: concurrency of the serving contracts and the counted serving rows
SERVE_CONTRACT_N = 8


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

#: the un-coalesced twin of aggregate_multi: the same pair as two
#: aggregate_sampled streams
SEPARATE_FWD = {
    "cgtrans": merge(SAGE_FETCH_COLLECTIVES["separate"],
                     SAGE_FETCH_DISPATCH["separate"]),
    "baseline": {"all_gather": 2, "all_to_all": 4, "find": 2, "reduce": 2},
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

# -- aggregate_edges: the full-graph COO dataflow ----------------------------
# cgtrans add rides the reduce-scatter; compare ops ship per-destination
# partials over all_to_all; baseline all-gathers the raw payload, its dst
# and its mask (3 all_gathers). The pallas rows add one kernel_scatter.
EDGES_FWD = {
    ("cgtrans", "add"): {"psum_scatter": 1, "find": 1, "reduce": 1},
    ("cgtrans", "max"): {"all_to_all": 1, "find": 1, "reduce": 1},
    ("baseline", "add"): {"all_gather": 3, "find": 1, "reduce": 1},
    ("baseline", "max"): {"all_gather": 3, "find": 1, "reduce": 1},
}
#: the one budget a narrow wire changes (``aggregate_edges/cgtrans/add/
#: xla/{bf16,int8}``): quantized partials cannot sum on the wire, so
#: psum_scatter 1→0 and all_to_all 0→1, with f32 accumulation on arrival
EDGES_FWD_NARROW_ADD = {"all_to_all": 1, "find": 1, "reduce": 1}
#: ``aggregate_edges/cgtrans/add/xla/sparse``: the packed gather is the same
#: one find, and partials (union support) ship dense, so add keeps its
#: dense twin's budget
EDGES_FWD_SPARSE_ADD = EDGES_FWD[("cgtrans", "add")]

#: forward + backward (gradient in the table and the edge weights), which
#: the JAX package budgets nowhere: each collective that carries a
#: cotangent adds its transpose — psum_scatter's is an all_gather,
#: all_to_all's an all_to_all, the raw payload's all_gather a psum_scatter
#: (the integer dst and mask streams carry none). Held against the JAX
#: package's own grad program (``tests/test_torch_dist_edges.py``).
EDGES_BWD = {
    ("cgtrans", "add"): {"psum_scatter": 1, "all_gather": 1},
    ("cgtrans", "max"): {"all_to_all": 2},
    ("baseline", "add"): {"all_gather": 3, "psum_scatter": 1},
    ("baseline", "max"): {"all_gather": 3, "psum_scatter": 1},
}
EDGES_BWD_NARROW_ADD = {"all_to_all": 2}


def edges_forward(dataflow: str, op: str, impl: str, wire: str = "f32"
                  ) -> Dict[str, int]:
    """The forward budget of ``aggregate_edges`` on a mesh: the reference
    row of (dataflow, op) (min and or share max's), the narrow-wire row
    for cgtrans add, and one kernel scatter on the kernel route."""
    key = (dataflow, "add" if op == "add" else "max")
    row = (EDGES_FWD_NARROW_ADD if key == ("cgtrans", "add")
           and wire != "f32" else EDGES_FWD[key])
    return merge(row, {"kernel_scatter": 1} if impl == "kernel" else {})


def edges_bytes(dataflow: str, wire: str, n: int, part: int, F: int,
                e_local: int) -> int:
    """Collective bytes per rank of one ``aggregate_edges`` forward on an
    n-rank mesh (``max(input, output)`` per collective, as the JAX
    package's HLO count takes them): cgtrans ships the (n, part, F)
    partial block — 4, 2 or F + 4 bytes per row and feature column on the
    f32, bf16 and int8 wires (any op); baseline all-gathers n × e_local
    edges of F f32 values, an int32 dst and a one-byte mask. Sparse
    features change the gather, not these bytes."""
    if dataflow == "baseline":
        return n * e_local * (4 * F + 4 + 1)
    per_row = {"f32": 4 * F, "bf16": 2 * F, "int8": F + 4}[wire]
    return n * part * per_row


#: ``gcn_forward_full(relabel=)`` on a mesh: the un-permute reads rows every
#: rank owns. The JAX program holds one all-reduce of the (P·part, C)
#: logits there (its compiled HLO on the reference's 8-device mesh); the
#: port all-gathers the same rows once per forward, counted as
#: ``relabel_gather``, with the same bytes (``relabel_gather_bytes``); its
#: backward is one ``psum_scatter``.
RELABEL_GATHER_PER_FORWARD = 1


def relabel_gather_bytes(n: int, part: int, C: int) -> int:
    """Bytes per rank of the un-permute's collective: the (n·part, C)
    float32 logits, as the reference's all-reduce moves them."""
    return n * part * C * 4


def gcn_full_forward(dataflow: str, op: str, impl: str, n_layers: int, *,
                     wire: str = "f32", relabel: bool = False
                     ) -> Dict[str, int]:
    """The forward budget of ``gcn_forward_full`` on a mesh: each layer's
    ``aggregate_edges`` (``edges_forward``), and with ``relabel=`` one
    ``relabel_gather``."""
    out = merge(*[edges_forward(dataflow, op, impl, wire)] * n_layers)
    if relabel:
        out = merge(out, {"relabel_gather": RELABEL_GATHER_PER_FORWARD})
    return out


# -- embed_lookup: the vocab table over model, ids over the batch axes -------
#: forward: the cgtrans lookup's one psum over model of the (B, S, D)
#: result; the baseline's one ``table_gather`` (the port's gather of the
#: vocab shards, which GSPMD inserts when it compiles the JAX program:
#: the JAX jaxpr holds no collective)
EMBED_FWD = {
    "cgtrans": {"psum": 1},
    "baseline": {"table_gather": 1},
}
#: forward + backward (gradient in the table): the psum's cotangent is the
#: cotangent, and the owner-scattered table gradient is summed over the
#: batch axes (one psum). On the kernel route the scatter is one FAST-GAS
#: dispatch (reduce + kernel_scatter). These psums are real, unlike the
#: sampled / multi pallas tables' (module docstring).
EMBED_BWD = {"cgtrans": {"psum": 2}}
EMBED_BWD_PALLAS = {"cgtrans": {"psum": 2, "reduce": 1,
                                "kernel_scatter": 1}}
TABLE_GATHER_PER_LOOKUP = 1


def table_gather_bytes(vocab: int, d: int, itemsize: int = 4) -> int:
    """Bytes per rank of the baseline lookup's ``table_gather``: the whole
    (V, D) table it assembles from the model axis's vocab shards."""
    return vocab * d * itemsize


#: collectives the JAX package issues outside its traced program, per
#: train step and per serving drain (keys of their own in the port)
GRAD_ALL_REDUCE_PER_STEP = 1
METRIC_ALL_REDUCE_PER_STEP = 1
RESULT_GATHER_PER_DRAIN = 1



def drain_bytes(n: int, ids: int, rows: int, F: int, itemsize: int,
                op: str) -> Dict[str, int]:
    """Collective bytes per rank of one cgtrans serving drain on an n-rank
    mesh and the unencoded (``"f32"``) wire, as ``count_collectives``
    counts them: the ``all_gather`` of each rank's ``ids`` int32 request
    ids, the ``all_to_all`` of the (n, rows, F [+ 1 count column for add])
    partials in the table's own ``itemsize``, and the ``result_gather`` of
    the (rows, F) answers. A bf16 table's partials and answers take half a
    float32 table's bytes."""
    cols = F + (1 if op == "add" else 0)
    return {"all_gather": n * ids * 4,
            "all_to_all": n * rows * cols * itemsize,
            "result_gather": n * rows * F * itemsize}


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
