"""The paper's own workload: GraphSAGE over Reddit-width graphs.

Fan-out 50 per the paper §4.2; the feature width 602 and 41 classes are
Reddit's (Table II). ``CONFIG`` runs the oracle backend; ``PALLAS_CONFIG``
is the deployment, named as in the JAX package: every aggregation through
the FAST-GAS kernels (``impl="kernel"``), a 16-row command queue, and the
destination-binned schedule (the banded walk). ``ISLAND_PALLAS_CONFIG``
adds the islandized vertex layout, and ``TABLE_II_GCN`` holds the feature
widths of the paper's Table II datasets.
"""

import dataclasses

from repro_torch.core.gcn import GCNConfig

# Reddit-like (the paper's end-to-end Fig 16(c) dataset)
CONFIG = GCNConfig(
    n_features=602,
    hidden=256,
    n_classes=41,      # Reddit's subreddit-classification arity
    fanout=50,
    aggregate="add",
    dataflow="cgtrans",
    n_layers=2,
    impl="ref",        # oracle backend
    request_chunk=None,
    coalesce=True,     # self-lookup + 2-hop requests ride ONE command block
    partition="interval",
)

# The deployed FAST-GAS configuration.
PALLAS_CONFIG = dataclasses.replace(CONFIG, impl="kernel", request_chunk=16,
                                    scheduled=True)

# The locality deployment: FAST-GAS kernels + islandized vertex layout.
# Callers partition with ``partition_graph(g, P, method="island")`` and hand
# the ``IslandPartition.relabel`` map to ``sage_forward`` /
# ``gcn_forward_full`` / ``make_sage_train_step``
# (``ServingEngine(partition="island")`` does all of this itself);
# bit for bit with PALLAS_CONFIG.
ISLAND_PALLAS_CONFIG = dataclasses.replace(PALLAS_CONFIG, partition="island")

# per-dataset feature widths (Table II)
TABLE_II_GCN = {
    "Reddit": CONFIG,
    "Movielens": GCNConfig(n_features=1000, hidden=256, n_classes=32, fanout=50),
    "Amazon": GCNConfig(n_features=32, hidden=256, n_classes=32, fanout=50),
    "OGBN-100M": GCNConfig(n_features=32, hidden=256, n_classes=172, fanout=50),
    "Protein-PI": GCNConfig(n_features=512, hidden=256, n_classes=16, fanout=50),
}
