"""The paper's own workload: GraphSAGE over Reddit-width graphs.

Fan-out 50 per the paper §4.2; the feature width 602 and 41 classes are
Reddit's (Table II). ``CONFIG`` runs the oracle backend; ``PALLAS_CONFIG``
is the deployment, named as in the JAX package: every aggregation through
the FAST-GAS kernels (``impl="kernel"``), a 16-row command queue, and the
destination-binned schedule (the banded walk).
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
