"""The paper's primary contribution:

* ``gas``         — the gather-and-scatter engine primitives
* ``cgtrans``     — the CGTrans dataflows, unsharded and sharded
* ``collectives`` — the sharded dataflows' counted collectives
* ``gcn``         — full-graph GCN and minibatch GraphSAGE on it
* ``algorithms``  — BFS / SSSP / CC / sort as GAS find-and-compute loops
* ``cost_model``  — the paper's Table I/II-calibrated latency, bytes and
                    area model (Figures 14–16)
"""

from repro_torch.core import (algorithms, cgtrans, collectives, cost_model,
                              gas, gcn)

__all__ = ["algorithms", "cgtrans", "collectives", "cost_model", "gas",
           "gcn"]
