"""The paper's primary contribution:

* ``gas``         — the gather-and-scatter engine primitives
* ``cgtrans``     — the sampled CGTrans aggregation, unsharded and sharded
* ``collectives`` — the sharded dataflows' counted collectives
* ``gcn``         — minibatch GraphSAGE on it
"""

from repro_torch.core import cgtrans, collectives, gas, gcn

__all__ = ["cgtrans", "collectives", "gas", "gcn"]
