"""The paper's primary contribution, forward path:

* ``gas``     — the gather-and-scatter engine primitives
* ``cgtrans`` — the sampled CGTrans aggregation (unsharded)
* ``gcn``     — minibatch GraphSAGE on it
"""

from repro_torch.core import cgtrans, gas, gcn

__all__ = ["cgtrans", "gas", "gcn"]
