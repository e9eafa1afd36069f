from repro_torch.graph.sampling import host_sample_csr
from repro_torch.graph.structure import COOGraph
from repro_torch.graph.synthetic import clustered_graph, rmat, uniform_graph

__all__ = ["COOGraph", "clustered_graph", "host_sample_csr", "rmat",
           "uniform_graph"]
