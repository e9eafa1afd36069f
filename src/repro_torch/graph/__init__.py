from repro_torch.graph.partition import (PartitionedGraph, interval_size,
                                         partition_by_src, partition_graph,
                                         remote_destination_rows)
from repro_torch.graph.sampling import host_sample_csr
from repro_torch.graph.structure import COOGraph
from repro_torch.graph.synthetic import clustered_graph, rmat, uniform_graph

__all__ = ["COOGraph", "PartitionedGraph", "clustered_graph",
           "host_sample_csr", "interval_size", "partition_by_src",
           "partition_graph", "remote_destination_rows", "rmat",
           "uniform_graph"]
