from repro_torch.graph.partition import (IslandPartition, PartitionedGraph,
                                         interval_size, islandize,
                                         partition_by_src, partition_graph,
                                         relabel_graph,
                                         remote_destination_rows)
from repro_torch.graph.sampling import (device_sample, host_sample,
                                        host_sample_csr)
from repro_torch.graph.structure import COOGraph
from repro_torch.graph.synthetic import (TABLE_II, clustered_graph, rmat,
                                         table2_like, uniform_graph)

__all__ = [
    "IslandPartition", "PartitionedGraph", "interval_size", "islandize",
    "partition_by_src", "partition_graph", "relabel_graph",
    "remote_destination_rows",
    "device_sample", "host_sample", "host_sample_csr",
    "COOGraph", "TABLE_II", "clustered_graph", "rmat", "table2_like",
    "uniform_graph",
]
