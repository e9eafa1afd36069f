from repro_torch.kernels.gas_scatter import kernel, ops, ref
from repro_torch.kernels.gas_scatter.ops import (EdgeSchedule,
                                                 count_dispatches,
                                                 dense_skip_stats,
                                                 feat_skip_stats,
                                                 gas_scatter,
                                                 gas_scatter_fused,
                                                 occupancy_map,
                                                 schedule_edges,
                                                 schedule_skip_stats)
from repro_torch.kernels.gas_scatter.ref import (gas_scatter_ref,
                                                 gas_scatter_weighted_ref)

__all__ = ["EdgeSchedule", "count_dispatches", "dense_skip_stats",
           "feat_skip_stats", "gas_scatter", "gas_scatter_fused",
           "gas_scatter_ref", "gas_scatter_weighted_ref", "kernel",
           "occupancy_map", "ops", "ref", "schedule_edges",
           "schedule_skip_stats"]
