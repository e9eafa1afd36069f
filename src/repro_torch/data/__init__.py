from repro_torch.data.pipeline import (GraphBatchStream, ShardedTokenFiles,
                                       TokenStream, synthetic_node_labels)

__all__ = ["GraphBatchStream", "ShardedTokenFiles", "TokenStream",
           "synthetic_node_labels"]
