from repro_torch.data.pipeline import GraphBatchStream, synthetic_node_labels

__all__ = ["GraphBatchStream", "synthetic_node_labels"]
