"""Fixed-shape batched-subgraph containers and host-side batching."""

from qagnn_tpu_torch.graph.batching import (
    EDGE_BUCKETS,
    batch_edge_lists,
    pick_edge_bucket,
)
from qagnn_tpu_torch.graph.container import BatchedGraphs

__all__ = ["BatchedGraphs", "batch_edge_lists", "pick_edge_bucket",
           "EDGE_BUCKETS"]
