"""BatchedGraphs: a batch of G subgraphs as fixed-shape tensors.

Counterpart of qagnn_tpu/graph/container.py. Every graph is padded to N nodes
and E edge slots; edges carry LOCAL node indices in [0, N) and a boolean mask
for padded slots. Self-loops are not stored: the model adds them analytically.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass
class BatchedGraphs:
    concept_ids: torch.Tensor   # (G, N) int32: 0 = context node, >=1 = entity id + 1
    node_types: torch.Tensor    # (G, N) int32: 0 q-entity, 1 a-entity, 2 other, 3 context
    node_scores: torch.Tensor   # (G, N) float32: LM relevance score per node
    num_nodes: torch.Tensor     # (G,) int32: real node count incl. context node
    edge_src: torch.Tensor      # (G, E) int32: local source node index
    edge_dst: torch.Tensor      # (G, E) int32: local destination node index
    edge_type: torch.Tensor     # (G, E) int32: relation id
    edge_mask: torch.Tensor     # (G, E) bool: False for padded edge slots

    @property
    def nodes_per_graph(self) -> int:
        return self.concept_ids.shape[1]

    @property
    def node_mask(self) -> torch.Tensor:
        """(G, N) bool: True for real (non-padding) nodes."""
        ar = torch.arange(self.nodes_per_graph, device=self.num_nodes.device)
        return ar[None, :] < self.num_nodes[:, None]

    def to(self, device, non_blocking: bool = False) -> "BatchedGraphs":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
            for f in dataclasses.fields(self)})
