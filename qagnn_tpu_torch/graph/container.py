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
    def n_graphs(self) -> int:
        return self.concept_ids.shape[0]

    @property
    def nodes_per_graph(self) -> int:
        return self.concept_ids.shape[1]

    @property
    def edges_per_graph(self) -> int:
        return self.edge_src.shape[1]

    @property
    def node_mask(self) -> torch.Tensor:
        """(G, N) bool: True for real (non-padding) nodes."""
        ar = torch.arange(self.nodes_per_graph, device=self.num_nodes.device)
        return ar[None, :] < self.num_nodes[:, None]

    # ---- flat views over the disjoint union of all graphs ---------------
    # node (g, n) gets the global index g * N + n, the reference's
    # batch_graph offsetting (modeling/modeling_qagnn.py:248)

    @property
    def total_nodes(self) -> int:
        return self.n_graphs * self.nodes_per_graph

    def _offsets(self) -> torch.Tensor:
        g = torch.arange(self.n_graphs, dtype=self.edge_src.dtype,
                         device=self.edge_src.device)
        return (g * self.nodes_per_graph)[:, None]

    @property
    def flat_edge_src(self) -> torch.Tensor:
        """(G*E,) global source indices."""
        return (self.edge_src + self._offsets()).reshape(-1)

    @property
    def flat_edge_dst(self) -> torch.Tensor:
        """(G*E,) global destination indices."""
        return (self.edge_dst + self._offsets()).reshape(-1)

    @property
    def flat_edge_type(self) -> torch.Tensor:
        return self.edge_type.reshape(-1)

    @property
    def flat_edge_mask(self) -> torch.Tensor:
        return self.edge_mask.reshape(-1)

    def real_edge_count(self) -> torch.Tensor:
        """Number of real edges in the batch (scalar int32)."""
        return self.edge_mask.sum(dtype=torch.int32)

    def to(self, device, non_blocking: bool = False) -> "BatchedGraphs":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device, non_blocking=non_blocking)
            for f in dataclasses.fields(self)})
