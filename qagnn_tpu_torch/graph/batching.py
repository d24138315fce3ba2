"""Host-side batching of variable-length edge lists into fixed edge buckets.

Counterpart of qagnn_tpu/graph/batching.py (reference
modeling/modeling_qagnn.py:244-251 batch_graph): each graph's edges are
padded or truncated into a fixed per-graph budget chosen from a small set of
buckets, sorted by source node within each graph (stable), so that a split's
batches share one shape. Numpy does the packing; the result is a
BatchedGraphs of CPU tensors that the step functions copy to the device.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from qagnn_tpu_torch.graph.container import BatchedGraphs

# the largest covers CSQA's ~6k directed edges per subgraph after the inverse
# and context edges (reference utils/data_utils.py:103)
EDGE_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384)


def pick_edge_bucket(max_real_edges: int) -> int:
    """Smallest bucket that fits `max_real_edges` (else the largest bucket)."""
    for b in EDGE_BUCKETS:
        if max_real_edges <= b:
            return b
    return EDGE_BUCKETS[-1]


def batch_edge_lists(
    edge_indices: Sequence[np.ndarray],   # per graph (2, E_i) local node ids
    edge_types: Sequence[np.ndarray],     # per graph (E_i,)
    concept_ids: np.ndarray,              # (G, N)
    node_types: np.ndarray,               # (G, N)
    node_scores: np.ndarray,              # (G, N)
    num_nodes: np.ndarray,                # (G,)
    edges_per_graph: int | None = None,
) -> BatchedGraphs:
    """Pack per-graph COO edge lists into a BatchedGraphs of CPU tensors.

    Edges beyond the budget are truncated, keeping the low-index ones (in
    the reference layout the forward relations and context edges, before
    the appended inverses), with a warning: the reference never drops
    edges.
    """
    n_graphs = len(edge_indices)
    if not len(edge_types) == n_graphs == concept_ids.shape[0]:
        raise ValueError(f"{n_graphs} edge lists, {len(edge_types)} type "
                         f"lists, {concept_ids.shape[0]} graphs")

    if edges_per_graph is None:
        max_e = max((ei.shape[1] for ei in edge_indices), default=0)
        edges_per_graph = pick_edge_bucket(max_e)

    n_dropped = sum(max(0, ei.shape[1] - edges_per_graph)
                    for ei in edge_indices)
    if n_dropped:
        n_over = sum(ei.shape[1] > edges_per_graph for ei in edge_indices)
        warnings.warn(
            f"edge budget {edges_per_graph} truncates {n_dropped} edges "
            f"across {n_over}/{n_graphs} graphs (max real edge count "
            f"{max(ei.shape[1] for ei in edge_indices)}); results will "
            f"diverge from the reference, which never drops edges",
            stacklevel=2)

    src = np.zeros((n_graphs, edges_per_graph), dtype=np.int32)
    dst = np.zeros((n_graphs, edges_per_graph), dtype=np.int32)
    typ = np.zeros((n_graphs, edges_per_graph), dtype=np.int32)
    mask = np.zeros((n_graphs, edges_per_graph), dtype=bool)
    for g, (ei, et) in enumerate(zip(edge_indices, edge_types)):
        e = min(ei.shape[1], edges_per_graph)
        order = np.argsort(ei[0, :e], kind="stable")
        src[g, :e] = ei[0, :e][order]
        dst[g, :e] = ei[1, :e][order]
        typ[g, :e] = et[:e][order]
        mask[g, :e] = True

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype))

    return BatchedGraphs(
        concept_ids=t(concept_ids, np.int32),
        node_types=t(node_types, np.int32),
        node_scores=t(node_scores, np.float32),
        num_nodes=t(num_nodes, np.int32),
        edge_src=torch.from_numpy(src), edge_dst=torch.from_numpy(dst),
        edge_type=torch.from_numpy(typ), edge_mask=torch.from_numpy(mask))
