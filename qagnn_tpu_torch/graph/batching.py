"""Host-side batching of variable-length edge lists into fixed edge buckets.

Counterpart of qagnn_tpu/graph/batching.py (reference
modeling/modeling_qagnn.py:244-251 batch_graph): each graph's edges are
padded or truncated into a fixed per-graph budget chosen from a small set of
buckets, sorted by source node within each graph (stable), so that a split's
batches share one shape. The packing runs in C++ (native/packer.cc, the
counterpart of the JAX package's `_pack_native`); the result is a
BatchedGraphs of CPU tensors over the packer's arrays, which the step
functions copy to the device. `_pack_plain` is the same packing in numpy,
the plain version the tests hold the packer against.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.native.build import load_packer

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

    src, dst, typ, mask = _pack_native(edge_indices, edge_types,
                                       edges_per_graph)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype))

    return BatchedGraphs(
        concept_ids=t(concept_ids, np.int32),
        node_types=t(node_types, np.int32),
        node_scores=t(node_scores, np.float32),
        num_nodes=t(num_nodes, np.int32),
        edge_src=torch.from_numpy(src), edge_dst=torch.from_numpy(dst),
        edge_type=torch.from_numpy(typ),
        edge_mask=torch.from_numpy(mask.view(np.bool_)))


def edge_rows(edge_indices, edge_types):
    """Per graph, its source, destination and relation rows as contiguous
    int32 arrays (the rows themselves where they are already that, as the
    graph cache's per-graph views are), and a (3, G) array of their
    addresses for the packer. Raises when a graph's arrays disagree."""
    rows = []
    for g, (ei, et) in enumerate(zip(edge_indices, edge_types)):
        if ei.ndim != 2 or ei.shape[0] != 2 or et.shape != (ei.shape[1],):
            raise ValueError(f"graph {g}: edge_index {ei.shape}, edge_type "
                             f"{et.shape}; need (2, E) and (E,)")
        rows.append([np.ascontiguousarray(a, np.int32)
                     for a in (ei[0], ei[1], et)])
    ptrs = np.array([[a.ctypes.data for a in r] for r in rows],
                    np.uintp).reshape(len(rows), 3).T.copy()
    return rows, ptrs


def _pack_native(edge_indices, edge_types, edges_per_graph):
    """(src, dst, type, mask) numpy arrays of shape (G, edges_per_graph),
    packed by native/packer.cc `pack_edges_rows`; the mask is uint8."""
    lib = load_packer()
    n_graphs = len(edge_indices)
    rows, ptrs = edge_rows(edge_indices, edge_types)   # alive for the call
    lengths = np.array([ei.shape[1] for ei in edge_indices], np.int64)
    out = [np.empty((n_graphs, edges_per_graph), dt)
           for dt in (np.int32, np.int32, np.int32, np.uint8)]
    bad = lib.pack_edges_rows(*(p.ctypes.data for p in ptrs),
                              lengths.ctypes.data, n_graphs, edges_per_graph,
                              *(a.ctypes.data for a in out))
    if bad:
        raise ValueError(f"graph {bad - 1} has a negative source node")
    return tuple(out)


def _pack_plain(edge_indices, edge_types, edges_per_graph):
    """The packing in numpy, a stable argsort per graph: the plain version
    of `_pack_native` (its mask is bool)."""
    n_graphs = len(edge_indices)
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
    return src, dst, typ, mask
