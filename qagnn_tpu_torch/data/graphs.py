"""Knowledge-graph subgraph loading: .graph.adj.pk -> fixed-shape arrays.

A copy of qagnn_tpu/data/graphs.py, numpy only. It reproduces the
reference's context-node transform (reference utils/data_utils.py:79-197
load_sparse_adj_data_with_contextnode):

  * pickle rows {adj: (half_R*N x N bool COO), concepts, qmask, amask,
    cid2score}
  * node 0 becomes the context node (concept_id 0, node_type 3); real concept
    ids are incremented by 1; padding slots keep concept_id 1 / node_type 2
  * relation ids shift by +2; context->question edges get relation 0 and
    context->answer edges relation 1
  * nodes beyond max_node_num are pruned (with their edges)
  * inverse relations are appended with relation id + (half_n_rel + 2)

and caches the result beside the pickle as `<path>.tpu_cache.npz`, in the
JAX package's file name and format, so a cache written by either package
reads in the other. The file name does not hold max_node_num, so a cache
written at another max_node_num raises instead of being read. The cache is
written to a temporary file beside it and renamed into place, so that a
process reading it while another writes it (the ranks of a grid each load
the dataset) finds the whole cache or none.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import numpy as np

CONTEXT_NODE_TYPE = 3
PAD_CONCEPT_ID = 1
PAD_NODE_TYPE = 2
CONTEXT_TO_QUESTION_REL = 0
CONTEXT_TO_ANSWER_REL = 1
NUM_CONTEXT_RELS = 2


@dataclass
class GraphData:
    concept_ids: np.ndarray    # (n, max_node_num) int32
    node_types: np.ndarray     # (n, max_node_num) int32
    node_scores: np.ndarray    # (n, max_node_num) float32
    num_nodes: np.ndarray      # (n,) int32 — incl. context node
    edge_indices: list[np.ndarray]  # per example (2, E_i) int32, local ids
    edge_types: list[np.ndarray]    # per example (E_i,) int32
    n_relations: int           # total incl. context rels and inverses

    def __len__(self):
        return self.concept_ids.shape[0]


def load_graph_pk(path: str, max_node_num: int = 200,
                  use_cache: bool = True) -> GraphData:
    cache_path = path + ".tpu_cache.npz"
    if use_cache and os.path.exists(cache_path):
        data = _load_cache(cache_path)
        if data.concept_ids.shape[1] != max_node_num:
            raise ValueError(
                f"the graph cache {cache_path} holds graphs of "
                f"{data.concept_ids.shape[1]} nodes, not max_node_num="
                f"{max_node_num}; delete it or pass use_cache=False")
        return data

    with open(path, "rb") as f:
        rows = pickle.load(f)

    n = len(rows)
    concept_ids = np.full((n, max_node_num), PAD_CONCEPT_ID, np.int32)
    node_types = np.full((n, max_node_num), PAD_NODE_TYPE, np.int32)
    node_scores = np.zeros((n, max_node_num), np.float32)
    num_nodes = np.zeros(n, np.int32)
    edge_indices, edge_types = [], []
    half_n_rel = 0

    for idx, row in enumerate(rows):
        adj, concepts = row["adj"], np.asarray(row["concepts"])
        qm, am = np.asarray(row["qmask"]), np.asarray(row["amask"])
        cid2score = row["cid2score"]

        num_concept = min(len(concepts), max_node_num - 1) + 1
        num_nodes[idx] = num_concept

        kept = concepts[: num_concept - 1]
        concept_ids[idx, 1:num_concept] = kept + 1
        concept_ids[idx, 0] = 0

        if cid2score is not None:
            # context node scores under key -1 (reference :129-132 maps
            # concept_id-1, and the context node's id is 0)
            for j in range(num_concept):
                node_scores[idx, j] = cid2score[int(concept_ids[idx, j]) - 1]

        node_types[idx, 0] = CONTEXT_NODE_TYPE
        node_types[idx, 1:num_concept][qm[: num_concept - 1]] = 0
        node_types[idx, 1:num_concept][am[: num_concept - 1]] = 1

        # COO of shape (half_n_rel * n_node, n_node): row = rel * n_node + src
        coo_row = np.asarray(adj.row, np.int64)
        coo_col = np.asarray(adj.col, np.int64)
        n_node = adj.shape[1]
        half_n_rel = adj.shape[0] // n_node
        rel, src = coo_row // n_node, coo_row % n_node
        dst = coo_col

        # +1 node offset for the context node; +2 relation offset for the two
        # context relations (reference :149)
        rel = rel + NUM_CONTEXT_RELS
        src = src + 1
        dst = dst + 1

        # context -> question-concept and context -> answer-concept edges
        extra_rel, extra_src, extra_dst = [], [], []
        for coord, flag in enumerate(qm):
            if coord + 1 > num_concept:
                break
            if flag:
                extra_rel.append(CONTEXT_TO_QUESTION_REL)
                extra_src.append(0)
                extra_dst.append(coord + 1)
        for coord, flag in enumerate(am):
            if coord + 1 > num_concept:
                break
            if flag:
                extra_rel.append(CONTEXT_TO_ANSWER_REL)
                extra_src.append(0)
                extra_dst.append(coord + 1)
        if extra_rel:
            rel = np.concatenate([rel, np.asarray(extra_rel, np.int64)])
            src = np.concatenate([src, np.asarray(extra_src, np.int64)])
            dst = np.concatenate([dst, np.asarray(extra_dst, np.int64)])

        half_total = half_n_rel + NUM_CONTEXT_RELS

        keep = (src < max_node_num) & (dst < max_node_num)
        rel, src, dst = rel[keep], src[keep], dst[keep]

        # append inverse relations (reference :174)
        rel = np.concatenate([rel, rel + half_total])
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])

        edge_indices.append(np.stack([src, dst]).astype(np.int32))
        edge_types.append(rel.astype(np.int32))

    data = GraphData(
        concept_ids=concept_ids, node_types=node_types,
        node_scores=node_scores, num_nodes=num_nodes,
        edge_indices=edge_indices, edge_types=edge_types,
        n_relations=2 * (half_n_rel + NUM_CONTEXT_RELS),
    )
    if use_cache:
        _save_cache(cache_path, data)
    return data


def _save_cache(path: str, data: GraphData) -> None:
    lengths = np.asarray([e.shape[1] for e in data.edge_indices], np.int64)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f,
            concept_ids=data.concept_ids, node_types=data.node_types,
            node_scores=data.node_scores, num_nodes=data.num_nodes,
            edge_lengths=lengths,
            edge_index_flat=np.concatenate(data.edge_indices, axis=1)
            if data.edge_indices else np.zeros((2, 0), np.int32),
            edge_type_flat=np.concatenate(data.edge_types)
            if data.edge_types else np.zeros((0,), np.int32),
            n_relations=np.asarray(data.n_relations),
        )
    os.replace(tmp, path)


def _load_cache(path: str) -> GraphData:
    z = np.load(path)
    lengths = z["edge_lengths"]
    splits = np.cumsum(lengths)[:-1]
    return GraphData(
        concept_ids=z["concept_ids"], node_types=z["node_types"],
        node_scores=z["node_scores"], num_nodes=z["num_nodes"],
        edge_indices=np.split(z["edge_index_flat"], splits, axis=1),
        edge_types=np.split(z["edge_type_flat"], splits),
        n_relations=int(z["n_relations"]),
    )
