"""Knowledge-graph container: CSR numpy arrays, pickled-free persistence.

Counterpart of qagnn_tpu/preprocess/kg.py, numpy only, with the same
`.npz` format, so a KG saved by either package loads in the other. It
replaces the reference's networkx MultiDiGraph gpickle (reference
utils/conceptnet.py:175-213, utils/graph.py:33-46) with a flat edge table +
CSR indices, and holds the post-merge directed multigraph INCLUDING inverse
relations (rel + n_base_rels), exactly the edge set construct_graph emits.

`build_indices` computes the same arrays as the JAX package's per-node loop
with whole-array sorts, so that it stays a second or two at ConceptNet's
800k nodes (each worker of the graph-extraction pools builds them again).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class KG:
    n_nodes: int
    n_base_rels: int                # e.g. 17 for merged ConceptNet
    edge_src: np.ndarray            # (M,) int32 — directed, incl. inverses
    edge_dst: np.ndarray            # (M,) int32
    edge_rel: np.ndarray            # (M,) int16
    id2concept: list[str]

    # built lazily:
    _csr_offsets: np.ndarray | None = None   # (n_nodes+1,)
    _csr_dst: np.ndarray | None = None       # edges sorted by src
    _csr_rel: np.ndarray | None = None
    _nbr_offsets: np.ndarray | None = None   # unique-neighbor CSR
    _nbr_ids: np.ndarray | None = None

    @property
    def concept2id(self) -> dict[str, int]:
        if not hasattr(self, "_c2i") or self._c2i is None:
            self._c2i = {c: i for i, c in enumerate(self.id2concept)}
        return self._c2i

    def build_indices(self) -> None:
        order = np.argsort(self.edge_src, kind="stable")
        src = self.edge_src[order]
        self._csr_dst = self.edge_dst[order]
        self._csr_rel = self.edge_rel[order]
        counts = np.bincount(src, minlength=self.n_nodes)
        self._csr_offsets = np.concatenate(
            [[0], np.cumsum(counts)]).astype(np.int64)

        # unique out-neighbors per node, in ascending order (inverse edges
        # make this symmetric, mirroring the reference's cpnet_simple
        # undirected view, reference utils/graph.py:41-46)
        n = max(self.n_nodes, 1)
        pairs = np.unique(src.astype(np.int64) * n + self._csr_dst)
        nbr_off = np.zeros(self.n_nodes + 1, np.int64)
        np.cumsum(np.bincount(pairs // n, minlength=self.n_nodes),
                  out=nbr_off[1:])
        self._nbr_offsets = nbr_off
        self._nbr_ids = (pairs % n).astype(
            self.edge_dst.dtype if self.n_nodes else np.int32)

    def neighbors(self, u: int) -> np.ndarray:
        """Unique neighbor ids of u (directed graph already has inverses)."""
        if self._nbr_offsets is None:
            self.build_indices()
        return self._nbr_ids[self._nbr_offsets[u]: self._nbr_offsets[u + 1]]

    def out_edges(self, u: int) -> tuple[np.ndarray, np.ndarray]:
        """(dst, rel) arrays of u's outgoing edges (incl. inverse rels)."""
        if self._csr_offsets is None:
            self.build_indices()
        a, b = self._csr_offsets[u], self._csr_offsets[u + 1]
        return self._csr_dst[a:b], self._csr_rel[a:b]

    def rels_between(self, u: int, v: int) -> np.ndarray:
        """All relation ids on edges u -> v."""
        dst, rel = self.out_edges(u)
        return rel[dst == v]

    # ---- persistence ----------------------------------------------------

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            n_nodes=self.n_nodes, n_base_rels=self.n_base_rels,
            edge_src=self.edge_src, edge_dst=self.edge_dst,
            edge_rel=self.edge_rel,
            vocab="\n".join(self.id2concept))

    @classmethod
    def load(cls, path: str) -> "KG":
        z = np.load(path, allow_pickle=False)
        return cls(
            n_nodes=int(z["n_nodes"]), n_base_rels=int(z["n_base_rels"]),
            edge_src=z["edge_src"], edge_dst=z["edge_dst"],
            edge_rel=z["edge_rel"],
            id2concept=str(z["vocab"]).split("\n"))
