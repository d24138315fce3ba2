"""Dataset facade + host-side batch iterator.

Counterpart of qagnn_tpu/data/loader.py (reference LM_QAGNN_DataLoader,
modeling/modeling_qagnn.py:255-341, and MultiGPUSparseAdjDataBatchGenerator,
utils/data_utils.py:17-76): loads the three splits, applies the CSQA
in-house split and subsampling, and yields the train step's `Batch` of CPU
tensors (LM inputs, BatchedGraphs, labels). The shuffle draws from a numpy
generator seeded as the JAX package's, so both packages visit the questions
in one order.

Every batch of a split shares ONE edge bucket, chosen once from the split's
largest real edge count. With `pin_memory` the batch's tensors are copied
into page-locked host memory, so that the step functions' non_blocking
copies to the card run asynchronously.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qagnn_tpu_torch.data.graphs import GraphData, load_graph_pk
from qagnn_tpu_torch.data.statements import StatementData, load_statements
from qagnn_tpu_torch.graph.batching import batch_edge_lists, pick_edge_bucket
from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.train.step import Batch


class Split:
    """One split's host arrays, indexable by question."""

    def __init__(self, statements: StatementData, graphs: GraphData,
                 n_choices: int, pin_memory: bool = False):
        self.statements = statements
        self.graphs = graphs
        self.n_choices = n_choices
        self.pin_memory = pin_memory
        n = len(statements)
        if len(graphs) != n * n_choices:
            raise ValueError(f"{len(graphs)} graphs != {n} questions x "
                             f"{n_choices} choices")
        self.edge_bucket = pick_edge_bucket(
            max((e.shape[1] for e in graphs.edge_indices), default=0))

    def __len__(self):
        return len(self.statements)

    def gather(self, idx: np.ndarray) -> Batch:
        """Assemble a fixed-shape Batch for question indices `idx`."""
        st, gr, nc = self.statements, self.graphs, self.n_choices
        lm_inputs = {k: torch.from_numpy(v[idx])
                     for k, v in st.inputs.items()}
        labels = torch.from_numpy(st.labels[idx].astype(np.int32))

        flat = (idx[:, None] * nc + np.arange(nc)[None, :]).reshape(-1)
        graph = batch_edge_lists(
            [gr.edge_indices[i] for i in flat],
            [gr.edge_types[i] for i in flat],
            gr.concept_ids[flat], gr.node_types[flat],
            gr.node_scores[flat], gr.num_nodes[flat],
            edges_per_graph=self.edge_bucket)
        if self.pin_memory:
            lm_inputs = {k: v.pin_memory() for k, v in lm_inputs.items()}
            graph = BatchedGraphs(**{
                f.name: getattr(graph, f.name).pin_memory()
                for f in dataclasses.fields(graph)})
            labels = labels.pin_memory()
        return Batch(lm_inputs=lm_inputs, graph=graph, labels=labels)

    def qids(self, idx: np.ndarray) -> list[str]:
        return [self.statements.qids[i] for i in idx]


class QAGNNDataLoader:
    """Train/dev/test splits with in-house CSQA mode and subsampling
    (reference modeling/modeling_qagnn.py:255-341)."""

    def __init__(self, *,
                 train_statements: str, train_adj: str,
                 dev_statements: str, dev_adj: str,
                 test_statements: str | None = None,
                 test_adj: str | None = None,
                 model_name: str, max_node_num: int = 200,
                 max_seq_len: int = 100,
                 batch_size: int = 32, eval_batch_size: int = 8,
                 is_inhouse: bool = False,
                 inhouse_train_qids_path: str | None = None,
                 subsample: float = 1.0, seed: int = 0,
                 tokenizer=None, pin_memory: bool = False):
        self.batch_size = batch_size
        self.eval_batch_size = eval_batch_size
        self.rng = np.random.default_rng(seed)

        def split(statements, adj, n_choices=None):
            st = load_statements(statements, model_name, max_seq_len,
                                 tokenizer)
            return Split(st, load_graph_pk(adj, max_node_num),
                         n_choices or st.n_choices, pin_memory)

        self.train_split = split(train_statements, train_adj)
        nc = self.train_split.n_choices
        self.dev_split = split(dev_statements, dev_adj, nc)
        self.test_split = None
        if test_statements and test_adj:
            self.test_split = split(test_statements, test_adj, nc)

        # In-house CSQA split: official train re-split into train/test by a
        # fixed qid list (reference modeling/modeling_qagnn.py:288-294).
        self.is_inhouse = is_inhouse
        if is_inhouse:
            with open(inhouse_train_qids_path) as f:
                inhouse_qids = set(line.strip() for line in f)
            qids = self.train_split.statements.qids
            self.inhouse_train_idx = np.asarray(
                [i for i, q in enumerate(qids) if q in inhouse_qids])
            self.inhouse_test_idx = np.asarray(
                [i for i, q in enumerate(qids) if q not in inhouse_qids])
        else:
            self.inhouse_train_idx = np.arange(len(self.train_split))
            self.inhouse_test_idx = None

        if subsample < 1.0:
            n_train = max(1, int(len(self.inhouse_train_idx) * subsample))
            self.inhouse_train_idx = self.inhouse_train_idx[:n_train]

    def train_size(self) -> int:
        return len(self.inhouse_train_idx)

    def dev_size(self) -> int:
        return len(self.dev_split)

    def test_size(self) -> int:
        if self.is_inhouse:
            return len(self.inhouse_test_idx)
        return len(self.test_split) if self.test_split else 0

    def train(self):
        """Shuffled train batches. A partial last batch is filled by
        resampling (the reference's fill option, utils/data_utils.py:41-47),
        so every step has one shape."""
        order = self.rng.permutation(self.inhouse_train_idx)
        bs = self.batch_size
        for a in range(0, len(order), bs):
            idx = order[a: a + bs]
            if len(idx) < bs:
                extra = self.rng.choice(order, bs - len(idx), replace=True)
                idx = np.concatenate([idx, extra])
            yield self.train_split.qids(idx), self.train_split.gather(idx)

    def _eval_iter(self, split: Split, index: np.ndarray):
        bs = self.eval_batch_size
        for a in range(0, len(index), bs):
            idx = index[a: a + bs]
            pad = 0
            if len(idx) < bs:  # pad; the caller drops the last `pad` rows
                pad = bs - len(idx)
                idx = np.concatenate([idx, np.repeat(idx[-1:], pad)])
            yield split.qids(idx[: bs - pad or None]), split.gather(idx), pad

    def dev(self):
        yield from self._eval_iter(self.dev_split,
                                   np.arange(len(self.dev_split)))

    def test(self):
        if self.is_inhouse:
            yield from self._eval_iter(self.train_split, self.inhouse_test_idx)
        elif self.test_split is not None:
            yield from self._eval_iter(self.test_split,
                                       np.arange(len(self.test_split)))
