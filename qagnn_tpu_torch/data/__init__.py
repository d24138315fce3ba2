"""Data layer: statement tokenization, subgraph loading, batch iteration."""

from qagnn_tpu_torch.data.graphs import GraphData, load_graph_pk
from qagnn_tpu_torch.data.loader import QAGNNDataLoader, Split
from qagnn_tpu_torch.data.statements import (
    StatementData,
    load_statements,
    read_statement_jsonl,
)

__all__ = [
    "StatementData", "load_statements", "read_statement_jsonl",
    "GraphData", "load_graph_pk", "QAGNNDataLoader", "Split",
]
