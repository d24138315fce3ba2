"""Model layer: torch modules for the QA-GNN family (counterpart of
qagnn_tpu/models)."""

from qagnn_tpu_torch.models.gnn import GATConvE, QAGNNMessagePassing
from qagnn_tpu_torch.models.layers import (
    MLP,
    BilinearAttentionLayer,
    CustomizedEmbedding,
    MultiheadAttPoolLayer,
    TripleEncoder,
    TypedLinear,
    TypedMultiheadAttPoolLayer,
    diff_topk,
    gelu,
    masked_softmax,
    matrix_attention,
)
from qagnn_tpu_torch.models.norm import MaskedBatchNorm
from qagnn_tpu_torch.models.qagnn import LMQAGNN, QAGNN

__all__ = [
    "MaskedBatchNorm", "gelu", "MLP", "MultiheadAttPoolLayer",
    "CustomizedEmbedding", "TypedLinear", "TypedMultiheadAttPoolLayer",
    "BilinearAttentionLayer", "TripleEncoder", "diff_topk",
    "matrix_attention", "masked_softmax", "GATConvE", "QAGNNMessagePassing",
    "QAGNN", "LMQAGNN",
]
