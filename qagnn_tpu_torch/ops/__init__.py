"""Sparse graph primitives: masked segment ops and the relational graph
attention (counterpart of qagnn_tpu/ops; the kernels' modules are
gat_kernels, gat_unproj_kernels and edge_encoder_kernels)."""

from qagnn_tpu_torch.ops.gat_attention import (
    relational_gat_attention,
    relational_gat_attention_nodes,
)
from qagnn_tpu_torch.ops.segment import (
    out_degree,
    segment_max,
    segment_softmax,
    segment_softmax_with_self_loops,
    segment_sum,
)

__all__ = [
    "segment_sum", "segment_max", "segment_softmax",
    "segment_softmax_with_self_loops", "out_degree",
    "relational_gat_attention", "relational_gat_attention_nodes",
]
