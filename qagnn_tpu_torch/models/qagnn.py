"""QAGNN decoder and the LM + GNN model, eval and train mode.

Counterpart of qagnn_tpu/models/qagnn.py (`normalize_node_scores`, `QAGNN`,
`LMQAGNN`; reference modeling/modeling_qagnn.py:99-251). LM inputs arrive as
(B, C, L) tensors and graphs as one BatchedGraphs with G == B * C.

`gnn_mesh` (a qagnn_tpu_torch.parallel.mesh.Mesh) puts the GNN on a grid of
ranks (qagnn_tpu/models/qagnn.py:66, 100, 166, 197): the batch is then this
rank's data slice, its graphs' edge arrays its edge slice
(parallel.mesh.shard_batch).
"""

from __future__ import annotations

import torch
from torch import nn

from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.models.gnn import QAGNNMessagePassing
from qagnn_tpu_torch.models.layers import (
    MLP,
    CustomizedEmbedding,
    MultiheadAttPoolLayer,
    dense,
    dropout,
    gelu,
)


def normalize_node_scores(node_scores, node_mask, num_nodes):
    """Reference score normalization (modeling/modeling_qagnn.py:159-167)."""
    s = -node_scores
    s = s - s[:, 0:1]
    s = s * node_mask.to(s.dtype)
    mean_norm = torch.sum(torch.abs(s), dim=1) / num_nodes.to(s.dtype)
    return s / (mean_norm[:, None] + 1e-05)


class QAGNN(nn.Module):
    """Context-node projection + concept embedding + k-layer message passing
    + attention pooling + MLP scorer (reference
    modeling/modeling_qagnn.py:99-189)."""

    def __init__(self, k: int, n_ntype: int, n_etype: int, sent_dim: int,
                 n_concept: int, concept_dim: int, concept_in_dim: int,
                 n_attention_head: int, fc_dim: int, n_fc_layer: int,
                 p_emb: float = 0.2, p_gnn: float = 0.2, p_fc: float = 0.2,
                 gnn_backend: str | None = None,
                 gnn_dtype: torch.dtype = torch.float32, gnn_mesh=None):
        super().__init__()
        self.p_emb, self.p_fc = p_emb, p_fc
        self.svec2nvec = nn.Linear(sent_dim, concept_dim)
        self.concept_emb = CustomizedEmbedding(n_concept, concept_in_dim,
                                               concept_dim)
        self.gnn = QAGNNMessagePassing(k, n_ntype, n_etype, concept_dim,
                                       dropout=p_gnn, backend=gnn_backend,
                                       dtype=gnn_dtype, mesh=gnn_mesh)
        self.pooler = MultiheadAttPoolLayer(n_attention_head, sent_dim,
                                            concept_dim)
        self.fc = MLP(concept_dim + sent_dim + concept_dim, fc_dim, 1,
                      n_fc_layer, layer_norm=True, dropout=p_fc)

    def forward(self, sent_vecs, graph: BatchedGraphs, *,
                return_pool_attn: bool = False,
                return_gnn_attn: bool = False):
        """sent_vecs: (G, sent_dim). Returns logits (G, 1) [, pooler
        attention (n_head*G, N)] [, GNN attention ((k, G, E, H) edge alphas,
        (k, G, N, H) self alphas)]. The GNN attention comes from the scatter
        arm of the attention op, the only one that materialises it."""
        gnn_input0 = gelu(dense(sent_vecs, self.svec2nvec))[:, None, :]
        # padding slots carry concept_id 1 -> table row 0
        gnn_input1 = self.concept_emb(graph.concept_ids[:, 1:] - 1)
        gnn_input = torch.cat([gnn_input0, gnn_input1], dim=1)
        gnn_input = dropout(gnn_input, self.p_emb, self.training)

        node_mask = graph.node_mask
        node_scores = normalize_node_scores(graph.node_scores, node_mask,
                                            graph.num_nodes)
        gnn_output = self.gnn(gnn_input, graph.node_types, node_scores,
                              graph.edge_src, graph.edge_dst,
                              graph.edge_type, graph.edge_mask,
                              return_alpha=return_gnn_attn)
        if return_gnn_attn:
            gnn_output, gnn_attn = gnn_output
        z_vecs = gnn_output[:, 0]

        # pool over KG nodes only: padding and the context node masked out
        pool_mask = (~node_mask) | (graph.node_types == 3)
        all_masked = pool_mask.all(dim=1)
        pool_mask = pool_mask.clone()
        pool_mask[:, 0] = torch.where(all_masked, False, pool_mask[:, 0])
        graph_vecs, pool_attn = self.pooler(sent_vecs, gnn_output, pool_mask)

        dt = torch.promote_types(z_vecs.dtype, sent_vecs.dtype)
        concat = torch.cat([graph_vecs.to(dt), sent_vecs.to(dt),
                            z_vecs.to(dt)], dim=1)
        logits = self.fc(dropout(concat, self.p_fc, self.training))
        out = (logits,)
        if return_pool_attn:
            out += (pool_attn,)
        if return_gnn_attn:
            out += (gnn_attn,)
        return out if len(out) > 1 else logits


class LMQAGNN(nn.Module):
    """Encoder + decoder (reference modeling/modeling_qagnn.py:192-251)."""

    def __init__(self, encoder: nn.Module, sent_dim: int, k: int,
                 n_ntype: int, n_etype: int, n_concept: int,
                 concept_dim: int, concept_in_dim: int,
                 n_attention_head: int, fc_dim: int, n_fc_layer: int,
                 p_emb: float = 0.2, p_gnn: float = 0.2, p_fc: float = 0.2,
                 gnn_backend: str | None = None,
                 gnn_dtype: torch.dtype = torch.float32, gnn_mesh=None):
        super().__init__()
        self.encoder = encoder
        self.decoder = QAGNN(k, n_ntype, n_etype, sent_dim, n_concept,
                             concept_dim, concept_in_dim, n_attention_head,
                             fc_dim, n_fc_layer, p_emb=p_emb, p_gnn=p_gnn,
                             p_fc=p_fc, gnn_backend=gnn_backend,
                             gnn_dtype=gnn_dtype, gnn_mesh=gnn_mesh)

    def forward(self, lm_inputs: dict, graph: BatchedGraphs, *,
                layer_id: int = -1, return_pool_attn: bool = False,
                detail: bool = False):
        """lm_inputs: dict of (B, C, L) tensors (input_ids, attention_mask,
        ...). Returns logits (B, C) [and the pooler attention]. With detail
        (reference modeling/modeling_qagnn.py:236-241): (logits, pool_attn,
        gnn_attn), gnn_attn = ((k, G, E, H) edge alphas, (k, G, N, H)
        self-loop alphas)."""
        first = next(iter(lm_inputs.values()))
        bs, nc = first.shape[0], first.shape[1]
        flat_lm = {k: v.reshape((bs * nc,) + tuple(v.shape[2:]))
                   for k, v in lm_inputs.items()}
        sent_vecs = self.encoder(**flat_lm, layer_id=layer_id)
        if isinstance(sent_vecs, tuple):   # (pooled, hidden states)
            sent_vecs = sent_vecs[0]
        out = self.decoder(sent_vecs, graph,
                           return_pool_attn=return_pool_attn or detail,
                           return_gnn_attn=detail)
        if detail or return_pool_attn:
            return (out[0].reshape(bs, nc),) + out[1:]
        return out.reshape(bs, nc)
