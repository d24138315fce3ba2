"""Relation-aware graph attention, scatter backend: the port's plain oracle.

Counterpart of qagnn_tpu/ops/gat_attention.py (`relational_gat_attention_nodes`
and `relational_gat_attention` with backend "scatter"). Per edge e = (src, dst)
and head h:

    score[e, h] = <query[e, h], key[e, h]>
    alpha       = softmax over each SOURCE node's edges jointly with its
                  self-loop (reference modeling/modeling_qagnn.py:471-472)
    alpha      *= out_degree(src) (edges + self-loop, :476-481)
    out[n, h]   = sum over edges with dst == n of alpha * msg
                  + alpha_self[n, h] * msg_self[n, h]

The fused kernels of qagnn_tpu_torch.ops.gat_kernels compute the same function
and are held against this one.
"""

from __future__ import annotations

import torch

from qagnn_tpu_torch.ops.segment import (
    out_degree,
    segment_softmax_with_self_loops,
    segment_sum,
)


def _take(nodes, idx):
    """(G, N, H, D) gathered by (G, E) local indices -> (G, E, H, D)."""
    G, E = idx.shape
    flat = idx.long().reshape(G, E, 1, 1).expand(G, E, *nodes.shape[2:])
    return torch.gather(nodes, 1, flat)


def relational_gat_attention_nodes(
    node_query,     # (G, N, H, D): W_q x / sqrt(D), per node
    node_key,       # (G, N, H, D): A_k x
    node_msg,       # (G, N, H, D): A_m x
    edge_key_bias,  # (G, E, H, D): B_k e(edge) + bias
    edge_msg_bias,  # (G, E, H, D): B_m e(edge) + bias
    self_key_bias,  # (G, N, H, D): B_k e(self-loop)
    self_msg_bias,  # (G, N, H, D): B_m e(self-loop)
    edge_src,       # (G, E) int
    edge_dst,       # (G, E) int
    edge_mask,      # (G, E) bool
    *,
    return_alpha: bool = False,
):
    """Decomposed form: key(e) = (A_k x)[dst] + B_k emb_e,
    msg(e) = (A_m x)[src] + B_m emb_e, query(e) = (W_q x)[src]."""
    edge_query = _take(node_query, edge_src)
    edge_key = _take(node_key, edge_dst) + edge_key_bias
    edge_msg = _take(node_msg, edge_src) + edge_msg_bias
    return relational_gat_attention(
        edge_query, edge_key, edge_msg, edge_src, edge_dst, edge_mask,
        node_query, node_key + self_key_bias, node_msg + self_msg_bias,
        return_alpha=return_alpha)


def relational_gat_attention(edge_query, edge_key, edge_msg, edge_src,
                             edge_dst, edge_mask, self_query, self_key,
                             self_msg, *, return_alpha: bool = False):
    """Aggregated node features (G, N, H*D) over the flattened union of the
    G graphs; optionally also (edge_alpha (G, E, H), self_alpha (G, N, H))."""
    G, E = edge_src.shape
    N = self_query.shape[1]
    H, D = edge_query.shape[2], edge_query.shape[3]

    offs = (torch.arange(G, device=edge_src.device) * N)[:, None]
    src = (edge_src.long() + offs).reshape(-1)
    dst = (edge_dst.long() + offs).reshape(-1)
    mask = edge_mask.reshape(-1)
    eq = edge_query.reshape(G * E, H, D)
    ek = edge_key.reshape(G * E, H, D)
    em = edge_msg.reshape(G * E, H, D)
    sq = self_query.reshape(G * N, H, D)
    sk = self_key.reshape(G * N, H, D)
    sm = self_msg.reshape(G * N, H, D)

    edge_scores = torch.sum(eq * ek, dim=-1)      # (GE, H)
    self_scores = torch.sum(sq * sk, dim=-1)      # (GN, H)
    edge_alpha, self_alpha = segment_softmax_with_self_loops(
        edge_scores, src, mask, self_scores)

    deg = out_degree(src, G * N, mask, include_self_loop=True)
    edge_alpha_s = edge_alpha * deg[src][:, None]
    self_alpha_s = self_alpha * deg[:, None]

    aggr = segment_sum(em * edge_alpha_s[:, :, None], dst, G * N, mask)
    aggr = aggr + sm * self_alpha_s[:, :, None]

    out = aggr.reshape(G, N, H * D)
    if return_alpha:
        return out, (edge_alpha.reshape(G, E, H), self_alpha.reshape(G, N, H))
    return out
