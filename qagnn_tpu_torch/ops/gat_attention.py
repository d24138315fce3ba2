"""Relation-aware graph attention: the op-level entry point and its backends.

Counterpart of qagnn_tpu/ops/gat_attention.py
(`relational_gat_attention_nodes`, `relational_gat_attention`,
`default_backend`). Per edge e = (src, dst) and head h:

    score[e, h] = <query[e, h], key[e, h]>
    alpha       = softmax over each SOURCE node's edges jointly with its
                  self-loop (reference modeling/modeling_qagnn.py:471-472)
    alpha      *= out_degree(src) (edges + self-loop, :476-481)
    out[n, h]   = sum over edges with dst == n of alpha * msg
                  + alpha_self[n, h] * msg_self[n, h]

Two backends, one function up to float reassociation:

  * "scatter": gathers, a segment softmax and scatter-adds over the flattened
    union of the graphs, in torch ops under autograd. The plain oracle that
    every kernel path is held against, the default for CPU tensors, and the
    only arm that materialises the attention weights: `return_alpha=True`
    takes it whatever backend was asked for, as the JAX op leaves its
    kernels there.
  * "cuda" (the default for CUDA tensors): the five hand-written kernels of
    qagnn_tpu_torch.ops.gat_unproj_kernels (`gat_unprojected`, an autograd
    Function whose backward is kernels too). On CPU tensors it runs their
    plain versions.

The JAX package's third backend, "onehot", has no counterpart: it is the
TPU's formulation of the same function as one-hot matrix products, for a
machine on which a scatter serialises.
"""

from __future__ import annotations

import torch

from qagnn_tpu_torch.ops.gat_unproj_kernels import gat_unprojected
from qagnn_tpu_torch.ops.segment import (
    out_degree,
    segment_softmax_with_self_loops,
    segment_sum,
)

BACKENDS = ("scatter", "cuda")


def default_backend(t: torch.Tensor) -> str:
    """The backend that follows the tensors' device: the kernels on the
    card, the scatter oracle elsewhere."""
    return "cuda" if t.is_cuda else "scatter"


def resolve_backend(backend: str | None, t: torch.Tensor) -> str:
    if backend is None:
        return default_backend(t)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    return backend


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
    backend: str | None = None,
    return_alpha: bool = False,
):
    """Decomposed form: key(e) = (A_k x)[dst] + B_k emb_e,
    msg(e) = (A_m x)[src] + B_m emb_e, query(e) = (W_q x)[src].

    Returns the aggregated node features (G, N, H*D): float32 from the
    "cuda" backend, the inputs' dtype from "scatter". With return_alpha
    also (edge_alpha (G, E, H), self_alpha (G, N, H)), always from the
    scatter arm. backend None follows the tensors' device."""
    backend = resolve_backend(backend, node_query)
    if backend == "cuda" and not return_alpha:
        G, N, H, D = node_query.shape

        def flat(t):
            return t.reshape(t.shape[0], t.shape[1], H * D)

        return gat_unprojected(
            flat(node_query), flat(node_key), flat(node_msg),
            flat(edge_key_bias), flat(edge_msg_bias), flat(self_key_bias),
            flat(self_msg_bias), edge_src.to(torch.int32).contiguous(),
            edge_dst.to(torch.int32).contiguous(),
            edge_mask.to(torch.bool).contiguous(), H)

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
