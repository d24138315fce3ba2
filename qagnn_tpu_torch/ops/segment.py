"""Masked segment primitives over fixed-shape (padded) edge arrays.

Counterpart of qagnn_tpu/ops/segment.py on `index_add_` / `scatter_reduce`.
Padded entries contribute exact zeros to every reduction. Self-loops are not
edge entries: `segment_softmax_with_self_loops` joins one dense self-loop
score per segment analytically.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large finite negative; avoids NaN from (-inf) - (-inf)


def _expand(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - mask.ndim))


def segment_sum(data, segment_ids, num_segments: int, mask=None):
    """Masked sum of `data` rows (E, ...) into `num_segments` buckets."""
    if mask is not None:
        data = torch.where(_expand(mask, data.ndim), data, 0)
    out = data.new_zeros((num_segments,) + data.shape[1:])
    return out.index_add_(0, segment_ids.long(), data)


def segment_max(data, segment_ids, num_segments: int, mask=None):
    """Masked max per segment. Empty segments return NEG_INF."""
    if mask is not None:
        data = torch.where(_expand(mask, data.ndim), data, NEG_INF)
    out = data.new_full((num_segments,) + data.shape[1:], NEG_INF)
    idx = _expand(segment_ids.long(), data.ndim).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=True)


def segment_softmax(scores, segment_ids, num_segments: int, mask=None):
    """Numerically stable masked softmax within each segment: (E, H) ->
    (E, H), padded rows exactly 0 (torch_geometric.utils.softmax on the
    real rows)."""
    ids = segment_ids.long()
    m = segment_max(scores, ids, num_segments, mask)
    e = torch.exp(scores - m[ids])
    if mask is not None:
        e = torch.where(_expand(mask, e.ndim), e, 0)
    denom = torch.clamp_min(segment_sum(e, ids, num_segments), 1e-16)
    return e / denom[ids]


def segment_softmax_with_self_loops(edge_scores, segment_ids, edge_mask,
                                    self_scores):
    """Joint softmax over {edges grouped by segment} and one self-loop per
    segment (reference modeling/modeling_qagnn.py:436-438, 472).

    edge_scores: (E, H); segment_ids: (E,) in [0, S); self_scores: (S, H).
    Returns (edge_alpha (E, H), self_alpha (S, H)).
    """
    num_segments = self_scores.shape[0]
    ids = segment_ids.long()
    # the shift is a constant to autograd (softmax does not depend on it),
    # as the fused op treats its per-graph max
    m = torch.maximum(
        segment_max(edge_scores, ids, num_segments, edge_mask),
        self_scores).detach()
    e_edges = torch.exp(edge_scores - m[ids])
    if edge_mask is not None:
        e_edges = torch.where(_expand(edge_mask, e_edges.ndim), e_edges, 0)
    e_self = torch.exp(self_scores - m)
    denom = segment_sum(e_edges, ids, num_segments) + e_self
    denom = torch.clamp_min(denom, 1e-16)
    return e_edges / denom[ids], e_self / denom


def out_degree(segment_ids, num_segments: int, mask=None,
               include_self_loop: bool = True):
    """Per-segment edge count (float), +1 for the implicit self-loop."""
    ones = torch.ones(segment_ids.shape, dtype=torch.float32,
                      device=segment_ids.device)
    deg = segment_sum(ones, segment_ids, num_segments, mask)
    return deg + 1.0 if include_self_loop else deg
