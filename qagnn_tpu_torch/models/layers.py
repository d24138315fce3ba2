"""Common layers of the QA-GNN decoder.

Counterpart of the parts of qagnn_tpu/models/layers.py that `QAGNN` uses.
Submodule and parameter names follow the flax modules so that a flax
parameter tree maps onto them path by path (qagnn_tpu_torch.utils.convert).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

MASK_FILL = -1e32  # reference utils/layers.py:453 mask_fill_value


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximated GELU, the reference formula (utils/layers.py:10-14)."""
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))


def dense(x: torch.Tensor, layer: nn.Linear, dtype=None) -> torch.Tensor:
    """flax Dense semantics: compute in `dtype`, or in the promotion of the
    input and parameter dtypes when it is None."""
    dt = dtype or torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


_DROPOUT_GENERATOR: torch.Generator | None = None
_DATA_SHARD: tuple[int, int] | None = None
_BATCH_GROUPS = 1


@contextlib.contextmanager
def dropout_generator(generator: torch.Generator | None,
                      data_shard: tuple[int, int] | None = None):
    """Within the block every `dropout` draws its mask from `generator`
    (which lives on the tensors' device), so that a train step is a function
    of its seed. None: torch's global generator.

    data_shard = (d, n_data): the tensors hold data slice d of n_data equal
    slices of a batch (parallel/mesh.py). Each mask of a batch-major tensor
    is then drawn for the whole batch, leading axis n_data times longer,
    and cut to slice d; a `replicated` mask is drawn whole. Every rank then
    draws the masks of a one-rank run on the same generator, the same on
    every rank of a data slice."""
    global _DROPOUT_GENERATOR, _DATA_SHARD
    previous = _DROPOUT_GENERATOR, _DATA_SHARD
    _DROPOUT_GENERATOR, _DATA_SHARD = generator, data_shard
    try:
        yield
    finally:
        _DROPOUT_GENERATOR, _DATA_SHARD = previous


@contextlib.contextmanager
def batch_groups(groups: int):
    """Within the block a dropped tensor's leading axis is `groups` blocks
    of the batch (heads-major rows, as the pooler's attention has), for the
    cut of `dropout_generator`'s data_shard."""
    global _BATCH_GROUPS
    previous, _BATCH_GROUPS = _BATCH_GROUPS, groups
    try:
        yield
    finally:
        _BATCH_GROUPS = previous


def dropout(x: torch.Tensor, p: float, training: bool,
            mask_shape: tuple[int, ...] | None = None,
            replicated: bool = False) -> torch.Tensor:
    """Inverted dropout: in training, zero each element with probability p
    and scale the rest by 1 / (1 - p); else the identity. `mask_shape`
    draws a mask of that shape, broadcast over x (flax Dropout's
    `broadcast_dims`: one mask per row and feature, shared over time).
    x's leading axis is the batch (rows of `batch_groups` blocks of it)
    unless `replicated`: x is then the same on every rank of a grid (a
    table, not rows of the batch), and so is its mask."""
    if not training or p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    shape = tuple(x.shape if mask_shape is None else mask_shape)
    if replicated or _DATA_SHARD is None or _DATA_SHARD[1] == 1:
        keep = x.new_empty(shape)
        keep.bernoulli_(1.0 - p, generator=_DROPOUT_GENERATOR)
    else:
        d, n_data = _DATA_SHARD
        g = _BATCH_GROUPS
        rows = shape[0] // g
        whole = x.new_empty((g, n_data * rows) + shape[1:])
        whole.bernoulli_(1.0 - p, generator=_DROPOUT_GENERATOR)
        keep = whole[:, d * rows:(d + 1) * rows].reshape(shape)
    return x * keep / (1.0 - p)


class ProjParams(nn.Module):
    """Bare projection parameters kept as in the flax tree: `kernel`
    (in, out) and optional `bias` (out,). For projections that run inside a
    kernel, or are composed with other weights before use."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

    def apply_to(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """x @ kernel + bias in `dtype` (flax Dense semantics)."""
        dt = dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        y = x.to(dt) @ self.kernel.to(dt)
        return y if self.bias is None else y + self.bias.to(dt)


class MLP(nn.Module):
    """num_layers + 1 Linear layers; hidden ones followed by
    Dropout -> [LayerNorm] -> activation (reference utils/layers.py:47-87)."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int,
                 num_layers: int, layer_norm: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        self.layer_norm = layer_norm
        for i in range(num_layers + 1):
            n_in = input_size if i == 0 else hidden_size
            n_out = hidden_size if i < num_layers else output_size
            self.add_module(f"linear_{i}", nn.Linear(n_in, n_out))
            if i < num_layers and layer_norm:
                self.add_module(f"layernorm_{i}",
                                nn.LayerNorm(hidden_size, eps=1e-5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers + 1):
            x = dense(x, getattr(self, f"linear_{i}"))
            if i < self.num_layers:
                x = dropout(x, self.dropout, self.training)
                if self.layer_norm:
                    ln = getattr(self, f"layernorm_{i}")
                    x = F.layer_norm(x, ln.normalized_shape, ln.weight,
                                     ln.bias, ln.eps)
                x = gelu(x)
        return x


def masked_softmax(vector: torch.Tensor, mask: torch.Tensor | None,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over entries not masked out; mask True == drop, and dropped
    entries get exactly 0."""
    if mask is None:
        return torch.softmax(vector, dim=dim)
    out = torch.softmax(torch.where(mask, MASK_FILL, vector), dim=dim)
    return torch.where(mask, 0.0, out)


class MatrixVectorScaledDotProductAttention(nn.Module):
    """One query vector attending over a sequence (reference
    utils/layers.py:276-299)."""

    def __init__(self, temperature: float, attn_dropout: float = 0.1,
                 groups: int = 1):
        super().__init__()
        self.temperature = temperature
        self.attn_dropout = attn_dropout
        self.groups = groups       # heads-major rows (see `batch_groups`)

    def forward(self, q, k, v, mask=None):
        """q: (B, Dk); k: (B, L, Dk); v: (B, L, Dv); mask: (B, L) True==drop."""
        attn = torch.sum(q[:, None, :] * k, dim=2) / self.temperature
        attn = masked_softmax(attn, mask)
        with batch_groups(self.groups):
            attn = dropout(attn, self.attn_dropout, self.training)
        return torch.sum(attn[:, :, None] * v, dim=1), attn


class MultiheadAttPoolLayer(nn.Module):
    """Multi-head attention pooling of node features by the sentence vector
    (reference utils/layers.py:324-371)."""

    def __init__(self, n_head: int, d_q_original: int, d_k_original: int,
                 dropout: float = 0.1):
        super().__init__()
        assert d_k_original % n_head == 0
        self.n_head = n_head
        self.dropout = dropout
        self.d_k = d_k_original // n_head
        self.w_qs = nn.Linear(d_q_original, n_head * self.d_k)
        self.w_ks = nn.Linear(d_k_original, n_head * self.d_k)
        self.w_vs = nn.Linear(d_k_original, n_head * self.d_k)
        self.attention = MatrixVectorScaledDotProductAttention(
            temperature=float(self.d_k) ** 0.5, groups=n_head)

    def forward(self, q, k, mask=None):
        """q: (B, dq); k: (B, L, dk); mask: (B, L) True==masked out."""
        nh, d_k = self.n_head, self.d_k
        bs, len_k = k.shape[0], k.shape[1]
        qs = dense(q, self.w_qs).reshape(bs, nh, d_k)
        ks = dense(k, self.w_ks).reshape(bs, len_k, nh, d_k)
        vs = dense(k, self.w_vs).reshape(bs, len_k, nh, d_k)
        qs = qs.permute(1, 0, 2).reshape(nh * bs, d_k)
        ks = ks.permute(2, 0, 1, 3).reshape(nh * bs, len_k, d_k)
        vs = vs.permute(2, 0, 1, 3).reshape(nh * bs, len_k, d_k)
        if mask is not None:
            mask = mask.repeat(nh, 1)
        output, attn = self.attention(qs, ks, vs, mask)
        output = output.reshape(nh, bs, d_k).permute(1, 0, 2)
        output = dropout(output.reshape(bs, nh * d_k), self.dropout,
                         self.training)
        return output, attn


class CustomizedEmbedding(nn.Module):
    """Entity table lookup, then GELU(Linear) when the widths differ
    (reference utils/layers.py:571-607).

    With `shard` set (a parallel.mesh.RowShard, by parallel.mesh
    .shard_params) `emb` holds only this rank's rows of the table: each
    rank looks its rows up, zeros the others, and the model group sums the
    parts (`sum_shards`: every rank of the group repeats what follows the
    lookup, so the sum's backward is the identity)."""

    def __init__(self, concept_num: int, concept_in_dim: int,
                 concept_out_dim: int, scale: float = 1.0):
        super().__init__()
        self.scale = scale
        self.emb = nn.Embedding(concept_num, concept_in_dim)
        self.cpt_transform = (nn.Linear(concept_in_dim, concept_out_dim)
                              if concept_in_dim != concept_out_dim else None)
        self.shard = None

    def forward(self, index: torch.Tensor) -> torch.Tensor:
        if self.shard is None:
            x = F.embedding(index.long(), self.emb.weight)
        else:
            from qagnn_tpu_torch.parallel.mesh import sum_shards
            local = index.long() - self.shard.start
            mine = (local >= 0) & (local < self.emb.weight.shape[0])
            x = F.embedding(torch.where(mine, local, 0), self.emb.weight)
            x = sum_shards(torch.where(mine[..., None], x, 0.0),
                           self.shard.group)
        x = x * self.scale
        if self.cpt_transform is not None:
            x = gelu(dense(x, self.cpt_transform))
        return x


class TypedLinear(nn.Module):
    """Per-type linear (reference utils/layers.py:25-44): one wide
    Linear(n_type * out), then each row's slice of its type."""

    def __init__(self, in_features: int, out_features: int, n_type: int):
        super().__init__()
        self.out_features, self.n_type = out_features, n_type
        self.wide = nn.Linear(in_features, n_type * out_features)

    def forward(self, x, type_ids=None):
        wide = dense(x, self.wide)
        if type_ids is None:
            return wide
        shaped = wide.reshape(*x.shape[:-1], self.n_type, self.out_features)
        idx = type_ids.long()[..., None, None].expand(
            *type_ids.shape, 1, self.out_features)
        return torch.gather(shaped, -2, idx).squeeze(-2)


class TypedMultiheadAttPoolLayer(nn.Module):
    """MultiheadAttPoolLayer with per-type key and value projections
    (reference utils/layers.py:374-422)."""

    def __init__(self, n_head: int, d_q_original: int, d_k_original: int,
                 dropout: float = 0.1, n_type: int = 1):
        super().__init__()
        assert d_k_original % n_head == 0
        self.n_head, self.dropout = n_head, dropout
        self.d_k = d_k_original // n_head
        self.w_qs = nn.Linear(d_q_original, n_head * self.d_k)
        self.w_ks = TypedLinear(d_k_original, n_head * self.d_k, n_type)
        self.w_vs = TypedLinear(d_k_original, n_head * self.d_k, n_type)
        self.attention = MatrixVectorScaledDotProductAttention(
            temperature=float(self.d_k) ** 0.5, groups=n_head)

    def forward(self, q, k, mask=None, type_ids=None):
        """q: (B, dq); k: (B, L, dk); mask: (B, L) True==masked out;
        type_ids: (B, L) int."""
        nh, d_k = self.n_head, self.d_k
        bs, len_k = k.shape[0], k.shape[1]
        qs = dense(q, self.w_qs).reshape(bs, nh, d_k)
        ks = self.w_ks(k, type_ids).reshape(bs, len_k, nh, d_k)
        vs = self.w_vs(k, type_ids).reshape(bs, len_k, nh, d_k)
        qs = qs.permute(1, 0, 2).reshape(nh * bs, d_k)
        ks = ks.permute(2, 0, 1, 3).reshape(nh * bs, len_k, d_k)
        vs = vs.permute(2, 0, 1, 3).reshape(nh * bs, len_k, d_k)
        if mask is not None:
            mask = mask.repeat(nh, 1)
        output, attn = self.attention(qs, ks, vs, mask)
        output = output.reshape(nh, bs, d_k).permute(1, 0, 2)
        output = dropout(output.reshape(bs, nh * d_k), self.dropout,
                         self.training)
        return output, attn


class BilinearAttentionLayer(nn.Module):
    """Bilinear attention pooling (reference utils/layers.py:425-446):
    attn = softmax(value W q), renormalized over the kept nodes AFTER the
    softmax."""

    def __init__(self, query_dim: int, value_dim: int):
        super().__init__()
        self.linear = nn.Linear(value_dim, query_dim, bias=False)

    def forward(self, query, value, node_mask=None):
        """query: (B, Dq); value: (B, L, Dv); node_mask: (B, L) 1==keep."""
        attn = torch.einsum("bld,bd->bl", dense(value, self.linear), query)
        attn = torch.softmax(attn, dim=1)
        if node_mask is not None:
            attn = attn * node_mask
            attn = attn / attn.sum(dim=1, keepdim=True)
        return torch.einsum("bl,bld->bd", attn, value), attn


class _DiffTopK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        idx = torch.topk(x, k, dim=1).indices
        return torch.zeros_like(x).scatter_(1, idx, 1.0)

    @staticmethod
    def backward(ctx, g):
        return g, None


def diff_topk(x: torch.Tensor, k: int) -> torch.Tensor:
    """Straight-through top-k indicator (reference utils/layers.py:489-509):
    a 0/1 mask of each row's k largest entries; the backward passes the
    upstream gradient through unchanged."""
    return _DiffTopK.apply(x, k)


def dot_product_similarity(a, b, scale_output: bool = False):
    """(..., D) x (..., D) -> (...) (reference utils/layers.py:530-540)."""
    result = torch.sum(a * b, dim=-1)
    return result / math.sqrt(a.shape[-1]) if scale_output else result


def matrix_attention(m1, m2, similarity=dot_product_similarity):
    """All-pairs similarity (reference utils/layers.py:553-569):
    (B, L1, D), (B, L2, D) -> (B, L1, L2)."""
    return similarity(m1[:, :, None, :], m2[:, None, :, :])


class TripleEncoder(nn.Module):
    """(h, r, t) triple encoder over a 3-step GRU, bidirectional by default
    (reference utils/layers.py:235-273). `gru_fwd` and `gru_bwd` are one
    direction each, as the flax module's two RNNs."""

    def __init__(self, emb_dim: int, hidden_dim: int, input_p: float = 0.0,
                 output_p: float = 0.0, bidirectional: bool = True):
        super().__init__()
        self.input_p, self.output_p = input_p, output_p
        self.bidirectional = bidirectional
        half = hidden_dim // 2 if bidirectional else hidden_dim
        self.gru_fwd = nn.GRU(emb_dim, half, batch_first=True)
        self.gru_bwd = nn.GRU(emb_dim, half, batch_first=True) \
            if bidirectional else None

    def forward(self, h_emb, r_emb, t_emb):
        """h_emb/r_emb/t_emb: (B, emb_dim). Returns (B, hidden_dim)."""
        seq = torch.stack([dropout(x, self.input_p, self.training)
                           for x in (h_emb, r_emb, t_emb)], dim=1)
        out = self.gru_fwd(seq)[0][:, -1]
        if self.gru_bwd is not None:
            out = torch.cat([out, self.gru_bwd(seq.flip(1))[0][:, -1]],
                            dim=1)
        return dropout(out, self.output_p, self.training)
