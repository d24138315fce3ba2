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


@contextlib.contextmanager
def dropout_generator(generator: torch.Generator | None):
    """Within the block every `dropout` draws its mask from `generator`
    (which lives on the tensors' device), so that a train step is a function
    of its seed. None: torch's global generator."""
    global _DROPOUT_GENERATOR
    previous, _DROPOUT_GENERATOR = _DROPOUT_GENERATOR, generator
    try:
        yield
    finally:
        _DROPOUT_GENERATOR = previous


def dropout(x: torch.Tensor, p: float, training: bool,
            mask_shape: tuple[int, ...] | None = None) -> torch.Tensor:
    """Inverted dropout: in training, zero each element with probability p
    and scale the rest by 1 / (1 - p); else the identity. `mask_shape`
    draws a mask of that shape, broadcast over x (flax Dropout's
    `broadcast_dims`: one mask per row and feature, shared over time)."""
    if not training or p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = torch.empty_like(x) if mask_shape is None \
        else x.new_empty(mask_shape)
    keep.bernoulli_(1.0 - p, generator=_DROPOUT_GENERATOR)
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

    def __init__(self, temperature: float, attn_dropout: float = 0.1):
        super().__init__()
        self.temperature = temperature
        self.attn_dropout = attn_dropout

    def forward(self, q, k, v, mask=None):
        """q: (B, Dk); k: (B, L, Dk); v: (B, L, Dv); mask: (B, L) True==drop."""
        attn = torch.sum(q[:, None, :] * k, dim=2) / self.temperature
        attn = masked_softmax(attn, mask)
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
            temperature=float(self.d_k) ** 0.5)

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
    (reference utils/layers.py:571-607)."""

    def __init__(self, concept_num: int, concept_in_dim: int,
                 concept_out_dim: int, scale: float = 1.0):
        super().__init__()
        self.scale = scale
        self.emb = nn.Embedding(concept_num, concept_in_dim)
        self.cpt_transform = (nn.Linear(concept_in_dim, concept_out_dim)
                              if concept_in_dim != concept_out_dim else None)

    def forward(self, index: torch.Tensor) -> torch.Tensor:
        x = F.embedding(index.long(), self.emb.weight) * self.scale
        if self.cpt_transform is not None:
            x = gelu(dense(x, self.cpt_transform))
        return x
