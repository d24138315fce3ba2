"""LSTM sentence encoder (the reference's legacy encoder family).

Counterpart of qagnn_tpu/models/lstm_encoder.py (reference
modeling/modeling_encoder.py:35-86, LSTMTextEncoder): an f32 word embedding
with EmbeddingDropout (whole vocabulary rows dropped), input dropout, a
stack of (bi)LSTM layers whose padded steps are zeroed after each layer,
RNNDropout between layers (one mask per row and feature, shared over time)
and masked max or mean pooling over each row's real length. It returns the
pooled vector (with `return_all_hidden`, also the hidden states).

Each layer is one call of `torch.lstm`, the op nn.LSTM runs (cuDNN on the
card), over `pack_padded_sequence`: each direction runs over each row's own
length, so the reverse direction starts at the row's last real token, as
flax's `RNN(reverse=True, keep_order=True)` with `seq_lengths` does. The
weights are per direction, in `OptimizedLSTMCell_{n}` modules named as
the flax cells are (n = 2 * layer + direction, or the layer when one-way):
flax has one bias per gate where nn.LSTM has two, so the call gets zeros
for the input bias and the module trains exactly the flax leaves. The LSTM
ignores `layer_id` and always computes in f32, as the JAX module does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

from qagnn_tpu_torch.models.layers import dropout


@dataclass(frozen=True)
class LSTMConfig:
    """The CLI's LSTM config (reference run defaults:
    modeling/modeling_encoder.py:38-41). `hidden_size` names the sentence
    vector's width (the last layer's output size), so that the CLI reads
    the sentence width the same way for every encoder family."""
    vocab_size: int = 1
    emb_size: int = 300
    lstm_hidden_size: int = 300
    hidden_size: int = 300       # output_size == sent_dim
    num_layers: int = 2
    bidirectional: bool = True
    emb_p: float = 0.0
    input_p: float = 0.0
    hidden_p: float = 0.0
    pool_function: str = "max"
    dtype: torch.dtype = torch.float32   # accepted for uniformity; unused

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 64)
        kw.setdefault("emb_size", 16)
        kw.setdefault("lstm_hidden_size", 16)
        kw.setdefault("hidden_size", 16)
        return cls(**kw)


class LSTMCellParams(nn.Module):
    """One direction of one layer: `weight_ih` (4H, in) and `weight_hh`
    (4H, H) in torch's gate order i, f, g, o, and one `bias` (4H,), the
    flax cell's hidden-kernel biases."""

    def __init__(self, in_size: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))

    def flat_weights(self) -> list[torch.Tensor]:
        """[w_ih, w_hh, b_ih, b_hh] as torch.lstm takes them, the input
        bias zero."""
        return [self.weight_ih, self.weight_hh, torch.zeros_like(self.bias),
                self.bias]


def masked_max_pool(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, L, D), (B,) -> (B, D) max over the first `lengths` positions
    (reference MaxPoolLayer, utils/layers.py:115-130)."""
    mask = torch.arange(h.shape[1], device=h.device)[None, :] \
        < lengths[:, None]
    return torch.where(mask[:, :, None], h, -torch.inf).amax(dim=1)


def masked_mean_pool(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, L, D), (B,) -> (B, D) mean over the first `lengths` positions
    (reference MeanPoolLayer, utils/layers.py:90-105)."""
    mask = (torch.arange(h.shape[1], device=h.device)[None, :]
            < lengths[:, None]).to(h.dtype)
    return torch.sum(h * mask[:, :, None], dim=1) \
        / torch.clamp(lengths[:, None].to(h.dtype), min=1.0)


class LSTMTextEncoder(nn.Module):
    def __init__(self, vocab_size: int = 1, emb_size: int = 300,
                 hidden_size: int = 300, output_size: int = 300,
                 num_layers: int = 2, bidirectional: bool = True,
                 emb_p: float = 0.0, input_p: float = 0.0,
                 hidden_p: float = 0.0, pool_function: str = "max"):
        super().__init__()
        if bidirectional and (hidden_size % 2 or output_size % 2):
            raise ValueError("a bidirectional LSTM needs even widths, got "
                             f"{hidden_size} and {output_size}")
        if pool_function not in ("max", "mean"):
            raise ValueError(f"unknown pool_function {pool_function!r}")
        self.num_layers, self.bidirectional = num_layers, bidirectional
        self.emb_p, self.input_p, self.hidden_p = emb_p, input_p, hidden_p
        self.pool_function = pool_function
        self.emb = nn.Embedding(vocab_size, emb_size)
        n_dirs = 2 if bidirectional else 1
        in_size = emb_size
        for layer in range(num_layers):
            out = output_size if layer == num_layers - 1 else hidden_size
            for d in range(n_dirs):
                self.add_module(f"OptimizedLSTMCell_{n_dirs * layer + d}",
                                LSTMCellParams(in_size, out // n_dirs))
            in_size = out

    @classmethod
    def from_config(cls, cfg: LSTMConfig):
        return cls(vocab_size=cfg.vocab_size, emb_size=cfg.emb_size,
                   hidden_size=cfg.lstm_hidden_size,
                   output_size=cfg.hidden_size, num_layers=cfg.num_layers,
                   bidirectional=cfg.bidirectional, emb_p=cfg.emb_p,
                   input_p=cfg.input_p, hidden_p=cfg.hidden_p,
                   pool_function=cfg.pool_function)

    def forward(self, input_ids, lengths, *, layer_id: int = -1,
                return_all_hidden: bool = False):
        """input_ids: (B, L); lengths: (B,), each at least 1. `layer_id` is
        accepted for uniformity and ignored: the reference's layer_id only
        acts on the other encoders (modeling/modeling_encoder.py:110-113).
        Returns pooled (B, output_size) [, tuple of num_layers + 1 hidden
        states]."""
        del layer_id
        B, L = input_ids.shape
        ids = input_ids.long()
        h = F.embedding(ids, self.emb.weight)
        if self.training and self.emb_p > 0:
            # EmbeddingDropout: whole vocabulary rows (reference
            # utils/layers.py:150-172)
            rows = dropout(h.new_ones(self.emb.num_embeddings), self.emb_p,
                           True)
            h = h * rows[ids][..., None]
        h = dropout(h, self.input_p, self.training)

        mask = torch.arange(L, device=h.device)[None, :] < lengths[:, None]
        host_lengths = lengths.to("cpu", torch.int64)   # pack reads them there
        n_dirs = 2 if self.bidirectional else 1
        all_hidden = [h]
        for layer in range(self.num_layers):
            packed = pack_padded_sequence(h, host_lengths, batch_first=True,
                                          enforce_sorted=False)
            cells = [getattr(self, f"OptimizedLSTMCell_{n_dirs * layer + d}")
                     for d in range(n_dirs)]
            weights = [w for cell in cells for w in cell.flat_weights()]
            zeros = h.new_zeros(n_dirs, B, cells[0].weight_hh.shape[1])
            out, _, _ = torch.lstm(packed.data, packed.batch_sizes,
                                   (zeros, zeros), weights, True, 1, 0.0,
                                   self.training, self.bidirectional)
            h, _ = pad_packed_sequence(
                packed._replace(data=out), batch_first=True,
                total_length=L)
            h = torch.where(mask[:, :, None], h, 0.0)
            all_hidden.append(h)
            if layer != self.num_layers - 1:
                # RNNDropout: one mask per (row, feature), shared over time
                # (reference utils/layers.py:175-186)
                h = dropout(h, self.hidden_p, self.training,
                            mask_shape=(B, 1, h.shape[-1]))

        pool = masked_max_pool if self.pool_function == "max" \
            else masked_mean_pool
        pooled = pool(all_hidden[-1], lengths)
        if return_all_hidden:
            return pooled, tuple(all_hidden)
        return pooled
