"""Loss functions (reference qagnn.py:208-224).

Counterpart of qagnn_tpu/train/losses.py.
"""

from __future__ import annotations

import torch


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over answer choices. logits: (B, C);
    labels: (B,) int (reference qagnn.py:211,222-223)."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0].mean()


def margin_rank_loss(logits: torch.Tensor, labels: torch.Tensor,
                     margin: float = 0.1) -> torch.Tensor:
    """Margin ranking loss between the correct choice and each wrong one:
    the mean over B * (C - 1) pairs of max(0, margin - correct + wrong)
    (reference qagnn.py:209,214-221)."""
    b, c = logits.shape
    idx = labels.long()[:, None]
    correct = torch.gather(logits, 1, idx)                         # (B, 1)
    wrong = torch.ones_like(logits, dtype=torch.bool).scatter_(1, idx, False)
    losses = torch.clamp_min(margin - correct + logits, 0.0)
    return torch.where(wrong, losses, 0.0).sum() / (b * (c - 1))


LOSSES = {
    "cross_entropy": cross_entropy_loss,
    "margin_rank": margin_rank_loss,
}
