"""The serving entry point: an eval step that maps a batch to logits.

Counterpart of `make_eval_step` and `accuracy` in qagnn_tpu/train/step.py
(the path `bench.py --mode driver --infer` times on the JAX side).
"""

from __future__ import annotations

from typing import Callable

import torch

from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.utils.config import resolve_device


def make_eval_step(model: torch.nn.Module, device=None, *,
                   encoder_layer_id: int = -1) -> Callable:
    """Eval step on `device` (the card unless the caller names another;
    raises when there is none): moves the model there and puts it in eval
    mode (BatchNorm running statistics, no dropout), then maps
    (lm_inputs (B, C, L) dict, graph) to logits (B, C) under
    torch.inference_mode()."""
    dev = resolve_device(device)
    model.to(dev).eval()

    @torch.inference_mode()
    def eval_step(lm_inputs: dict, graph: BatchedGraphs) -> torch.Tensor:
        lm = {k: v.to(dev, non_blocking=True) for k, v in lm_inputs.items()}
        return model(lm, graph.to(dev), layer_id=encoder_layer_id)

    return eval_step


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of questions whose argmax choice is the label (reference
    qagnn.py:30-38 evaluate_accuracy)."""
    return (logits.argmax(dim=1) == labels).float().mean()
