"""The entry points: a train step, an eval step and a detail step over
batches.

Counterpart of `make_train_step`, `make_eval_step`, `make_detail_step`,
`Batch`, `_merge_pretrained` and `accuracy` in qagnn_tpu/train/step.py
(reference hot loop qagnn.py:243-278): LM forward, GNN forward, loss,
backward, global-norm clipping and the two-group optimizer update, with
gradient accumulation over microbatches and the encoder freeze.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.models.layers import dropout_generator
from qagnn_tpu_torch.train.losses import LOSSES
from qagnn_tpu_torch.train.optim import TrainOptimizer
from qagnn_tpu_torch.utils.config import resolve_device


class Batch(NamedTuple):
    """One training batch: LM inputs (B, C, L), graphs (G = B * C), labels
    (B,)."""
    lm_inputs: dict
    graph: BatchedGraphs
    labels: torch.Tensor


def _microbatch(batch: Batch, i: int, n: int) -> Batch:
    def cut(x):
        return x.reshape((n, -1) + tuple(x.shape[1:]))[i]
    return Batch({k: cut(v) for k, v in batch.lm_inputs.items()},
                 BatchedGraphs(**{f.name: cut(getattr(batch.graph, f.name))
                                  for f in dataclasses.fields(batch.graph)}),
                 cut(batch.labels))


@torch.no_grad()
def _merge_pretrained(model: torch.nn.Module,
                      pretrained: dict[str, torch.Tensor]) -> None:
    """Copy pretrained tensors (the entity table, the LM's weights), keyed by
    parameter name, into `model`'s parameters, each cast to the parameter's
    dtype and device."""
    params = dict(model.named_parameters())
    for name, value in pretrained.items():
        if name not in params:
            raise KeyError(f"pretrained key {name!r} not in the model")
        p = params[name]
        if tuple(p.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch for {name!r}: "
                             f"{tuple(p.shape)} vs {tuple(value.shape)}")
        p.copy_(torch.as_tensor(value))


def make_train_step(model: torch.nn.Module, optimizer: TrainOptimizer,
                    device=None, *, loss_name: str = "cross_entropy",
                    num_microbatches: int = 1,
                    encoder_layer_id: int = -1) -> Callable:
    """Train step on `device` (the card unless the caller names another;
    raises when there is none): moves the model and the optimizer's moments
    there and puts the model in train mode (batch statistics, dropout).

    train_step(batch, encoder_trainable=True, generator=None) runs forward,
    loss, backward, clipping and the update, and returns {"loss": ...}.
    `num_microbatches` splits the leading batch axis (B must divide evenly):
    the microbatches run in sequence, each updating the BatchNorm running
    statistics, each loss scaled by 1 / num_microbatches, their gradients
    accumulated (reference qagnn.py:252-266). With encoder_trainable False
    the encoder runs without a graph, so no encoder backward is paid, and
    the optimizer skips the encoder group (reference freeze_net,
    qagnn.py:240). Dropout masks come from `generator`, which lives on the
    device: the step is a function of the generator's state."""
    dev = resolve_device(device)
    model.to(dev).train()
    optimizer.to(dev)
    loss_fn = LOSSES[loss_name]
    encoder_params = [p for n, p in model.named_parameters()
                      if n.split(".")[0] == "encoder"]

    def train_step(batch: Batch, encoder_trainable: bool = True,
                   generator: torch.Generator | None = None) -> dict:
        batch = Batch({k: v.to(dev, non_blocking=True)
                       for k, v in batch.lm_inputs.items()},
                      batch.graph.to(dev, non_blocking=True),
                      batch.labels.to(dev, non_blocking=True))
        model.train()
        optimizer.zero_grad()
        was = [p.requires_grad for p in encoder_params]
        if not encoder_trainable:
            for p in encoder_params:
                p.requires_grad_(False)
        try:
            total = torch.zeros((), device=dev)
            with dropout_generator(generator):
                for i in range(num_microbatches):
                    mb = batch if num_microbatches == 1 else _microbatch(
                        batch, i, num_microbatches)
                    logits = model(mb.lm_inputs, mb.graph,
                                   layer_id=encoder_layer_id)
                    loss = loss_fn(logits.float(), mb.labels) \
                        / num_microbatches
                    loss.backward()
                    total += loss.detach()
        finally:
            for p, r in zip(encoder_params, was):
                p.requires_grad_(r)
        optimizer.step(encoder_trainable)
        return {"loss": total}

    return train_step


def _make_forward_step(model, device, **forward_args) -> Callable:
    dev = resolve_device(device)
    model.to(dev).eval()

    @torch.inference_mode()
    def step(lm_inputs: dict, graph: BatchedGraphs):
        model.eval()
        lm = {k: v.to(dev, non_blocking=True) for k, v in lm_inputs.items()}
        return model(lm, graph.to(dev, non_blocking=True), **forward_args)

    return step


def make_eval_step(model: torch.nn.Module, device=None, *,
                   encoder_layer_id: int = -1) -> Callable:
    """Eval step on `device` (the card unless the caller names another;
    raises when there is none): moves the model there; each call puts it in
    eval mode (BatchNorm running statistics, no dropout) and maps
    (lm_inputs (B, C, L) dict, graph) to logits (B, C) under
    torch.inference_mode()."""
    return _make_forward_step(model, device, layer_id=encoder_layer_id)


def make_detail_step(model: torch.nn.Module, device=None, *,
                     encoder_layer_id: int = -1) -> Callable:
    """Detail eval step (reference modeling/modeling_qagnn.py:236-241),
    built as `make_eval_step`: maps (lm_inputs, graph) to (logits (B, C),
    pooler attention (n_head*G, N), (edge alphas (k, G, E, H), self alphas
    (k, G, N, H))). The graph tensors that the reference echoes back are in
    the caller's BatchedGraphs. The attention weights exist only on the
    scatter arm of the attention op, so this step launches no GAT kernel."""
    return _make_forward_step(model, device, layer_id=encoder_layer_id,
                              detail=True)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of questions whose argmax choice is the label (reference
    qagnn.py:30-38 evaluate_accuracy)."""
    return (logits.argmax(dim=1) == labels).float().mean()
