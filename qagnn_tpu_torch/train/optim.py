"""Optimizers and LR schedules with the reference's exact semantics.

Counterpart of qagnn_tpu/train/optim.py: the reference's RAdam (reference
utils/optimization_utils.py:8-97), the training script's parameter grouping
(encoder / decoder x decay / no decay, reference qagnn.py:172-180), the LR
schedules (reference qagnn.py:182-197), global-norm clipping (reference
qagnn.py:267-273) and the encoder freeze (reference qagnn.py:240-247).

A frozen group is skipped: its gradients take no part in the global norm and
its moments and step count do not advance, as torch skips parameters whose
gradient is None.

A row-sharded table (parallel.mesh.shard_params) holds one shard a model
rank: its squared norm is summed over the model group into the global norm,
so that each row counts once.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch
from torch import nn

OPTIMIZERS = ("radam", "adamw", "adam", "sgd")
B1, B2 = 0.9, 0.999


def make_lr_schedule(kind: str, warmup_steps: int = 0,
                     total_steps: int | None = None) -> Callable[[int], float]:
    """Multiplier in [0, 1] of the group lr at scheduler step `step`. The
    reference steps the scheduler BEFORE the optimizer each batch (reference
    qagnn.py:274-278), so the update that follows c earlier ones applies
    multiplier(c + 1); `TrainOptimizer` makes that shift."""
    if kind == "fixed":
        return lambda step: 1.0
    if kind == "warmup_constant":
        return lambda step: min(step / max(1.0, float(warmup_steps)), 1.0)
    if kind == "warmup_linear":
        assert total_steps is not None

        def sched(step):
            if step < warmup_steps:
                return step / max(1.0, float(warmup_steps))
            return max(0.0, (total_steps - step)
                       / max(1.0, float(total_steps - warmup_steps)))
        return sched
    raise ValueError(f"unknown lr schedule {kind!r}")


def no_decay_mask(names: Iterable[str]) -> dict[str, bool]:
    """name -> True where weight decay APPLIES, as
    qagnn_tpu/train/optim.py `no_decay_mask` decides it over the flax paths:
    not to a parameter whose name ends in `bias` (so neither to XLNet's
    r_w_bias / r_r_bias / r_s_bias nor to an LSTM cell's bias), not to the
    weight (flax's scale) of a LayerNorm under a module named `layernorm*`
    (the scorer's); BatchNorm scales do decay, and so do the encoders'
    LayerNorm weights (`*_ln`, `ln_*`, `layer_norm`), whose names that rule
    does not match."""
    def decays(name: str) -> bool:
        name = name.lower()
        if name.endswith("bias"):
            return False
        return not (name.rsplit(".", 1)[-1] == "weight"
                    and "layernorm" in name)
    return {n: decays(n) for n in names}


def encoder_mask(names: Iterable[str],
                 encoder_key: str = "encoder") -> dict[str, bool]:
    """name -> True for parameters under the encoder submodule."""
    return {n: n.split(".")[0] == encoder_key for n in names}


def _radam_scalars(t: int):
    """(use_rect, rect_step, sgd_step) after t steps (reference
    utils/optimization_utils.py:60-97): the variance rectification applies
    once N_sma >= 5, else the step degenerates to bias-corrected momentum
    SGD."""
    one_minus_b2t = -math.expm1(t * math.log(B2))
    b2t = 1.0 - one_minus_b2t
    n_sma_max = 2.0 / (1.0 - B2) - 1.0
    n_sma = n_sma_max - 2.0 * t * b2t / one_minus_b2t
    bias_corr1 = -math.expm1(t * math.log(B1))
    if n_sma < 5.0:
        return False, 0.0, 1.0 / bias_corr1
    rect = math.sqrt(one_minus_b2t * (n_sma - 4.0) / (n_sma_max - 4.0)
                     * (n_sma - 2.0) / n_sma * n_sma_max / (n_sma_max - 2.0))
    return True, rect / bias_corr1, 1.0 / bias_corr1


class TrainOptimizer:
    """Two-group optimizer (encoder lr / decoder lr) over a model's
    parameters with freeze gating, global-norm clipping and decoupled weight
    decay. `state` is a flat dict of tensors: `step`, `<group>.count`, and
    `<group>.mu.<name>` / `<group>.nu.<name>` per parameter (none for sgd)."""

    def __init__(self, model: nn.Module, *, optim: str = "radam",
                 encoder_lr: float = 1e-5, decoder_lr: float = 1e-3,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 lr_schedule: str = "fixed", warmup_steps: int = 0,
                 total_steps: int | None = None,
                 frozen: Iterable[str] = (), eps: float = 1e-8):
        if optim not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {optim!r}")
        self.optim, self.eps = optim, eps
        self.lr = {"encoder": encoder_lr, "decoder": decoder_lr}
        self.weight_decay, self.max_grad_norm = weight_decay, max_grad_norm
        self.sched = make_lr_schedule(lr_schedule, warmup_steps, total_steps)
        frozen = set(frozen)
        params = dict(model.named_parameters())
        unknown = frozen - set(params)
        if unknown:
            raise KeyError(f"frozen names not in the model: {sorted(unknown)}")
        for name in frozen:           # never updated: autograd skips them too
            params[name].requires_grad_(False)
        self.params = {n: p for n, p in params.items() if n not in frozen}
        from qagnn_tpu_torch.parallel.mesh import sharded_tables
        self.row_groups = {n: rs.group for n, rs in
                           sharded_tables(model).items()
                           if n in self.params and rs.group is not None}
        self.decays = no_decay_mask(self.params)
        is_enc = encoder_mask(self.params)
        self.groups = {g: [n for n in self.params if is_enc[n] == (g == "encoder")]
                       for g in ("encoder", "decoder")}
        self.state: dict[str, torch.Tensor] = {
            "step": torch.zeros((), dtype=torch.int64)}
        for g, names in self.groups.items():
            self.state[f"{g}.count"] = torch.zeros((), dtype=torch.int64)
            if optim != "sgd":
                for n in names:
                    for m in ("mu", "nu"):
                        self.state[f"{g}.{m}.{n}"] = torch.zeros_like(
                            self.params[n], dtype=torch.float32)
        self.last_grad_norm: torch.Tensor | None = None

    def to(self, device) -> "TrainOptimizer":
        """Move the moments to `device` (the counts stay on the host, where
        the schedule and the RAdam scalars are computed)."""
        for key, t in self.state.items():
            if ".mu." in key or ".nu." in key:
                self.state[key] = t.to(device)
        return self

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def _sharded_norm(self, active: list, norms: torch.Tensor):
        """The global norm from per-tensor norms (in the order of the active
        groups' names), each row-sharded table's square summed over its
        group."""
        from qagnn_tpu_torch.parallel.mesh import all_reduce
        names = [n for g in active for n in self.groups[g]]
        sq = norms.square()
        total = sq.sum()
        for i, n in enumerate(names):
            if n in self.row_groups:
                total = total - sq[i] + all_reduce(sq[i].clone(),
                                                   self.row_groups[n])
        return torch.sqrt(total)

    def _directions(self, group: str, grads: list, t: int) -> list:
        """The step directions of a group's parameters before weight decay
        and lr, as per-tensor code would compute them, op for op."""
        if self.optim == "sgd":
            return grads
        names = self.groups[group]
        mu = [self.state[f"{group}.mu.{n}"] for n in names]
        nu = [self.state[f"{group}.nu.{n}"] for n in names]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - B2)
        if self.optim == "radam":
            use_rect, rect_step, sgd_step = _radam_scalars(t)
            if not use_rect:
                return torch._foreach_mul(mu, sgd_step)
            denom = torch._foreach_sqrt(nu)
            torch._foreach_add_(denom, self.eps)          # eps outside
            d = torch._foreach_div(mu, denom)
            torch._foreach_mul_(d, rect_step)
            return d
        # adam / adamw: bias-corrected moments, eps outside the sqrt
        d = torch._foreach_div(mu, 1.0 - B1 ** t)
        denom = torch._foreach_div(nu, 1.0 - B2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(d, denom)
        return d

    @torch.no_grad()
    def step(self, encoder_trainable: bool = True) -> None:
        """Apply the accumulated `.grad`s (which it leaves as they are),
        one multi-tensor pass (`torch._foreach_*`) per operation and group.
        With encoder_trainable False the encoder group is skipped whole,
        whatever its gradients hold."""
        active = [g for g in ("encoder", "decoder")
                  if g == "decoder" or encoder_trainable]
        params = {g: [self.params[n] for n in self.groups[g]] for g in active}
        grads = {g: [torch.zeros_like(p, dtype=torch.float32)
                     if p.grad is None else p.grad.float() for p in ps]
                 for g, ps in params.items()}
        trained = [x for g in active for x in grads[g]]
        # one global norm over everything that is trained; the clip scale
        # stays on the device
        if self.max_grad_norm and self.max_grad_norm > 0 and trained:
            norms = torch.stack(torch._foreach_norm(trained))
            gnorm = torch.linalg.vector_norm(norms) if not self.row_groups \
                else self._sharded_norm(active, norms)
            self.last_grad_norm = gnorm
            scale = torch.clamp_max(self.max_grad_norm / (gnorm + 1e-6), 1.0)
            grads = {g: torch._foreach_mul(gs, scale)
                     for g, gs in grads.items()}
        for g in active:
            count = self.state[f"{g}.count"]
            count += 1
            t = int(count)
            lr = self.lr[g] * self.sched(t)
            d = self._directions(g, grads[g], t)
            if self.weight_decay:
                idx = [i for i, n in enumerate(self.groups[g])
                       if self.decays[n]]
                if idx:
                    # d + wd * p, out of place: sgd's directions are the
                    # gradients themselves
                    decayed = torch._foreach_add(
                        [d[i] for i in idx], torch._foreach_mul(
                            [params[g][i] for i in idx], self.weight_decay))
                    d = list(d)
                    for i, x in zip(idx, decayed):
                        d[i] = x
            # the port's parameters are all f32; a list that mixed dtypes
            # would still be right, one tensor at a time
            torch._foreach_add_(params[g], [x.to(p.dtype) for p, x in
                                            zip(params[g], d)], alpha=-lr)
        self.state["step"] += 1


def build_train_optimizer(model: nn.Module, **kwargs) -> TrainOptimizer:
    """The reference training optimizer (qagnn.py:168-197) for a model whose
    top level splits into `encoder` and `decoder`. Keyword arguments as
    `TrainOptimizer`; `frozen` names parameters that are never updated (the
    entity table, see `entity_table_names`)."""
    return TrainOptimizer(model, **kwargs)


def entity_table_names(model: nn.Module) -> list[str]:
    """The pretrained entity table's parameter names (reference
    --freeze_ent_emb, qagnn.py:63)."""
    return [n for n, _ in model.named_parameters()
            if "concept_emb.emb." in n]
