"""Masked BatchNorm with torch.nn.BatchNorm1d-compatible semantics.

Counterpart of qagnn_tpu/models/norm.py. Padded rows are excluded from the
batch statistics by weight, not by shape:

  * normalization uses the BIASED batch variance,
  * the running variance is updated with the UNBIASED one (n / (n - 1)),
  * running <- (1 - momentum) * running + momentum * batch, momentum 0.1,
    folded `num_updates` times (the shared edge encoder is one call for k
    identical reference calls),
  * eval mode normalizes with the running statistics.

With a `mesh` the rows are data slice d of a batch split over its data
ranks (parallel/mesh.py), and the batch statistics are those of the whole
batch, as GSPMD takes them: the row sums of the array parts are summed
over the data group by a differentiable all_reduce (`sum_over`), and
pre-reduced MomentParts come in already global. Every rank then updates
its running statistics alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn


class MomentPart(NamedTuple):
    """Pre-reduced contribution to the batch statistic: f32 row sums
    s1 = sum(x), s2 = sum(x^2) (features,) and the row count n."""

    s1: torch.Tensor
    s2: torch.Tensor
    n: torch.Tensor


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5, num_updates: int = 1, mesh=None):
        super().__init__()
        self.group = None if mesh is None else mesh.data_group
        self.features = features
        self.momentum = momentum
        self.eps = eps
        self.num_updates = num_updates
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def _batch_stats(self, array_parts, moment_parts):
        from qagnn_tpu_torch.parallel.mesh import sum_over
        f32 = torch.float32
        dev = self.mean.device
        n = torch.zeros((), dtype=f32, device=dev)
        s1 = torch.zeros(self.features, dtype=f32, device=dev)
        for xi, wi in array_parts:
            x32 = xi.float()
            if wi is None:
                n = n + x32.shape[0]
                s1 = s1 + x32.sum(0)
            else:
                w = wi.float()
                n = n + w.sum()
                s1 = s1 + (x32 * w[:, None]).sum(0)
        if self.group is not None:
            ns1 = sum_over(torch.cat([n.reshape(1), s1]), self.group)
            n, s1 = ns1[0], ns1[1:]
        for mp in moment_parts:
            n = n + mp.n
            s1 = s1 + mp.s1
        n = torch.clamp_min(n, 1.0)
        mean = s1 / n
        s2 = torch.zeros(self.features, dtype=f32, device=dev)
        for xi, wi in array_parts:
            # one-pass E[x^2] - mean^2 when pre-reduced moments take part,
            # else the two-pass centred form
            d2 = torch.square(xi.float()) if moment_parts \
                else torch.square(xi.float() - mean)
            s2 = s2 + (d2.sum(0) if wi is None
                       else (d2 * wi.float()[:, None]).sum(0))
        s2 = sum_over(s2, self.group)
        if moment_parts:
            for mp in moment_parts:
                s2 = s2 + mp.s2
            var = torch.clamp_min(s2 / n - torch.square(mean), 0.0)
        else:
            var = s2 / n
        return mean, var, n

    def forward(self, x, weight=None, return_affine: bool = False):
        """x: (rows, features), or a list of parts sharing ONE statistic; a
        part is (x_i, weight_i) or a MomentPart (whose output is None).
        Weights only mask statistics; every row is normalized.

        return_affine: also return the folded f32 affine
        (a, b) = (scale * inv, bias - mean * scale * inv)."""
        multi = isinstance(x, (tuple, list)) and not isinstance(x, MomentPart)
        parts = list(x) if multi else [(x, weight)]
        moment_parts = [p for p in parts if isinstance(p, MomentPart)]
        array_parts = [p for p in parts if not isinstance(p, MomentPart)]

        if self.training:
            mean, var, n = self._batch_stats(array_parts, moment_parts)
            with torch.no_grad():
                unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
                decay = (1.0 - self.momentum) ** self.num_updates
                self.mean.mul_(decay).add_((1.0 - decay) * mean)
                self.var.mul_(decay).add_((1.0 - decay) * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps)

        def norm(xi):
            if xi.dtype == torch.float32:
                return (xi - mean) * inv * self.scale + self.bias
            # low-precision rows: one per-feature scale/shift folded and
            # applied in the row dtype (qagnn_tpu/models/norm.py:164-166)
            a = (inv * self.scale).to(xi.dtype)
            b = (self.bias - mean * inv * self.scale).to(xi.dtype)
            return xi * a + b

        outs = [None if isinstance(p, MomentPart) else norm(p[0])
                for p in parts]
        result = outs if multi else outs[0]
        if return_affine:
            a32 = inv * self.scale
            return result, (a32, self.bias - mean * a32)
        return result
