"""Seeded random initialisation of the port's modules.

Weights and embeddings are drawn from normal(0, init_std), as the JAX
package's `normal_init` draws them; biases are zero, norm scales one and
BatchNorm running statistics (0, 1). The draws come from the given
torch.Generator, which must live on the modules' device.
"""

from __future__ import annotations

import torch
from torch import nn

from qagnn_tpu_torch.models.layers import ProjParams
from qagnn_tpu_torch.models.norm import MaskedBatchNorm


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator,
                 init_std: float = 0.02) -> nn.Module:
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, ProjParams)):
            w = mod.weight if isinstance(mod, nn.Linear) else mod.kernel
            w.normal_(0.0, init_std, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, init_std, generator=generator)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, MaskedBatchNorm):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
            mod.mean.zero_()
            mod.var.fill_(1.0)
    return model
