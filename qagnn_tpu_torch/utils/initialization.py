"""Seeded random initialisation of the port's modules.

Weights and embeddings are drawn from normal(0, init_std), as the JAX
package's `normal_init` draws them, and so are XLNet's attention tensors
(flax and HF draw them from normal(0, 0.02)); biases are zero, norm scales
one and BatchNorm running statistics (0, 1). An LSTM cell follows flax's
OptimizedLSTMCell: input kernels LeCun-normal (std 1/sqrt(fan_in)), each
gate's hidden kernel orthogonal, biases zero. The draws come from the given
torch.Generator, which must live on the modules' device.
"""

from __future__ import annotations

import torch
from torch import nn

from qagnn_tpu_torch.models.layers import ProjParams
from qagnn_tpu_torch.models.lstm_encoder import LSTMCellParams
from qagnn_tpu_torch.models.norm import MaskedBatchNorm
from qagnn_tpu_torch.models.xlnet_encoder import (
    RAW_PARAMS,
    XLNetRelativeAttention,
)


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
        elif isinstance(mod, XLNetRelativeAttention):
            for name in RAW_PARAMS:
                getattr(mod, name).normal_(0.0, init_std, generator=generator)
        elif isinstance(mod, LSTMCellParams):
            w_ih, w_hh = mod.weight_ih, mod.weight_hh
            w_ih.normal_(0.0, w_ih.shape[1] ** -0.5, generator=generator)
            for gate in w_hh.chunk(4):
                nn.init.orthogonal_(gate, generator=generator)
            mod.bias.zero_()
    return model
