"""RoBERTa's masked-LM head on the port's TextEncoder.

The counterpart of the HF `RobertaLMHead` that the reference's relevance
scorer runs (reference utils/graph.py:254-313, RobertaForMaskedLM): logits =
decoder(LayerNorm(gelu(dense(h)))) + bias over the last hidden states. The
activation is the exact (erf) gelu whatever the config's `hidden_act`, as
HF's head hard-codes it. The decoder weight is tied to the encoder's
`word_embeddings` whenever the checkpoint carries no decoder weight of its
own (HF's save_pretrained leaves tied weights out). Plain torch ops: the JAX
package computes this head outside any kernel too.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from qagnn_tpu_torch.models.hf_loading import load_mlm_checkpoint
from qagnn_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig


class MLMHead(nn.Module):
    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        d = cfg.hidden_size
        self.dense = nn.Linear(d, d)
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.decoder = nn.Linear(d, cfg.vocab_size)

    def forward(self, h):
        x = F.gelu(self.dense(h))
        return self.decoder(self.layer_norm(x))


class MaskedLM(nn.Module):
    """TextEncoder + MLMHead: (B, L, vocab) logits of the last hidden
    states. `tied` shares the decoder's weight with `word_embeddings`."""

    def __init__(self, cfg: TextEncoderConfig, tied: bool = True):
        super().__init__()
        self.encoder = TextEncoder(cfg)
        self.head = MLMHead(cfg)
        if tied:
            self.head.decoder.weight = self.encoder.word_embeddings.weight

    def forward(self, input_ids, attention_mask, token_type_ids=None):
        _, hidden = self.encoder(input_ids, attention_mask, token_type_ids,
                                 return_all_hidden=True)
        return self.head(hidden[-1])


def load_masked_lm(src: str, fallback_config=None) -> MaskedLM:
    """An f32 MaskedLM in eval mode on the CPU from an HF RobertaForMaskedLM
    checkpoint (the sources `models.hf_loading.load_mlm_checkpoint` reads).
    An encoder weight the checkpoint lacks raises, except the pooler, which
    MLM checkpoints do not have and the head does not read."""
    cfg, enc_params, head_params = load_mlm_checkpoint(
        src, fallback_config=fallback_config)
    model = MaskedLM(cfg, tied="decoder.weight" not in head_params)
    missing, unexpected = model.encoder.load_state_dict(enc_params,
                                                        strict=False)
    missing = [k for k in missing if not k.startswith("pooler.")]
    if missing or unexpected:
        raise ValueError(f"{src!r}: encoder weights missing {missing[:5]}, "
                         f"unexpected {unexpected[:5]}")
    missing, unexpected = model.head.load_state_dict(head_params,
                                                     strict=False)
    if "decoder.weight" not in head_params:
        missing = [k for k in missing if k != "decoder.weight"]
    if missing or unexpected:
        raise ValueError(f"{src!r}: lm_head weights missing {missing}, "
                         f"unexpected {unexpected}")
    return model.eval()
