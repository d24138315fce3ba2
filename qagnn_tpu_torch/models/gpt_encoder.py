"""GPT (OpenAI GPT-1) text encoder with the reference's pooled output.

Counterpart of qagnn_tpu/models/gpt_encoder.py (`GPTConfig`, `GPTBlock`,
`GPTTextEncoder`; reference modeling/modeling_encoder.py:28,89-143, the
'gpt' model type): learned positions, a causal mask, post-LN blocks
n = LN(x + Attn(x)); h = LN(n + MLP(n)), tanh-approximated GELU, and the
pooled vector hidden[layer_id] gathered at `cls_token_ids`, the _classify_
token of the GPT statement layout (reference utils/data_utils.py:203-281).
The causal mask is HF OpenAIGPT's w * tril - 1e4 * (1 - tril) after the
scaling: the -1e4 lets a softmax epsilon through to later positions, and
parity with converted checkpoints depends on it. Plain torch ops, as the
JAX package computes the encoder outside any kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qagnn_tpu_torch.models.layers import dense, dropout
from qagnn_tpu_torch.models.text_encoder import _layer_norm


@dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 40481     # 40478 BPE + 3 special tokens (_start_ etc.)
    n_positions: int = 512
    hidden_size: int = 768      # n_embd
    num_layers: int = 12
    num_heads: int = 12
    layer_norm_eps: float = 1e-5
    embd_dropout: float = 0.1
    attn_dropout: float = 0.1
    resid_dropout: float = 0.1
    dtype: torch.dtype = torch.float32   # compute dtype

    @classmethod
    def openai_gpt(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 97)
        kw.setdefault("n_positions", 40)
        kw.setdefault("hidden_size", 32)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 2)
        return cls(**kw)


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.c_attn = nn.Linear(d, 3 * d)
        self.c_proj = nn.Linear(d, d)
        self.ln_1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp_fc = nn.Linear(d, 4 * d)
        self.mlp_proj = nn.Linear(4 * d, d)
        self.ln_2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x, causal):
        cfg = self.cfg
        d, nh = cfg.hidden_size, cfg.num_heads
        dh = d // nh
        B, L, _ = x.shape
        q, k, v = (t.reshape(B, L, nh, dh) for t in
                   dense(x, self.c_attn, cfg.dtype).split(d, dim=-1))
        # f32 logits and softmax whatever the compute dtype
        w = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) \
            / np.sqrt(dh)
        w = w * causal + (-1e4) * (1.0 - causal)
        w = torch.softmax(w, dim=-1).to(cfg.dtype)
        w = dropout(w, cfg.attn_dropout, self.training)
        a = torch.einsum("bhlm,bmhd->blhd", w, v).reshape(B, L, d)
        a = dropout(dense(a, self.c_proj, cfg.dtype), cfg.resid_dropout,
                    self.training)
        n = _layer_norm(x + a, self.ln_1, cfg.dtype)
        m = F.gelu(dense(n, self.mlp_fc, cfg.dtype), approximate="tanh")
        m = dropout(dense(m, self.mlp_proj, cfg.dtype), cfg.resid_dropout,
                    self.training)
        return _layer_norm(n + m, self.ln_2, cfg.dtype)


class GPTTextEncoder(nn.Module):
    """GPT encoder with the reference's cls-token-gather pooling contract
    (reference modeling/modeling_encoder.py:119-121,131-133)."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        self.tokens_embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.positions_embed = nn.Embedding(cfg.n_positions, cfg.hidden_size)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", GPTBlock(cfg))

    def forward(self, input_ids, cls_token_ids, lm_labels=None, *,
                layer_id: int = -1, return_all_hidden: bool = False):
        """input_ids: (B, L); cls_token_ids: (B,), the position of each
        row's _classify_ token; lm_labels is accepted for interface parity
        and unused. Returns pooled (B, hidden) [, tuple of all hidden
        states]."""
        del lm_labels
        cfg = self.cfg
        B, L = input_ids.shape
        positions = torch.arange(L, device=input_ids.device)
        h = (F.embedding(input_ids.long(), self.tokens_embed.weight)
             .to(cfg.dtype)
             + F.embedding(positions, self.positions_embed.weight)
             .to(cfg.dtype)[None])
        h = dropout(h, cfg.embd_dropout, self.training)
        causal = torch.tril(torch.ones((L, L), device=input_ids.device))

        all_hidden = [h]
        for i in range(cfg.num_layers):
            h = getattr(self, f"block_{i}")(h, causal)
            all_hidden.append(h)
        chosen = all_hidden[layer_id]
        pooled = chosen[torch.arange(B, device=chosen.device),
                        cls_token_ids.long()]
        if return_all_hidden:
            return pooled, tuple(all_hidden)
        return pooled


def convert_hf_gpt_params(state_dict: dict) -> dict[str, torch.Tensor]:
    """Map an HF OpenAIGPTModel state dict onto `GPTTextEncoder`'s
    parameter names. HF's Conv1D stores its weight as (in, out); nn.Linear's
    is (out, in), so those are transposed."""
    def t(key):
        return torch.as_tensor(state_dict[key])

    out = {"tokens_embed.weight": t("tokens_embed.weight"),
           "positions_embed.weight": t("positions_embed.weight")}
    i = 0
    while f"h.{i}.attn.c_attn.weight" in state_dict:
        for port, hf, conv in (("c_attn", "attn.c_attn", True),
                               ("c_proj", "attn.c_proj", True),
                               ("ln_1", "ln_1", False),
                               ("mlp_fc", "mlp.c_fc", True),
                               ("mlp_proj", "mlp.c_proj", True),
                               ("ln_2", "ln_2", False)):
            w = t(f"h.{i}.{hf}.weight")
            out[f"block_{i}.{port}.weight"] = w.T.contiguous() if conv else w
            out[f"block_{i}.{port}.bias"] = t(f"h.{i}.{hf}.bias")
        i += 1
    return out


def gpt_config_from_hf(hf_config) -> GPTConfig:
    """A GPTConfig from an HF OpenAIGPTConfig (or a plain view of its
    config.json; `n_positions` takes HF's default when absent)."""
    return GPTConfig(
        vocab_size=hf_config.vocab_size,
        n_positions=getattr(hf_config, "n_positions", 512),
        hidden_size=hf_config.n_embd,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        embd_dropout=hf_config.embd_pdrop,
        attn_dropout=hf_config.attn_pdrop,
        resid_dropout=hf_config.resid_pdrop,
    )
