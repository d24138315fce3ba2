"""Transformer text encoder (BERT / RoBERTa / SapBERT / ALBERT family) with
a pooled output.

Counterpart of qagnn_tpu/models/text_encoder.py (`TextEncoderConfig`,
`SelfAttention`, `TransformerBlock`, `TextEncoder`): post-LN blocks, f32
attention logits and softmax with a -1e9 additive mask, and the reference's
selectable-layer pooler tanh(W h[layer_id][:, 0]) (reference
modeling/modeling_encoder.py:126,142). ALBERT embeds at `embedding_size`,
projects to the hidden width, applies ONE block (`layer_shared`)
`num_layers` times (autograd sums its gradients over the uses) and pools the
raw h[layer_id][:, 0] (reference modeling/modeling_encoder.py:138-140).
Attention is plain torch ops, as the JAX package computes it outside any
kernel. `convert_hf_encoder_params`, `convert_hf_albert_params` and
`config_from_hf` read HF Bert/RoBERTa/ALBERT checkpoints
(models/hf_loading.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qagnn_tpu_torch.models.layers import dense, dropout


@dataclass(frozen=True)
class TextEncoderConfig:
    vocab_size: int
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 0
    # RoBERTa numbers positions from pad_token_id + 1 over real tokens
    roberta_style_positions: bool = False
    # ALBERT: factorized embedding (embed at embedding_size, project to
    # hidden), one block shared by all layers, and the raw h[:, 0] pooled
    # with no pooler dense
    embedding_size: int | None = None
    share_layers: bool = False
    hidden_act: str = "gelu"         # "gelu" (exact) | "gelu_new" (tanh)
    raw_cls_pool: bool = False
    dtype: torch.dtype = torch.float32   # compute dtype

    @classmethod
    def roberta_base(cls, **kw):
        return cls(vocab_size=50265, hidden_size=768, num_layers=12,
                   num_heads=12, intermediate_size=3072,
                   max_position_embeddings=514, type_vocab_size=1,
                   layer_norm_eps=1e-5, pad_token_id=1,
                   roberta_style_positions=True, **kw)

    @classmethod
    def roberta_large(cls, **kw):
        return cls(vocab_size=50265, hidden_size=1024, num_layers=24,
                   num_heads=16, intermediate_size=4096,
                   max_position_embeddings=514, type_vocab_size=1,
                   layer_norm_eps=1e-5, pad_token_id=1,
                   roberta_style_positions=True, **kw)

    @classmethod
    def bert_base(cls, **kw):
        """Also SapBERT (PubMedBERT-fulltext architecture)."""
        return cls(vocab_size=30522, **kw)

    @classmethod
    def albert_base(cls, **kw):
        # ALBERT v2 checkpoints (vocab 30000, gelu_new) fine-tune with zero
        # dropout, not the class default 0.1
        kw.setdefault("hidden_dropout", 0.0)
        kw.setdefault("attention_dropout", 0.0)
        return cls(vocab_size=30000, hidden_size=768, num_layers=12,
                   num_heads=12, intermediate_size=3072,
                   embedding_size=128, share_layers=True,
                   hidden_act="gelu_new", raw_cls_pool=True, **kw)

    @classmethod
    def albert_xxlarge(cls, **kw):
        kw.setdefault("hidden_dropout", 0.0)
        kw.setdefault("attention_dropout", 0.0)
        return cls(vocab_size=30000, hidden_size=4096, num_layers=12,
                   num_heads=64, intermediate_size=16384,
                   embedding_size=128, share_layers=True,
                   hidden_act="gelu_new", raw_cls_pool=True, **kw)

    @classmethod
    def tiny(cls, **kw):
        """For tests and CPU smoke runs."""
        kw.setdefault("vocab_size", 128)
        kw.setdefault("hidden_size", 32)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 2)
        kw.setdefault("intermediate_size", 64)
        kw.setdefault("max_position_embeddings", 64)
        return cls(**kw)


def _layer_norm(x, ln: nn.LayerNorm, dtype):
    return F.layer_norm(x.to(dtype), ln.normalized_shape, ln.weight.to(dtype),
                        ln.bias.to(dtype), ln.eps)


class SelfAttention(nn.Module):
    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)
        self.out = nn.Linear(d, d)

    def forward(self, h, attn_bias):
        cfg = self.cfg
        d, nh = cfg.hidden_size, cfg.num_heads
        dh = d // nh
        B, L, _ = h.shape
        q = dense(h, self.query, cfg.dtype).reshape(B, L, nh, dh)
        k = dense(h, self.key, cfg.dtype).reshape(B, L, nh, dh)
        v = dense(h, self.value, cfg.dtype).reshape(B, L, nh, dh)
        # f32 logits and softmax whatever the compute dtype
        scores = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
        scores = scores / np.sqrt(dh) + attn_bias
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        probs = dropout(probs, cfg.attention_dropout, self.training)
        ctx = torch.einsum("bhlm,bmhd->blhd", probs, v).reshape(B, L, d)
        return dense(ctx, self.out, cfg.dtype)


class TransformerBlock(nn.Module):
    """Post-LN block: h = LN(h + Attn(h)); h = LN(h + FFN(h))."""

    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.attention = SelfAttention(cfg)
        self.attention_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.intermediate = nn.Linear(d, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, d)
        self.output_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, h, attn_bias):
        cfg = self.cfg
        a = dropout(self.attention(h, attn_bias), cfg.hidden_dropout,
                      self.training)
        h = _layer_norm(h + a, self.attention_ln, cfg.dtype)
        f = dense(h, self.intermediate, cfg.dtype)
        f = F.gelu(f, approximate="tanh" if cfg.hidden_act == "gelu_new"
                   else "none")
        f = dropout(dense(f, self.output, cfg.dtype), cfg.hidden_dropout,
                      self.training)
        return _layer_norm(h + f, self.output_ln, cfg.dtype)


class TextEncoder(nn.Module):
    """BERT/RoBERTa/ALBERT encoder with the reference's pooled-output
    contract."""

    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        emb = cfg.embedding_size or d
        self.word_embeddings = nn.Embedding(cfg.vocab_size, emb)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                emb)
        self.token_type_embeddings = nn.Embedding(
            max(cfg.type_vocab_size, 1), emb)
        self.embeddings_ln = nn.LayerNorm(emb, eps=cfg.layer_norm_eps)
        self.embedding_projection = nn.Linear(emb, d) if emb != d else None
        if cfg.share_layers:
            self.layer_shared = TransformerBlock(cfg)
        else:
            for i in range(cfg.num_layers):
                self.add_module(f"layer_{i}", TransformerBlock(cfg))
        self.pooler = None if cfg.raw_cls_pool else nn.Linear(d, d)

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                special_tokens_mask=None, *, layer_id: int = -1,
                return_all_hidden: bool = False):
        """input_ids/attention_mask: (B, L). Returns pooled (B, hidden) of
        hidden state `layer_id` (0 = embeddings) [, tuple of all hidden
        states]. `special_tokens_mask` is accepted for interface parity and
        unused."""
        del special_tokens_mask
        cfg = self.cfg
        B, L = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if cfg.roberta_style_positions:
            mask = (input_ids != cfg.pad_token_id).long()
            position_ids = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
        else:
            position_ids = torch.arange(L, device=input_ids.device)[None, :] \
                .expand(B, L)
        n_types = max(cfg.type_vocab_size, 1)

        def embed(ids, table):   # flax Embed(dtype=...): rows in cfg.dtype
            return F.embedding(ids.long(), table.weight).to(cfg.dtype)

        h = (embed(input_ids, self.word_embeddings)
             + embed(position_ids, self.position_embeddings)
             + embed(torch.clamp(token_type_ids.long(), 0, n_types - 1),
                     self.token_type_embeddings))
        h = _layer_norm(h, self.embeddings_ln, cfg.dtype)
        h = dropout(h, cfg.hidden_dropout, self.training)
        if self.embedding_projection is not None:
            h = dense(h, self.embedding_projection, cfg.dtype)

        attn_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                                -1e9).float()                   # (B,1,1,L)
        all_hidden = [h]
        for i in range(cfg.num_layers):
            block = self.layer_shared if cfg.share_layers \
                else getattr(self, f"layer_{i}")
            h = block(h, attn_bias)
            all_hidden.append(h)

        chosen = all_hidden[layer_id][:, 0]
        pooled = chosen if self.pooler is None \
            else torch.tanh(dense(chosen, self.pooler, cfg.dtype))
        if return_all_hidden:
            return pooled, tuple(all_hidden)
        return pooled


# --------------------------------------------------------------------------
# HF torch checkpoint conversion
# --------------------------------------------------------------------------

def _hf_reader(state_dict: dict):
    """(out, dense, ln): `out` collects port-named tensors; dense(port, hf)
    and ln(port, hf) copy an HF Linear / LayerNorm (old files' LayerNorm
    `gamma` / `beta` spellings read as `weight` / `bias`)."""
    def find(*names):
        for n in names:
            if n in state_dict:
                return torch.as_tensor(state_dict[n])
        raise KeyError(f"none of {names} in checkpoint")

    out: dict[str, torch.Tensor] = {}

    def dense(port, hf):
        out[port + ".weight"] = find(hf + ".weight")
        out[port + ".bias"] = find(hf + ".bias")

    def ln(port, hf):
        out[port + ".weight"] = find(hf + ".weight", hf + ".gamma")
        out[port + ".bias"] = find(hf + ".bias", hf + ".beta")
    return out, dense, ln


def convert_hf_encoder_params(state_dict: dict) -> dict[str, torch.Tensor]:
    """Map an HF BertModel/RobertaModel state dict (bare-encoder key names)
    onto `TextEncoder`'s parameter names. Linear weights keep torch's (out,
    in) layout, which both sides share. Keys the encoder does not read (the
    `embeddings.position_ids` buffer, heads) are left out; so is the pooler
    when the checkpoint has none (MLM checkpoints such as hub roberta-large):
    the model's initialised pooler is then kept, as HF's
    AutoModel.from_pretrained keeps a random one (reference
    modeling/modeling_encoder.py:102-108). Older files' LayerNorm
    `gamma` / `beta` spellings are read as `weight` / `bias`."""
    out, dense, ln = _hf_reader(state_dict)
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[name + ".weight"] = torch.as_tensor(
            state_dict[f"embeddings.{name}.weight"])
    ln("embeddings_ln", "embeddings.LayerNorm")
    if "pooler.dense.weight" in state_dict:
        dense("pooler", "pooler.dense")
    i = 0
    while f"encoder.layer.{i}.attention.self.query.weight" in state_dict:
        hf, port = f"encoder.layer.{i}", f"layer_{i}"
        for name in ("query", "key", "value"):
            dense(f"{port}.attention.{name}", f"{hf}.attention.self.{name}")
        dense(f"{port}.attention.out", f"{hf}.attention.output.dense")
        ln(f"{port}.attention_ln", f"{hf}.attention.output.LayerNorm")
        dense(f"{port}.intermediate", f"{hf}.intermediate.dense")
        dense(f"{port}.output", f"{hf}.output.dense")
        ln(f"{port}.output_ln", f"{hf}.output.LayerNorm")
        i += 1
    return out


def convert_hf_albert_params(state_dict: dict) -> dict[str, torch.Tensor]:
    """Map an HF AlbertModel state dict onto `TextEncoder`'s parameter names
    (the shared block under `layer_shared`, the factorized embedding's
    `embedding_projection`). HF's pooler is not read: ALBERT pools the raw
    h[:, 0]. Multi-group checkpoints hold more than one distinct block, and
    mapping group 0 alone would be silently wrong: they raise."""
    layer = "encoder.albert_layer_groups.0.albert_layers.0"
    extra = [k for k in state_dict if ".albert_layer_groups." in k
             and not k.startswith(layer + ".")]
    if extra:
        raise ValueError("multi-group ALBERT checkpoints are not supported "
                         f"(found {extra[:3]})")
    out, dense, ln = _hf_reader(state_dict)
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        out[name + ".weight"] = torch.as_tensor(
            state_dict[f"embeddings.{name}.weight"])
    ln("embeddings_ln", "embeddings.LayerNorm")
    dense("embedding_projection", "encoder.embedding_hidden_mapping_in")
    for name in ("query", "key", "value"):
        dense(f"layer_shared.attention.{name}", f"{layer}.attention.{name}")
    dense("layer_shared.attention.out", f"{layer}.attention.dense")
    ln("layer_shared.attention_ln", f"{layer}.attention.LayerNorm")
    dense("layer_shared.intermediate", f"{layer}.ffn")
    dense("layer_shared.output", f"{layer}.ffn_output")
    ln("layer_shared.output_ln", f"{layer}.full_layer_layer_norm")
    return out


def config_from_hf(hf_config) -> TextEncoderConfig:
    """A TextEncoderConfig from an HF Bert/Roberta/AlbertConfig (or a plain
    view of its config.json, where a field HF's config class defaults may
    be absent)."""
    if hf_config.model_type == "albert":
        # one shared block: multi-group ALBERT has several distinct blocks
        for field in ("num_hidden_groups", "inner_group_num"):
            if getattr(hf_config, field, 1) != 1:
                raise ValueError(f"only {field}=1 ALBERT is supported")
        return TextEncoderConfig(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            intermediate_size=hf_config.intermediate_size,
            max_position_embeddings=hf_config.max_position_embeddings,
            type_vocab_size=hf_config.type_vocab_size,
            layer_norm_eps=hf_config.layer_norm_eps,
            hidden_dropout=hf_config.hidden_dropout_prob,
            attention_dropout=hf_config.attention_probs_dropout_prob,
            pad_token_id=hf_config.pad_token_id or 0,
            embedding_size=getattr(hf_config, "embedding_size", 128),
            share_layers=True,
            # v2 checkpoints say "gelu_new"; v1 says "gelu" (exact)
            hidden_act=getattr(hf_config, "hidden_act", "gelu_new"),
            raw_cls_pool=True,
        )
    is_roberta = hf_config.model_type in ("roberta", "camembert",
                                          "xlm-roberta")
    return TextEncoderConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        layer_norm_eps=hf_config.layer_norm_eps,
        hidden_dropout=hf_config.hidden_dropout_prob,
        attention_dropout=hf_config.attention_probs_dropout_prob,
        pad_token_id=hf_config.pad_token_id or 0,
        roberta_style_positions=is_roberta,
    )
