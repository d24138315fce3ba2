"""XLNet text encoder (the content stream, the fine-tuning path) with the
reference's pooled output.

Counterpart of qagnn_tpu/models/xlnet_encoder.py (`XLNetConfig`,
`XLNetRelativeAttention`, `XLNetLayer`, `XLNetTextEncoder`; reference
modeling/modeling_encoder.py:28,135-136, the 'xlnet' model type). Its scope
is the JAX package's: attn_type="bi", no memory, no permutation mask, no
two-stream path, bi_data off; `forward` takes no such arguments and
`xlnet_config_from_hf` refuses the other settings. Under those settings it
computes what HF's XLNetModel does:

  * Transformer-XL relative attention: the content score (q + r_w_bias).k,
    the position score (q + r_r_bias).k_r over a 2L-long sinusoid table
    (positions L .. -L+1) with HF's rel-shift, and the segment score
    (q + r_s_bias).seg_embed through the same/different-segment one-hot
    matrix (zero without token types); f32 scores and softmax;
  * padding masked with -1e30, except each position for itself (HF's
    attn_mask - eye > 0);
  * post-LN residual blocks, the FFN with exact (erf) GELU;
  * the pooled vector is hidden[layer_id] at the LAST position: XLNet
    statements are left-padded with the CLS token at the end.

The projections q, k, v, o, r (d_model, n_head, d_head), the three biases
(n_head, d_head) and seg_embed (2, n_head, d_head) are parameters of HF's
shapes, so a checkpoint converts by copy. Plain torch ops, as the JAX
package computes the encoder outside any kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from qagnn_tpu_torch.models.layers import dense, dropout
from qagnn_tpu_torch.models.text_encoder import _layer_norm

# raw parameters of XLNetRelativeAttention, under their flax and HF names
RAW_PARAMS = ("q", "k", "v", "o", "r", "r_r_bias", "r_s_bias", "r_w_bias",
              "seg_embed")


@dataclass(frozen=True)
class XLNetConfig:
    vocab_size: int = 32000
    hidden_size: int = 768       # d_model
    num_layers: int = 12
    num_heads: int = 12
    d_head: int = 64
    d_inner: int = 3072
    layer_norm_eps: float = 1e-12
    dropout: float = 0.1
    dtype: torch.dtype = torch.float32   # compute dtype

    @classmethod
    def xlnet_large(cls, **kw):
        return cls(hidden_size=1024, num_layers=24, num_heads=16,
                   d_head=64, d_inner=4096, **kw)

    @classmethod
    def tiny(cls, **kw):
        kw.setdefault("vocab_size", 97)
        kw.setdefault("hidden_size", 32)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 2)
        kw.setdefault("d_head", 16)
        kw.setdefault("d_inner", 64)
        return cls(**kw)


def _rel_shift(bd: torch.Tensor, klen: int) -> torch.Tensor:
    """HF rel_shift_bnij: (B, H, L, 2L) -> (B, H, L, klen)."""
    B, H, L, P = bd.shape
    x = bd.reshape(B, H, P, L)[:, :, 1:, :]
    return x.reshape(B, H, L, P - 1)[:, :, :, :klen]


class XLNetRelativeAttention(nn.Module):
    def __init__(self, cfg: XLNetConfig):
        super().__init__()
        self.cfg = cfg
        d, nh, dh = cfg.hidden_size, cfg.num_heads, cfg.d_head
        shapes = {"r_r_bias": (nh, dh), "r_s_bias": (nh, dh),
                  "r_w_bias": (nh, dh), "seg_embed": (2, nh, dh)}
        for name in RAW_PARAMS:
            self.register_parameter(name, nn.Parameter(
                torch.empty(shapes.get(name, (d, nh, dh)))))
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, h, pos_emb, seg_mat, attn_mask):
        cfg = self.cfg
        cdt, f32 = cfg.dtype, torch.float32
        L = h.shape[1]
        w = {name: getattr(self, name).to(cdt) for name in RAW_PARAMS}
        hc = h.to(cdt)
        q = torch.einsum("bih,hnd->bind", hc, w["q"])
        k = torch.einsum("bih,hnd->bind", hc, w["k"])
        v = torch.einsum("bih,hnd->bind", hc, w["v"])
        k_r = torch.einsum("ph,hnd->pnd", pos_emb.to(cdt), w["r"])

        # f32 scores whatever the compute dtype
        ac = torch.einsum("bind,bjnd->bnij", (q + w["r_w_bias"]).to(f32),
                          k.to(f32))
        bd = torch.einsum("bind,pnd->bnip", (q + w["r_r_bias"]).to(f32),
                          k_r.to(f32))
        bd = _rel_shift(bd, klen=L)
        score = ac + bd
        if seg_mat is not None:
            ef = torch.einsum("bind,snd->bnis", (q + w["r_s_bias"]).to(f32),
                              w["seg_embed"].to(f32))
            score = score + torch.einsum("bijs,bnis->bnij", seg_mat, ef)
        score = score * (1.0 / np.sqrt(cfg.d_head))
        score = score - 1e30 * attn_mask[:, None]
        prob = torch.softmax(score, dim=-1).to(cdt)
        prob = dropout(prob, cfg.dropout, self.training)
        vec = torch.einsum("bnij,bjnd->bind", prob, v)
        out = torch.einsum("bind,hnd->bih", vec, w["o"])
        out = dropout(out, cfg.dropout, self.training)
        return _layer_norm(out + h, self.layer_norm, cdt)


class XLNetLayer(nn.Module):
    def __init__(self, cfg: XLNetConfig):
        super().__init__()
        self.cfg = cfg
        self.rel_attn = XLNetRelativeAttention(cfg)
        self.ff_layer_1 = nn.Linear(cfg.hidden_size, cfg.d_inner)
        self.ff_layer_2 = nn.Linear(cfg.d_inner, cfg.hidden_size)
        self.ff_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                          eps=cfg.layer_norm_eps)

    def forward(self, h, pos_emb, seg_mat, attn_mask):
        cfg = self.cfg
        h = self.rel_attn(h, pos_emb, seg_mat, attn_mask)
        f = F.gelu(dense(h, self.ff_layer_1, cfg.dtype))   # exact, as HF's
        f = dropout(f, cfg.dropout, self.training)
        f = dropout(dense(f, self.ff_layer_2, cfg.dtype), cfg.dropout,
                    self.training)
        return _layer_norm(f + h, self.ff_layer_norm, cfg.dtype)


class XLNetTextEncoder(nn.Module):
    """XLNet encoder with the reference's last-position pooling contract."""

    def __init__(self, cfg: XLNetConfig):
        super().__init__()
        self.cfg = cfg
        self.word_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", XLNetLayer(cfg))

    def forward(self, input_ids, attention_mask, token_type_ids=None,
                special_tokens_mask=None, *, layer_id: int = -1,
                return_all_hidden: bool = False):
        """input_ids/attention_mask/token_type_ids: (B, L), left-padded.
        Returns pooled (B, hidden) [, tuple of all hidden states].
        `special_tokens_mask` is accepted for interface parity and unused."""
        del special_tokens_mask
        cfg = self.cfg
        dev = input_ids.device
        L = input_ids.shape[1]

        # mask[b, i, j] = 1 iff token j is padding and i != j
        pad_j = (attention_mask == 0).float()
        eye = torch.eye(L, device=dev)
        attn_mask = ((pad_j[:, None, :] - eye[None]) > 0).float()
        seg_mat = None
        if token_type_ids is not None:       # same / different segment
            diff = token_type_ids[:, :, None] != token_type_ids[:, None, :]
            seg_mat = F.one_hot(diff.long(), 2).float()      # (B, L, L, 2)

        # the relative sinusoid table for positions L .. -L+1
        d = cfg.hidden_size
        freq = torch.arange(0, d, 2, dtype=torch.float32, device=dev)
        inv_freq = 1.0 / torch.pow(10000.0, freq / d)
        pos_seq = torch.arange(L, -L, -1, dtype=torch.float32, device=dev)
        sin_inp = pos_seq[:, None] * inv_freq[None, :]
        pos_emb = torch.cat([torch.sin(sin_inp), torch.cos(sin_inp)], dim=-1)
        pos_emb = dropout(pos_emb, cfg.dropout, self.training)

        h = F.embedding(input_ids.long(), self.word_embedding.weight) \
            .to(cfg.dtype)
        h = dropout(h, cfg.dropout, self.training)
        all_hidden = [h]
        for i in range(cfg.num_layers):
            h = getattr(self, f"layer_{i}")(h, pos_emb, seg_mat, attn_mask)
            all_hidden.append(h)
        pooled = all_hidden[layer_id][:, -1]
        if return_all_hidden:
            return pooled, tuple(all_hidden)
        return pooled


def convert_hf_xlnet_params(state_dict: dict) -> dict[str, torch.Tensor]:
    """Map an HF XLNetModel state dict onto `XLNetTextEncoder`'s parameter
    names: the attention tensors are copies of HF's, the FFN Linears keep
    torch's layout. HF's `mask_emb` (the two-stream path's) is not read."""
    def t(key):
        return torch.as_tensor(state_dict[key])

    out = {"word_embedding.weight": t("word_embedding.weight")}
    i = 0
    while f"layer.{i}.rel_attn.q" in state_dict:
        hf, port = f"layer.{i}", f"layer_{i}"
        for name in RAW_PARAMS:
            out[f"{port}.rel_attn.{name}"] = t(f"{hf}.rel_attn.{name}")
        for p, h in (("rel_attn.layer_norm", "rel_attn.layer_norm"),
                     ("ff_layer_1", "ff.layer_1"),
                     ("ff_layer_2", "ff.layer_2"),
                     ("ff_layer_norm", "ff.layer_norm")):
            out[f"{port}.{p}.weight"] = t(f"{hf}.{h}.weight")
            out[f"{port}.{p}.bias"] = t(f"{hf}.{h}.bias")
        i += 1
    return out


def xlnet_config_from_hf(hf_config) -> XLNetConfig:
    """An XLNetConfig from an HF XLNetConfig (or a plain view of its
    config.json; `attn_type` and `bi_data` take HF's defaults when absent).
    Only the fine-tuning setting is supported: attn_type "bi", bi_data
    off."""
    attn_type = getattr(hf_config, "attn_type", "bi")
    if attn_type != "bi":
        raise ValueError(f"only attn_type='bi' is supported, not "
                         f"{attn_type!r}")
    if getattr(hf_config, "bi_data", False):
        raise ValueError("bi_data is not supported")
    return XLNetConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.d_model,
        num_layers=hf_config.n_layer,
        num_heads=hf_config.n_head,
        d_head=hf_config.d_head,
        d_inner=hf_config.d_inner,
        layer_norm_eps=hf_config.layer_norm_eps,
        dropout=hf_config.dropout,
    )
