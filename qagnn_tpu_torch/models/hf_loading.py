"""Load pretrained HF encoder checkpoints into the port's encoders.

Counterpart of qagnn_tpu/models/hf_loading.py. The reference starts every
training run from pretrained HF weights (reference
modeling/modeling_encoder.py:102-108, qagnn.py:124-125 for the entity
table); this reads a torch checkpoint from disk, tells its family by its
keys (BERT/RoBERTa/SapBERT, ALBERT, GPT, XLNet) and maps it onto that
encoder's parameter names (the `convert_hf_*_params` of
models/text_encoder.py, models/gpt_encoder.py, models/xlnet_encoder.py).
A stock openai-gpt table grows by the three rows of the GPT statement
layout's special tokens (`_resize_gpt_vocab`).

Accepted sources for `load_encoder_checkpoint(src)`:
  * directory: config.json + (model.safetensors | pytorch_model.bin); the
    config is read by `transformers` where it is installed, else as JSON;
  * file: a torch.save'd state dict (pass `fallback_config`);
  * hub name: its snapshot directory in transformers' local cache (needs
    `transformers`; no download is attempted with HF_HUB_OFFLINE).

`load_mlm_checkpoint` reads the same sources for a RobertaForMaskedLM and
returns its `lm_head.*` weights beside the encoder's (models/mlm_head.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import types
from typing import Any

import numpy as np
import torch

from qagnn_tpu_torch.models.gpt_encoder import (
    convert_hf_gpt_params,
    gpt_config_from_hf,
)
from qagnn_tpu_torch.models.text_encoder import (
    config_from_hf,
    convert_hf_albert_params,
    convert_hf_encoder_params,
)
from qagnn_tpu_torch.models.xlnet_encoder import (
    convert_hf_xlnet_params,
    xlnet_config_from_hf,
)

# base-model prefixes used by HF task heads (e.g. ...ForMaskedLM checkpoints)
_BASE_PREFIXES = ("bert.", "roberta.", "albert.", "transformer.", "model.")
# head weights that have no place in the bare encoder
_HEAD_PREFIXES = ("cls.", "lm_head.", "classifier.", "qa_outputs.",
                  "predictions.", "sop_classifier.")
# first-key markers of a bare encoder state dict, per family
_BARE_MARKERS = ("embeddings.", "tokens_embed.", "word_embedding.")


def strip_hf_prefixes(state_dict: dict[str, Any]) -> dict[str, Any]:
    """Unwrap task-model checkpoints to bare-encoder key names."""
    keys = list(state_dict)
    if not any(k.startswith(_BARE_MARKERS) for k in keys):
        for pref in _BASE_PREFIXES:
            if any(k.startswith(pref + m) for k in keys
                   for m in _BARE_MARKERS):
                state_dict = {k[len(pref):]: v for k, v in state_dict.items()
                              if k.startswith(pref)}
                break
    return {k: v for k, v in state_dict.items()
            if not k.startswith(_HEAD_PREFIXES)}


def _read_weights_file(path: str) -> dict[str, Any]:
    """A state dict from a .safetensors or torch.save file, on the CPU."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return dict(load_file(path))
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj and \
            not any("." in k for k in obj):
        obj = obj["state_dict"]
    return dict(obj)


def _read_checkpoint(src: str):
    """Return (state_dict, hf_config | None)."""
    if os.path.isdir(src):
        cfg = None
        cfg_path = os.path.join(src, "config.json")
        if os.path.exists(cfg_path):
            try:
                from transformers import AutoConfig
            except ImportError:
                # no transformers (the card's machine): a plain-attribute
                # view of the JSON
                with open(cfg_path) as f:
                    cfg = types.SimpleNamespace(**json.load(f))
            else:
                cfg = AutoConfig.from_pretrained(src)
        for name in ("model.safetensors", "pytorch_model.bin"):
            wpath = os.path.join(src, name)
            if os.path.exists(wpath):
                return _read_weights_file(wpath), cfg
        raise FileNotFoundError(
            f"no model.safetensors / pytorch_model.bin in {src!r}")
    if os.path.isfile(src):
        return _read_weights_file(src), None
    try:
        from transformers import utils as hf_utils
    except ImportError as e:
        raise FileNotFoundError(
            f"{src!r} is neither a directory nor a file, and reading it as a "
            "hub name needs `transformers`, which is not installed") from e
    return _read_checkpoint(os.path.dirname(
        hf_utils.cached_file(src, "config.json")))


def load_encoder_checkpoint(
    src: str,
    dtype: torch.dtype = torch.float32,
    fallback_config=None,
) -> tuple[Any, dict[str, torch.Tensor]]:
    """Load a pretrained encoder checkpoint onto the CPU.

    Returns (config, params): `params` maps the encoder's parameter names to
    CPU tensors, to be copied into the model's `encoder` once it is on its
    device (cli.train, train.step._merge_pretrained). When the source
    carries an HF config, the returned config (a TextEncoderConfig,
    GPTConfig or XLNetConfig) is derived from it (its shapes match the
    weights); otherwise `fallback_config` is used. `dtype` is the encoder's
    compute dtype.
    """
    return _encoder_params(*_read_checkpoint(src), src, dtype,
                           fallback_config)


def _encoder_params(state_dict, hf_cfg, src, dtype, fallback_config):
    state_dict = strip_hf_prefixes(state_dict)

    is_gpt = "tokens_embed.weight" in state_dict
    is_xlnet = "word_embedding.weight" in state_dict
    is_albert = any(".albert_layer_groups." in k for k in state_dict)

    if hf_cfg is not None:
        cfg = (gpt_config_from_hf(hf_cfg) if is_gpt else
               xlnet_config_from_hf(hf_cfg) if is_xlnet else
               config_from_hf(hf_cfg))
    elif fallback_config is not None:
        cfg = fallback_config
    else:
        raise ValueError(
            f"{src!r} carries no config.json; pass fallback_config")
    cfg = dataclasses.replace(cfg, dtype=dtype)

    if is_gpt:
        cfg, params = _resize_gpt_vocab(cfg, convert_hf_gpt_params(state_dict))
    elif is_xlnet:
        params = convert_hf_xlnet_params(state_dict)
    elif is_albert:
        params = convert_hf_albert_params(state_dict)
    else:
        params = convert_hf_encoder_params(state_dict)
    return cfg, params


def load_mlm_checkpoint(
    src: str,
    fallback_config=None,
) -> tuple[Any, dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Load an HF RobertaForMaskedLM checkpoint onto the CPU from the
    sources `load_encoder_checkpoint` accepts, for f32 compute. Returns
    (config, encoder params, head params): the head's under
    models/mlm_head.py `MLMHead`'s names (`dense`, `layer_norm`,
    `decoder`). The vocabulary bias is read from `lm_head.bias` or
    `lm_head.decoder.bias`, whichever is stored (HF ties the two);
    `decoder.weight` is present only when the checkpoint stores
    `lm_head.decoder.weight`, i.e. when it is not tied to the word
    embeddings."""
    state_dict, hf_cfg = _read_checkpoint(src)
    lm = {k[len("lm_head."):]: torch.as_tensor(v)
          for k, v in state_dict.items() if k.startswith("lm_head.")}
    if not lm:
        raise ValueError(f"{src!r} holds no lm_head.* weights: not a "
                         "RobertaForMaskedLM checkpoint")
    head = {name: lm[name] for name in ("dense.weight", "dense.bias",
                                        "layer_norm.weight",
                                        "layer_norm.bias")}
    head["decoder.bias"] = lm["bias"] if "bias" in lm else lm["decoder.bias"]
    if "decoder.weight" in lm:
        head["decoder.weight"] = lm["decoder.weight"]
    cfg, params = _encoder_params(state_dict, hf_cfg, src, torch.float32,
                                  fallback_config)
    return cfg, params, head


GPT_BPE_VOCAB = 40478     # the stock openai-gpt table, before the resize


def _resize_gpt_vocab(cfg, params, n_special: int = 3):
    """Grow a stock openai-gpt token table by the rows of the GPT statement
    layout's 3 special tokens (_start_ / _delimiter_ / _classify_), as the
    reference's resize_token_embeddings(get_gpt_token_num) does (reference
    modeling/modeling_encoder.py:105-106, utils/data_utils.py:284-287). The
    new rows are normal(0, 0.02) like HF's resize init, drawn from
    np.random.default_rng(0) as the JAX package draws them, so both hold
    the same rows bit for bit. Other tables (already resized, or a test
    model's) are left as they are."""
    table = params["tokens_embed.weight"]
    if table.shape[0] != GPT_BPE_VOCAB:
        return cfg, params
    target = table.shape[0] + n_special
    if cfg.vocab_size < target:
        extra = np.random.default_rng(0).normal(
            0.0, 0.02, (target - table.shape[0], table.shape[1]))
        params["tokens_embed.weight"] = torch.cat(
            [table, torch.from_numpy(extra).to(table.dtype)])
        cfg = dataclasses.replace(cfg, vocab_size=target)
    return cfg, params
