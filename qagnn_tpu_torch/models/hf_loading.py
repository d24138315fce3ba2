"""Load pretrained HF encoder checkpoints into the port's TextEncoder.

Counterpart of qagnn_tpu/models/hf_loading.py. The reference starts every
training run from pretrained HF weights (reference
modeling/modeling_encoder.py:102-108, qagnn.py:124-125 for the entity
table); this reads a torch checkpoint from disk and maps it onto
`TextEncoder`'s parameter names (models/text_encoder.py
`convert_hf_encoder_params`). The BERT/RoBERTa family is ported; ALBERT,
GPT and XLNet checkpoints raise (their encoders are ROADMAP A5).

Accepted sources for `load_encoder_checkpoint(src)`:
  * directory: config.json + (model.safetensors | pytorch_model.bin); the
    config is read by `transformers` where it is installed, else as JSON;
  * file: a torch.save'd state dict (pass `fallback_config`);
  * hub name: resolved through transformers' local cache (needs
    `transformers`; no download is attempted with HF_HUB_OFFLINE).
"""

from __future__ import annotations

import dataclasses
import json
import os
import types
from typing import Any

import torch

from qagnn_tpu_torch.models.text_encoder import (
    TextEncoderConfig,
    config_from_hf,
    convert_hf_encoder_params,
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
        from transformers import AutoConfig, AutoModel
    except ImportError as e:
        raise FileNotFoundError(
            f"{src!r} is neither a directory nor a file, and reading it as a "
            "hub name needs `transformers`, which is not installed") from e
    model = AutoModel.from_pretrained(src)
    return dict(model.state_dict()), AutoConfig.from_pretrained(src)


def load_encoder_checkpoint(
    src: str,
    dtype: torch.dtype = torch.float32,
    fallback_config: TextEncoderConfig | None = None,
) -> tuple[TextEncoderConfig, dict[str, torch.Tensor]]:
    """Load a pretrained encoder checkpoint onto the CPU.

    Returns (config, params): `params` maps `TextEncoder` parameter names to
    CPU tensors, to be copied into the model's `encoder` once it is on its
    device (cli.train, train.step._merge_pretrained). When the source
    carries an HF config, the returned config is derived from it (its shapes
    match the weights); otherwise `fallback_config` is used. `dtype` is the
    encoder's compute dtype.
    """
    state_dict, hf_cfg = _read_checkpoint(src)
    state_dict = strip_hf_prefixes(state_dict)

    family = ("GPT" if "tokens_embed.weight" in state_dict else
              "XLNet" if "word_embedding.weight" in state_dict else
              "ALBERT" if any(".albert_layer_groups." in k
                              for k in state_dict) else None)
    if family is not None:
        raise NotImplementedError(
            f"{src!r} is a {family} checkpoint; the {family} encoder is not "
            "ported (ROADMAP A5)")

    if hf_cfg is not None:
        cfg = config_from_hf(hf_cfg)
    elif fallback_config is not None:
        cfg = fallback_config
    else:
        raise ValueError(
            f"{src!r} carries no config.json; pass fallback_config")
    cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg, convert_hf_encoder_params(state_dict)
