"""Pretrained HF encoder loading into the port (CPU, f32).

`load_encoder_checkpoint` + `TextEncoder` against the HF model that wrote
the checkpoint (the pooled output tanh(W h_i[:, 0]) of every hidden state i,
from HF's own hidden states and pooler) and against the JAX package's
`load_encoder_checkpoint` + flax `TextEncoder`, within 1e-5 absolute (f32;
the three sum the same products in other orders). Checkpoints: the tiny
BERT directory of `write_tiny_bert_checkpoint` (a .bin), a tiny RoBERTa
directory (safetensors), and raw state-dict files. Also: task-head
prefixes, a missing pooler, old LayerNorm spellings, config.json read as
JSON without `transformers`; and the ALBERT, GPT and XLNet families: their
checkpoints against the JAX conversion (exactly) and HF's models (1e-5),
their configs read without `transformers`, the settings both packages
refuse, and the GPT vocabulary resize.
"""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qagnn_tpu.models import hf_loading as jax_hf
from qagnn_tpu.models.text_encoder import TextEncoder as JaxTextEncoder

from qagnn_tpu_torch.data.synthetic import write_tiny_bert_checkpoint
from qagnn_tpu_torch.models import hf_loading
from qagnn_tpu_torch.models.text_encoder import (
    TextEncoder,
    TextEncoderConfig,
    config_from_hf,
    convert_hf_encoder_params,
)

TOL = 1e-5


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    return write_tiny_bert_checkpoint(str(tmp_path_factory.mktemp("bert")))


@pytest.fixture(scope="module")
def roberta_dir(tmp_path_factory):
    from transformers import RobertaConfig, RobertaModel
    torch.manual_seed(3)
    cfg = RobertaConfig(vocab_size=60, hidden_size=32, num_hidden_layers=3,
                        num_attention_heads=4, intermediate_size=48,
                        max_position_embeddings=40, type_vocab_size=1,
                        pad_token_id=1)
    out = str(tmp_path_factory.mktemp("roberta"))
    RobertaModel(cfg).eval().save_pretrained(out, safe_serialization=True)
    return out


def _inputs(vocab, pad_id, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab, (3, 11))
    mask = np.ones((3, 11), np.int64)
    mask[1, 6:] = 0
    mask[2, 9:] = 0
    ids[mask == 0] = pad_id
    return ids, mask


def _port_encoder(src):
    cfg, params = hf_loading.load_encoder_checkpoint(src)
    enc = TextEncoder(cfg)
    missing, unexpected = enc.load_state_dict(params, strict=False)
    assert not unexpected and not missing, (missing, unexpected)
    return enc.eval(), cfg


@pytest.mark.parametrize("which", ["bert", "roberta"])
def test_loaded_encoder_matches_hf_and_jax(bert_dir, roberta_dir, which):
    from transformers import AutoModel
    src = bert_dir if which == "bert" else roberta_dir
    hf = AutoModel.from_pretrained(src).eval()
    enc, cfg = _port_encoder(src)
    assert cfg.roberta_style_positions == (which == "roberta")
    ids, mask = _inputs(cfg.vocab_size, cfg.pad_token_id)
    with torch.no_grad():
        hidden = hf(torch.tensor(ids), attention_mask=torch.tensor(mask),
                    output_hidden_states=True).hidden_states
    jcfg, jparams = jax_hf.load_encoder_checkpoint(src)
    for layer in range(-1, cfg.num_layers + 1):
        with torch.no_grad():
            got = enc(torch.tensor(ids), torch.tensor(mask),
                      layer_id=layer).numpy()
            want = hf.pooler(hidden[layer]).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                   err_msg=f"HF, layer {layer}")
        jax_out = JaxTextEncoder(jcfg).apply(
            {"params": jparams}, jnp.asarray(ids), jnp.asarray(mask),
            layer_id=layer)
        np.testing.assert_allclose(got, np.asarray(jax_out), rtol=0,
                                   atol=TOL, err_msg=f"JAX, layer {layer}")


def test_params_equal_the_state_dict(bert_dir):
    """Every parameter is the checkpoint's tensor as written, bit for bit,
    and the position_ids buffer is not read."""
    from transformers import BertModel
    sd = BertModel.from_pretrained(bert_dir).state_dict()
    sd["embeddings.position_ids"] = torch.arange(64)[None]
    params = convert_hf_encoder_params(sd)
    assert "embeddings.position_ids" not in params
    enc = TextEncoder(config_from_hf(BertModel.from_pretrained(
        bert_dir).config))
    assert sorted(params) == sorted(n for n, _ in enc.named_parameters())
    assert torch.equal(params["layer_1.attention.out.weight"],
                       sd["encoder.layer.1.attention.output.dense.weight"])
    assert torch.equal(params["pooler.bias"], sd["pooler.dense.bias"])


def test_task_heads_stripped_and_missing_pooler_kept(tmp_path):
    from transformers import BertConfig, BertForMaskedLM
    torch.manual_seed(0)
    cfg = BertConfig(vocab_size=50, hidden_size=16, num_hidden_layers=1,
                     num_attention_heads=2, intermediate_size=32,
                     max_position_embeddings=20)
    mlm = BertForMaskedLM(cfg)
    sd = hf_loading.strip_hf_prefixes(dict(mlm.state_dict()))
    assert "embeddings.word_embeddings.weight" in sd
    assert not any(k.startswith(("cls.", "bert.")) for k in sd)
    assert sd.keys() == jax_hf.strip_hf_prefixes(
        dict(mlm.state_dict())).keys()
    out = tmp_path / "mlm"
    mlm.save_pretrained(str(out))
    pcfg, params = hf_loading.load_encoder_checkpoint(str(out))
    assert not any(k.startswith("pooler.") for k in params)
    enc = TextEncoder(pcfg)
    before = enc.pooler.weight.detach().clone()
    missing, unexpected = enc.load_state_dict(params, strict=False)
    assert sorted(missing) == ["pooler.bias", "pooler.weight"]
    assert not unexpected and torch.equal(enc.pooler.weight, before)


def test_state_dict_file_with_old_layernorm_names(bert_dir, tmp_path):
    """A raw torch.save'd state dict (no config: the fallback config is
    used) with `LayerNorm.gamma` / `beta` spellings loads as the
    directory does."""
    from transformers import BertModel
    sd = BertModel.from_pretrained(bert_dir).state_dict()
    old = {k.replace("LayerNorm.weight", "LayerNorm.gamma")
           .replace("LayerNorm.bias", "LayerNorm.beta"): v
           for k, v in sd.items()}
    path = tmp_path / "weights.bin"
    torch.save(old, path)
    dir_cfg, want = hf_loading.load_encoder_checkpoint(bert_dir)
    with pytest.raises(ValueError, match="fallback_config"):
        hf_loading.load_encoder_checkpoint(str(path))
    cfg, got = hf_loading.load_encoder_checkpoint(
        str(path), dtype=torch.bfloat16, fallback_config=dir_cfg)
    assert cfg.dtype == torch.bfloat16
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_config_json_read_without_transformers(bert_dir, roberta_dir,
                                               monkeypatch):
    want = {d: hf_loading.load_encoder_checkpoint(d)[0]
            for d in (bert_dir, roberta_dir)}
    monkeypatch.setitem(sys.modules, "transformers", None)
    for d, cfg in want.items():
        assert hf_loading.load_encoder_checkpoint(d)[0] == cfg
    with pytest.raises(FileNotFoundError, match="transformers"):
        hf_loading.load_encoder_checkpoint("roberta-large")


def _tiny_family(name, tmp_path):
    """An HF directory of a tiny AlbertModel / OpenAIGPTModel / XLNetModel,
    random weights from a seed; the fields a config.json may lack keep HF's
    defaults (n_positions 512, embedding_size 128, one ALBERT group, ...)."""
    import transformers as tf
    torch.manual_seed(0)
    if name == "albert":
        model = tf.AlbertModel(tf.AlbertConfig(
            vocab_size=30, embedding_size=128, hidden_size=16,
            num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=32, max_position_embeddings=20))
    elif name == "gpt":
        model = tf.OpenAIGPTModel(tf.OpenAIGPTConfig(
            vocab_size=30, n_embd=16, n_layer=2, n_head=2))
    else:
        model = tf.XLNetModel(tf.XLNetConfig(
            vocab_size=30, d_model=16, n_layer=2, n_head=2, d_inner=32))
    out = tmp_path / name
    model.save_pretrained(str(out))
    return str(out), model.config


def _family_inputs(family):
    """(kwargs of the HF model, of the port's encoder): 3 rows of 11
    tokens, padded on the right (on the left for XLNet), token types where
    the family reads them."""
    ids, mask = _inputs(30, 0)
    types = np.where(np.arange(11) < 6, 0, 1) * mask
    if family == "xlnet":
        ids, mask, types = (np.ascontiguousarray(x[:, ::-1])
                            for x in (ids, mask, types))
        ids[mask == 0] = 0
        types[mask == 0] = 4
    ids, mask, types = (torch.tensor(x) for x in (ids, mask, types))
    if family == "gpt":
        cls = mask.sum(1) - 1
        return {"input_ids": ids}, {"input_ids": ids, "cls_token_ids": cls}
    both = {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": types}
    return both, both


@pytest.mark.parametrize("family", ["albert", "gpt", "xlnet"])
def test_family_checkpoints_match_hf_and_jax(family, tmp_path):
    """load_encoder_checkpoint on each family's HF directory: the port's
    parameters equal the JAX conversion leaf by leaf (through
    utils/convert.py's table), and the port's encoder equals HF's model:
    every hidden state, and the pooled vector (ALBERT's raw h[:, 0], GPT's
    h at the classification token, XLNet's h at the last position)."""
    from transformers import AutoModel

    from qagnn_tpu_torch.cli import make_encoder
    from qagnn_tpu_torch.utils.convert import to_flax_variables
    src, _ = _tiny_family(family, tmp_path)
    cfg, params = hf_loading.load_encoder_checkpoint(src)
    enc = make_encoder(cfg)
    missing, unexpected = enc.load_state_dict(params, strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    jcfg, jparams = jax_hf.load_encoder_checkpoint(src)
    assert type(cfg).__name__ == type(jcfg).__name__
    for f in dataclasses.fields(cfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name

    got = _flat(to_flax_variables(enc)[0])
    want = _flat(jparams)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(w), err_msg=k)

    hf = AutoModel.from_pretrained(src).eval()
    hf_in, port_in = _family_inputs(family)
    with torch.no_grad():
        hidden = hf(**hf_in, output_hidden_states=True).hidden_states
        for layer in (-1, 1):
            pooled, mine = enc.eval()(**port_in, layer_id=layer,
                                      return_all_hidden=True)
            h = hidden[layer]
            want_pooled = (h[:, 0] if family == "albert" else h[:, -1]
                           if family == "xlnet" else
                           h[torch.arange(3), port_in["cls_token_ids"]])
            np.testing.assert_allclose(pooled.numpy(), want_pooled.numpy(),
                                       rtol=0, atol=TOL, err_msg=str(layer))
    assert len(mine) == len(hidden)
    for i, (g, w) in enumerate(zip(mine, hidden)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=TOL,
                                   err_msg=f"hidden state {i}")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# fields a *_config_from_hf reads that a hand-written config.json may lack
DEFAULTED = ("attn_type", "bi_data", "n_positions", "embedding_size",
             "num_hidden_groups", "inner_group_num", "hidden_act")


def test_family_configs_read_without_transformers(tmp_path, monkeypatch):
    """The card's machine reads config.json as plain JSON: with the
    defaulted fields left out of the file, the configs are those
    `transformers` gives."""
    srcs = [_tiny_family(f, tmp_path)[0] for f in ("albert", "gpt", "xlnet")]
    want = [hf_loading.load_encoder_checkpoint(s)[0] for s in srcs]
    for s in srcs:
        path = os.path.join(s, "config.json")
        with open(path) as f:
            d = json.load(f)
        with open(path, "w") as f:
            json.dump({k: v for k, v in d.items() if k not in DEFAULTED}, f)
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert [hf_loading.load_encoder_checkpoint(s)[0] for s in srcs] == want


@pytest.mark.parametrize("family,field,value", [
    ("albert", "num_hidden_groups", 2), ("albert", "inner_group_num", 2),
    ("xlnet", "attn_type", "uni"), ("xlnet", "bi_data", True)])
def test_refused_configs_raise_as_in_jax(tmp_path, family, field, value):
    """The port refuses what the JAX package refuses (it asserts; the port
    raises ValueError): multi-group ALBERT, XLNet not bidirectional or with
    bi_data."""
    from qagnn_tpu.models.xlnet_encoder import xlnet_config_from_hf as jax_x

    from qagnn_tpu.models.text_encoder import config_from_hf as jax_cfg
    from qagnn_tpu_torch.models.xlnet_encoder import xlnet_config_from_hf
    _, hf_cfg = _tiny_family(family, tmp_path)
    setattr(hf_cfg, field, value)
    port, jax_ = (config_from_hf, jax_cfg) if family == "albert" \
        else (xlnet_config_from_hf, jax_x)
    with pytest.raises(ValueError, match=field.split("_")[0]):
        port(hf_cfg)
    with pytest.raises(AssertionError):
        jax_(hf_cfg)


def test_multi_group_albert_weights_raise(tmp_path):
    from qagnn_tpu.models.text_encoder import (
        convert_hf_albert_params as jax_convert,
    )

    from qagnn_tpu_torch.models.text_encoder import convert_hf_albert_params
    src, _ = _tiny_family("albert", tmp_path)
    sd = hf_loading._read_checkpoint(src)[0]
    sd["encoder.albert_layer_groups.1.albert_layers.0.ffn.bias"] = \
        torch.zeros(32)
    with pytest.raises(ValueError, match="multi-group"):
        convert_hf_albert_params(sd)
    with pytest.raises(AssertionError):
        jax_convert(sd)


def test_gpt_vocab_resize_matches_jax():
    """A stock openai-gpt table (40478 rows) grows by the GPT layout's 3
    special tokens' rows, the same rows bit for bit as the JAX package's;
    a table of another size is left as it is."""
    from qagnn_tpu.models.gpt_encoder import GPTConfig as JaxGPTConfig

    from qagnn_tpu_torch.models.gpt_encoder import GPTConfig
    table = torch.randn(40478, 8, generator=torch.Generator().manual_seed(0))
    cfg, params = hf_loading._resize_gpt_vocab(
        GPTConfig(vocab_size=40478, hidden_size=8),
        {"tokens_embed.weight": table})
    jcfg, jparams = jax_hf._resize_gpt_vocab(
        JaxGPTConfig(vocab_size=40478, hidden_size=8),
        {"tokens_embed": {"embedding": jnp.asarray(table.numpy())}})
    assert cfg.vocab_size == jcfg.vocab_size == 40481
    np.testing.assert_array_equal(
        params["tokens_embed.weight"].numpy(),
        np.asarray(jparams["tokens_embed"]["embedding"]))
    small = {"tokens_embed.weight": table[:30]}
    assert hf_loading._resize_gpt_vocab(GPTConfig(vocab_size=30), small) \
        == (GPTConfig(vocab_size=30), small)


def test_config_from_hf_matches_jax(bert_dir, roberta_dir):
    from transformers import AutoConfig

    from qagnn_tpu.models.text_encoder import config_from_hf as jax_cfg
    for d in (bert_dir, roberta_dir):
        hf = AutoConfig.from_pretrained(d)
        got, want = config_from_hf(hf), jax_cfg(hf)
        for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "intermediate_size", "max_position_embeddings",
                  "type_vocab_size", "layer_norm_eps", "hidden_dropout",
                  "attention_dropout", "pad_token_id",
                  "roberta_style_positions", "hidden_act"):
            assert getattr(got, f) == getattr(want, f), (d, f)
    assert isinstance(got, TextEncoderConfig)
