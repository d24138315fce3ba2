"""Pretrained HF encoder loading into the port (CPU, f32).

`load_encoder_checkpoint` + `TextEncoder` against the HF model that wrote
the checkpoint (the pooled output tanh(W h_i[:, 0]) of every hidden state i,
from HF's own hidden states and pooler) and against the JAX package's
`load_encoder_checkpoint` + flax `TextEncoder`, within 1e-5 absolute (f32;
the three sum the same products in other orders). Checkpoints: the tiny
BERT directory of `write_tiny_bert_checkpoint` (a .bin), a tiny RoBERTa
directory (safetensors), and raw state-dict files. Also: task-head
prefixes, a missing pooler, old LayerNorm spellings, config.json read as
JSON without `transformers`, and the families that are not ported.
"""

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
    import transformers as tf
    torch.manual_seed(0)
    if name == "albert":
        model = tf.AlbertModel(tf.AlbertConfig(
            vocab_size=30, embedding_size=8, hidden_size=16,
            num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=32, max_position_embeddings=20))
    elif name == "gpt":
        model = tf.OpenAIGPTModel(tf.OpenAIGPTConfig(
            vocab_size=30, n_positions=20, n_embd=16, n_layer=1, n_head=2))
    else:
        model = tf.XLNetModel(tf.XLNetConfig(
            vocab_size=30, d_model=16, n_layer=1, n_head=2, d_inner=32))
    out = tmp_path / name
    model.save_pretrained(str(out))
    return str(out), model.config


@pytest.mark.parametrize("family", ["albert", "gpt", "xlnet"])
def test_unported_families_raise(family, tmp_path):
    src, hf_cfg = _tiny_family(family, tmp_path)
    with pytest.raises(NotImplementedError, match="A5"):
        hf_loading.load_encoder_checkpoint(src)
    if family == "albert":
        with pytest.raises(NotImplementedError, match="A5"):
            config_from_hf(hf_cfg)
        with pytest.raises(NotImplementedError, match="A5"):
            convert_hf_encoder_params(
                hf_loading._read_checkpoint(src)[0])


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
