"""The port's CLI against qagnn_tpu.cli.train for the GPT and XLNet
encoders (CPU, f32); the LSTM and ALBERT cases, which read their vocabulary
or weights from files, run the same check in
tests/test_torch_encoders_cli_files.py.

As tests/test_torch_cli.py's `test_train_matches_the_jax_cli` does for the
tiny BERT: one synthetic set, dropout 0 (flax's Dropout and the port's
`dropout` patched to the identity), 2 microbatches, a frozen epoch then a
trained one, the port from the JAX run's initial variables carried across
by utils/convert.py. The per-step losses agree within rtol 2e-4 and the
per-epoch dev and test accuracies are equal, for `tiny-gpt` (the GPT
statement layout, its special tokens added to the tokenizer), `tiny-xlnet`
(the left-padded XLNet layout), `tiny-lstm` (word ids from a
`--lstm_vocab` file that `make_word_vocab` writes) and a tiny ALBERT read
through `--encoder_load` from an HF directory.
"""

import jax
import numpy as np
import pytest
import torch

import qagnn_tpu.cli as jax_cli
import qagnn_tpu.utils.initialization as jax_init
from qagnn_tpu.utils import config as jax_config

import qagnn_tpu_torch.cli as cli
from qagnn_tpu_torch.data.synthetic import VOCAB, write_synthetic_dataset
from qagnn_tpu_torch.data.word_tokenizer import make_word_vocab
from qagnn_tpu_torch.utils import config
from qagnn_tpu_torch.utils.convert import load_flax_variables

from test_torch_cli import (  # noqa: F401  (fixtures)
    _cfg,
    _no_dropout,
    _one_torch_thread,
    _with_tokenizer,
)


def _tokenizer(tmp_path):
    """A fresh BertTokenizerFast over the synthetic vocabulary (the GPT
    layout adds its special tokens to the one it is given)."""
    from transformers import BertTokenizerFast
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB))
    return BertTokenizerFast(vocab_file=str(path), do_lower_case=True)


def _tiny_albert(out):
    from transformers import AlbertConfig, AlbertModel
    torch.manual_seed(0)
    AlbertModel(AlbertConfig(
        vocab_size=len(VOCAB) + 2, embedding_size=8, hidden_size=16,
        num_hidden_layers=2, num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=20)).save_pretrained(str(out))
    return str(out)


@pytest.mark.parametrize("encoder", ["tiny-gpt", "tiny-xlnet"])
def test_train_matches_the_jax_cli(tmp_path, monkeypatch, _no_dropout,
                                   encoder):
    train_matches_the_jax_cli(tmp_path, monkeypatch, encoder)


def train_matches_the_jax_cli(tmp_path, monkeypatch, encoder):
    """cli.train and qagnn_tpu.cli.train on one synthetic set from the same
    initial variables, dropout off: equal per-step losses (rtol 2e-4) and
    per-epoch accuracies."""
    root = str(tmp_path / "data")
    emb_path = write_synthetic_dataset(root, n_questions=8)
    kw = dict(n_epochs=2, unfreeze_epoch=1, gnn_dtype="float32", k=2,
              decoder_lr=3e-3, encoder_lr=1e-3, max_epochs_before_stop=10,
              encoder=encoder)
    tok = _tokenizer(tmp_path)
    if encoder == "tiny-lstm":
        tok = None           # both CLIs read --lstm_vocab themselves
        kw["lstm_vocab"] = str(tmp_path / "words.json")
        make_word_vocab([f"{root}/statement/{s}.statement.jsonl"
                         for s in ("train", "dev", "test")],
                        kw["lstm_vocab"], freq_cutoff=1)
    if encoder == "albert":
        kw.update(encoder="albert-base-v2",
                  encoder_load=_tiny_albert(tmp_path / "albert"))

    # the JAX CLI, its initial variables kept
    seen = {}
    init = jax_init.init_variables

    def keep(*a, **k):
        seen["variables"] = init(*a, **k)
        return seen["variables"]
    monkeypatch.setattr(jax_init, "init_variables", keep)
    orig = jax_cli.build_model_and_data
    monkeypatch.setattr(
        jax_cli, "build_model_and_data",
        lambda cfg, tokenizer=None, gnn_mesh=None:
        orig(cfg, tokenizer=tok, gnn_mesh=gnn_mesh))
    want = jax_cli.train(_cfg(jax_config, root, emb_path, mesh_data=1,
                              save_dir=str(tmp_path / "jax"), **kw))

    # the port from the same variables
    v = {k: jax.tree.map(np.asarray, t)
         for k, t in seen["variables"].items()}
    monkeypatch.setattr(cli, "init_weights", lambda model, gen, std:
                        load_flax_variables(model, v["params"],
                                            v["batch_stats"]))
    if tok is not None:
        _with_tokenizer(monkeypatch, tok)
    got = cli.train(_cfg(config, root, emb_path,
                         save_dir=str(tmp_path / "port"), **kw),
                    device="cpu")

    assert len(got["train_losses"]) == len(want["train_losses"]) == 4
    np.testing.assert_allclose(got["train_losses"], want["train_losses"],
                               rtol=2e-4)
    assert (tmp_path / "port" / "log.csv").read_text() == \
        (tmp_path / "jax" / "log.csv").read_text()
    assert got["best_dev_epoch"] == want["best_dev_epoch"]

