"""The port's CLI, qagnn_tpu_torch.cli, on the CPU.

(a) As tests/test_cli_end_to_end.py does for the JAX CLI: training
    overfits 4 questions to dev_acc 1.0 (dev is a copy of train), eval_detail
    from the checkpoint reproduces that accuracy and writes the detail .npz
    with the JAX CLI's keys and shapes, and --load_model_path resumes at
    the saved step.
(b) Parity with qagnn_tpu.cli.train on one synthetic set: tiny encoder,
    dropout 0 (flax's Dropout and the port's `dropout` patched to the
    identity: the pooler's and the tiny encoder's rates are not flags), f32,
    2 microbatches, a frozen epoch then an unfrozen one, from the JAX run's
    initial variables carried across by utils/convert.py. The per-step
    losses agree within rtol 2e-4 (tests/test_torch_train_step.py's
    tolerance), the per-epoch dev and test accuracies are equal, and so are
    the best-dev checkpoints' parameters and BatchNorm statistics within
    that file's rtol 1e-3 / atol 2e-5.
(c) The parser reads every TrainConfig field as the JAX package's does;
    main() hands --device to the entry points; without a card and without
    --device the CLI raises; a device mesh, not ported, raises naming its
    ROADMAP item; every encoder name resolves to the JAX package's config
    (tests/test_torch_encoders_cli.py holds cli.train against the JAX CLI
    for the GPT, XLNet, LSTM and ALBERT encoders).
"""

import dataclasses
import os
import sys

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

import qagnn_tpu.cli as jax_cli
import qagnn_tpu.utils.initialization as jax_init
from qagnn_tpu.utils import checkpoint as jax_checkpoint
from qagnn_tpu.utils import config as jax_config

import qagnn_tpu_torch.cli as cli
from qagnn_tpu_torch.data.synthetic import VOCAB, write_synthetic_dataset
from qagnn_tpu_torch.models import layers
from qagnn_tpu_torch.utils import config
from qagnn_tpu_torch.utils.checkpoint import load_checkpoint
from qagnn_tpu_torch.utils.convert import (
    load_flax_variables,
    to_flax_variables,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    from transformers import BertTokenizerFast
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(VOCAB))
    return BertTokenizerFast(vocab_file=str(path), do_lower_case=True)


def _cfg(module, root, emb_path, **kw):
    """A resolved TrainConfig of `module` (either package's config) for the
    synthetic set at `root`; resolved() formats paths with {dataset}, so
    the absolute ones are set after it."""
    base = dict(dataset="csqa", encoder="tiny", inhouse=False,
                batch_size=4, mini_batch_size=2, eval_batch_size=2,
                max_seq_len=16, max_node_num=8, num_relation=10, k=1,
                gnn_dim=8, fc_dim=8, att_head_num=2, dropouti=0.0,
                dropoutg=0.0, dropoutf=0.0, log_interval=1000)
    cfg = module.TrainConfig(**{**base, **kw}).resolved()
    for split in ("train", "dev", "test"):
        setattr(cfg, f"{split}_statements",
                f"{root}/statement/{split}.statement.jsonl")
        setattr(cfg, f"{split}_adj", f"{root}/graph/{split}.graph.adj.pk")
    cfg.ent_emb_paths = (emb_path,)
    return cfg


def _with_tokenizer(monkeypatch, tok):
    orig = cli.build_model_and_data
    monkeypatch.setattr(cli, "build_model_and_data",
                        lambda cfg, device, tokenizer=None:
                        orig(cfg, device, tokenizer=tok))


def test_overfit_checkpoint_eval_detail_resume(tmp_path, tokenizer,
                                               monkeypatch):
    root = str(tmp_path / "data")
    emb_path = write_synthetic_dataset(root, dev_equals_train=True)
    _with_tokenizer(monkeypatch, tokenizer)
    cfg = _cfg(config, root, emb_path, save_dir=str(tmp_path / "out"),
               save_model=True, n_epochs=170, unfreeze_epoch=0,
               max_epochs_before_stop=1000, decoder_lr=3e-3,
               encoder_lr=1e-3)

    result = cli.train(cfg, device="cpu")
    assert result["best_dev_acc"] == 1.0, result
    log = (tmp_path / "out" / "log.csv").read_text().strip().splitlines()
    assert log[0] == "step,dev_acc,test_acc" and len(log) == 171
    assert (tmp_path / "out" / "config.json").exists()
    assert (tmp_path / "out" / "predictions_test_e0.csv").exists()

    # checkpoint -> eval_detail
    ckpt = os.path.join(cfg.save_dir, "checkpoint")
    cfg_eval = dataclasses.replace(cfg, mode="eval_detail",
                                   load_model_path=ckpt,
                                   save_dir=str(tmp_path / "out_eval"))
    os.makedirs(cfg_eval.save_dir)
    r2 = cli.eval_detail(cfg_eval, device="cpu")
    assert r2["dev_acc"] == result["best_dev_acc"]
    assert os.path.exists(os.path.join(cfg_eval.save_dir,
                                       "predictions_test.csv"))
    detail = np.load(os.path.join(cfg_eval.save_dir, "test_detail.0.npz"),
                     allow_pickle=False)
    assert sorted(detail.files) == sorted([
        "qids", "logits", "pool_attn", "gnn_edge_alpha", "gnn_self_alpha",
        "concept_ids", "node_types", "edge_src", "edge_dst", "edge_type",
        "edge_mask"])
    k, g, n = cfg.k, cfg_eval.eval_batch_size * 2, cfg.max_node_num
    e = detail["edge_src"].shape[1]
    assert detail["logits"].shape == (cfg_eval.eval_batch_size, 2)
    assert detail["pool_attn"].shape == (cfg.att_head_num * g, n)
    assert detail["gnn_edge_alpha"].shape == (k, g, e, 4)
    assert detail["gnn_self_alpha"].shape == (k, g, n, 4)
    assert detail["concept_ids"].shape == detail["node_types"].shape == (g, n)
    assert detail["edge_mask"].shape == detail["edge_type"].shape == (g, e)
    assert np.isfinite(detail["gnn_edge_alpha"]).all()
    assert (detail["gnn_edge_alpha"] >= 0).all()

    # warm start / resume, with the profiler over its one step
    saved_step = int(torch.load(os.path.join(ckpt, "state.pt"),
                                weights_only=True)["optimizer"]["step"])
    cfg_resume = dataclasses.replace(
        cfg, load_model_path=ckpt, save_dir=str(tmp_path / "out_resume"),
        n_epochs=1, save_model=False, profile_dir=str(tmp_path / "prof"),
        profile_start_step=0, profile_num_steps=1)
    printed = []
    monkeypatch.setattr("builtins.print",
                        lambda *a, **k: printed.append(" ".join(map(str, a))))
    r3 = cli.train(cfg_resume, device="cpu")
    assert r3["best_dev_acc"] == 1.0
    assert f"resumed from {ckpt} at step {saved_step}" in printed
    assert (tmp_path / "prof" / "trace.json").exists()


@pytest.fixture
def _no_dropout(monkeypatch):
    """Dropout off on both sides: flax's Dropout and every use of the
    port's `dropout` (the pooler's rate and the tiny encoder's are fixed)."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    identity = lambda x, p, training, mask_shape=None: x   # noqa: E731
    dropout = layers.dropout
    for name, mod in list(sys.modules.items()):
        if name.startswith("qagnn_tpu_torch.") and \
                getattr(mod, "dropout", None) is dropout:
            monkeypatch.setattr(mod, "dropout", identity)


def test_train_matches_the_jax_cli(tmp_path, tokenizer, monkeypatch,
                                      _no_dropout):
    root = str(tmp_path / "data")
    emb_path = write_synthetic_dataset(root, n_questions=8)
    kw = dict(n_epochs=2, unfreeze_epoch=1, gnn_dtype="float32", k=2,
              decoder_lr=3e-3, encoder_lr=1e-3, max_epochs_before_stop=10,
              save_model=True)

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
    tok = tokenizer
    want = jax_cli.train(_cfg(jax_config, root, emb_path, mesh_data=1,
                              save_dir=str(tmp_path / "jax"), **kw))

    # the port from the same variables
    v = {k: jax.tree.map(np.asarray, t)
         for k, t in seen["variables"].items()}
    monkeypatch.setattr(cli, "init_weights", lambda model, gen, std:
                        load_flax_variables(model, v["params"],
                                            v["batch_stats"]))
    _with_tokenizer(monkeypatch, tokenizer)
    got = cli.train(_cfg(config, root, emb_path,
                         save_dir=str(tmp_path / "port"), **kw),
                    device="cpu")

    assert len(got["train_losses"]) == len(want["train_losses"]) == 4
    np.testing.assert_allclose(got["train_losses"], want["train_losses"],
                               rtol=2e-4)
    assert (tmp_path / "port" / "log.csv").read_text() == \
        (tmp_path / "jax" / "log.csv").read_text()
    assert got["best_dev_epoch"] == want["best_dev_epoch"]

    # the best-dev checkpoints: parameters and BatchNorm running statistics
    # (one update a microbatch) within tests/test_torch_train_step.py's
    # tolerance, the frozen entity table exactly
    jax_state, _ = jax_checkpoint.load_checkpoint(
        str(tmp_path / "jax" / "checkpoint"))
    state, saved_cfg = load_checkpoint(str(tmp_path / "port" / "checkpoint"))
    _, model, _, _ = cli.build_model_and_data(saved_cfg, "cpu")
    model.load_state_dict(state["model"])
    params, stats = to_flax_variables(model)
    for name, (g, w) in {"params": (params, jax_state["params"]),
                         "batch_stats": (stats, jax_state["batch_stats"])
                         }.items():
        g, w = _flat(g), _flat(w)
        assert sorted(g) == sorted(w), name
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3, atol=2e-5,
                                       err_msg=f"{name} {k}")
    table = "decoder/concept_emb/emb/embedding"
    np.testing.assert_array_equal(_flat(params)[table],
                                  np.load(emb_path).astype(np.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _every_flag():
    """argv setting every TrainConfig field to a value other than its
    default."""
    argv = []
    for f in dataclasses.fields(jax_config.TrainConfig):
        d = f.default
        if isinstance(d, bool):
            value = [str(not d).lower()]
        elif isinstance(d, int):
            value = [str(d + 3)]
        elif isinstance(d, float):
            value = ["0.125"]
        elif isinstance(d, tuple):
            value = ["x.npy", "y.npy"]
        else:
            value = [f"{f.name}.value"]
        argv += ["--" + f.name, *value]
    return argv


@pytest.mark.parametrize("argv", [[], ["--dataset", "obqa"], _every_flag()],
                         ids=["defaults", "obqa", "every_flag"])
def test_parser_matches_jax(argv):
    assert [(f.name, f.default) for f in dataclasses.fields(
        config.TrainConfig)] == [(f.name, f.default) for f in
                                 dataclasses.fields(jax_config.TrainConfig)]
    got = dataclasses.asdict(config.config_from_argv(argv))
    assert got == dataclasses.asdict(jax_config.config_from_argv(argv))
    assert "device" not in got


@pytest.mark.parametrize("mode", ["train", "eval_detail"])
def test_main_hands_the_device_to_the_entry_point(monkeypatch, mode):
    called = []
    monkeypatch.setattr(cli, mode, lambda cfg, device: called.append(
        (cfg, device)) or "ran")
    argv = ["--mode", mode, "--dataset", "obqa", "--k", "2"]
    assert cli.main(argv + ["--device", "cpu"]) == "ran"
    assert called[0] == (config.config_from_argv(argv), "cpu")
    cli.main(argv)
    assert called[1][1] is None


@pytest.mark.parametrize("mode", ["train", "eval_detail"])
def test_no_card_and_no_device_raises(monkeypatch, tmp_path, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--mode", mode, "--save_dir", str(tmp_path / "out"),
                  "--load_model_path", str(tmp_path / "ckpt")])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("kw,match", [
    (dict(mesh_data=2), "A7"), (dict(mesh_model=2), "A7"),
])
def test_unported_options_raise(tmp_path, kw, match):
    cfg = config.TrainConfig(save_dir=str(tmp_path), **kw).resolved()
    with pytest.raises(NotImplementedError, match=match):
        cli.train(cfg, device="cpu")


@pytest.mark.parametrize("name,hidden,layers_", [
    ("roberta-large", 1024, 24), ("roberta-base", 768, 12),
    ("bert-base-uncased", 768, 12), ("bert-large-cased", 1024, 24),
    ("cambridgeltl/SapBERT-from-PubMedBERT-fulltext", 768, 12),
    ("tiny", 32, 2), ("albert-base-v2", 768, 12),
    ("albert-xxlarge-v2", 4096, 12), ("openai-gpt", 768, 12),
    ("tiny-gpt", 32, 2), ("xlnet-large-cased", 1024, 24),
    ("xlnet-base-cased", 768, 12), ("tiny-xlnet", 32, 2), ("lstm", 300, 2),
    ("tiny-lstm", 16, 2)])
def test_encoder_config_for_matches_jax(name, hidden, layers_, tmp_path):
    """Field by field, in both dtypes (the LSTM computes in f32 whatever
    --encoder_dtype says); the LSTMs' vocabulary is that of --lstm_vocab."""
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(f"w{i}" for i in range(40)))
    lstm_vocab = str(vocab) if "lstm" in name else None
    for dtype in ("float32", "bfloat16"):
        got = cli.encoder_config_for(config.TrainConfig(
            encoder=name, encoder_dtype=dtype, lstm_vocab=lstm_vocab))
        want = jax_cli.encoder_config_for(jax_config.TrainConfig(
            encoder=name, encoder_dtype=dtype, lstm_vocab=lstm_vocab))
        assert type(got).__name__ == type(want).__name__
        assert (got.hidden_size, got.num_layers) == (hidden, layers_)
        assert got.dtype == (torch.float32 if "lstm" in name
                             else getattr(torch, dtype))
        for f in dataclasses.fields(got):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
    if "lstm" in name:
        assert got.vocab_size == 44          # 40 words and 4 extra tokens


@pytest.mark.parametrize("name", ["lstm", "unknown"])
def test_encoder_config_for_refuses_as_jax(name):
    """--encoder lstm without --lstm_vocab, and a name no family takes,
    raise ValueError in both packages."""
    with pytest.raises(ValueError):
        cli.encoder_config_for(config.TrainConfig(encoder=name))
    with pytest.raises(ValueError):
        jax_cli.encoder_config_for(jax_config.TrainConfig(encoder=name))
