"""The port's CLI on a 2 x 2 grid of CPU ranks (gloo), against the JAX CLI.

(a) cli.train on the grid (2 data x 2 model ranks, the entity table's rows
    split over `model`) gives the per-step losses of qagnn_tpu.cli.train at
    1 x 1 on the same files within rtol 2e-4, tests/test_torch_cli.py's
    tolerance, with its set-up: the JAX run's initial variables carried
    across by utils/convert.py, dropout patched to the identity on both
    sides, the JAX CLI's sample batch drawn from the port's loader; and
    those of qagnn_tpu.cli.train on its own 2 x 2 mesh (the 8-device CPU
    mesh of tests/conftest.py), within the same rtol. The log and the best
    epoch are equal, and so is the best-dev checkpoint (rank 0
    writes it, the table gathered) to the JAX one, within that file's rtol
    1e-3 / atol 2e-5.
(b) That checkpoint loads into a one-rank eval_detail whose dev logits
    equal the grid's own evaluation of the epoch (1e-5 of the largest
    value: the same weights, sums over another partition).
(c) The reverse: a one-rank run's checkpoint resumes on the grid, whose
    losses equal a one-rank resume's (rtol 2e-4).
(d) dryrun_multichip(4) trains an epoch through cli.train, which starts
    its own ranks.
(e) With dropout on, for tiny-xlnet and tiny-lstm (whose relative
    position table and vocabulary-row masks are not rows of the batch),
    the grid's losses equal a one-rank run's (rtol 2e-4): every rank
    draws the one-rank run's masks.

Every spawn of ranks has a 120 s limit. The ranks import this module and
no JAX: it is imported in the parent's fixtures only.
"""

import contextlib
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import qagnn_tpu_torch.cli as cli
from qagnn_tpu_torch.data.synthetic import VOCAB, write_synthetic_dataset
from qagnn_tpu_torch.models import layers
from qagnn_tpu_torch.parallel.launch import run_ranks
from qagnn_tpu_torch.utils import config
from qagnn_tpu_torch.utils.checkpoint import load_checkpoint
from qagnn_tpu_torch.utils.convert import (
    load_flax_variables,
    to_flax_variables,
)

SPAWN_S = 120
GRID = dict(mesh_data=2, mesh_model=2)
KW = dict(n_epochs=2, unfreeze_epoch=1, gnn_dtype="float32", k=2,
          decoder_lr=3e-3, encoder_lr=1e-3, max_epochs_before_stop=10,
          save_model=True, gnn_backend="cuda")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(module, root, emb_path, **kw):
    """As tests/test_torch_cli.py's: a resolved TrainConfig of `module` for
    the synthetic set at `root`."""
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


def _tokenizer(vocab_path):
    from transformers import BertTokenizerFast
    return BertTokenizerFast(vocab_file=vocab_path, do_lower_case=True)


@contextlib.contextmanager
def _patched_port(vocab_path, variables=None, logits=None):
    """Within the block: the port's CLI with the test's tokenizer, dropout
    the identity, initial weights from `variables` (a flax tree) when
    given, and every logits array it computes appended to `logits`."""
    tok = _tokenizer(vocab_path)
    saved = [(cli, "build_model_and_data"), (cli, "init_weights"),
             (cli, "_logits")] + [
        (mod, "dropout") for name, mod in list(sys.modules.items())
        if name.startswith("qagnn_tpu_torch.")
        and getattr(mod, "dropout", None) is layers.dropout]
    saved = [(obj, name, getattr(obj, name)) for obj, name in saved]
    build, to_numpy = cli.build_model_and_data, cli._logits
    cli.build_model_and_data = lambda cfg, device, tokenizer=None, \
        gnn_mesh=None: build(cfg, device, tokenizer=tok, gnn_mesh=gnn_mesh)
    identity = lambda x, p, training, *a, **k: x  # noqa: E731
    for obj, name, _ in saved[3:]:
        setattr(obj, name, identity)
    if variables is not None:
        cli.init_weights = lambda model, gen, std: load_flax_variables(
            model, variables["params"], variables["batch_stats"])
    if logits is not None:
        cli._logits = lambda out: logits.append(to_numpy(out)) or logits[-1]
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def _rank_train(cfg, vocab_path, variables):
    """One rank of cli.train on the grid; returns (result, the logits of
    every evaluation batch)."""
    logits = []
    with _patched_port(vocab_path, variables, logits):
        return cli.train(cfg, "cpu"), logits


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("grid_cli")
    emb_path = write_synthetic_dataset(str(root / "data"), n_questions=8)
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(VOCAB))
    return root, emb_path, str(vocab)


def _jax_train(data, save_dir, **mesh):
    """qagnn_tpu.cli.train on the synthetic set with dropout off; returns
    its result and initial variables."""
    import flax.linen as fnn
    import jax

    import qagnn_tpu.cli as jax_cli
    import qagnn_tpu.utils.initialization as jax_init
    from qagnn_tpu.utils import config as jax_config

    root, emb_path, vocab = data
    mp = pytest.MonkeyPatch()
    seen = {}
    init = jax_init.init_variables

    def keep(*a, **k):
        seen["variables"] = init(*a, **k)
        return seen["variables"]
    tok = _tokenizer(vocab)
    orig = jax_cli.build_model_and_data
    try:
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, inputs, *a, **k: inputs)
        mp.setattr(jax_init, "init_variables", keep)
        mp.setattr(jax_cli, "build_model_and_data",
                   lambda cfg, tokenizer=None, gnn_mesh=None:
                   orig(cfg, tokenizer=tok, gnn_mesh=gnn_mesh))
        kw = {k: v for k, v in KW.items() if k != "gnn_backend"}
        result = jax_cli.train(_cfg(jax_config, str(root / "data"), emb_path,
                                    save_dir=str(root / save_dir), **mesh,
                                    **kw))
    finally:
        mp.undo()
    variables = {k: jax.tree.map(np.asarray, t)
                 for k, t in seen["variables"].items()}
    return result, variables


@pytest.fixture(scope="module")
def jax_run(data):
    """qagnn_tpu.cli.train at 1 x 1, its initial variables kept."""
    return _jax_train(data, "jax", mesh_data=1)


@pytest.fixture(scope="module")
def grid_run(data, jax_run):
    root, emb_path, vocab = data
    cfg = _cfg(config, str(root / "data"), emb_path,
               save_dir=str(root / "grid"), **GRID, **KW)
    results = run_ranks(_rank_train, 4, "gloo", "cpu", SPAWN_S, cfg, vocab,
                        jax_run[1])
    return cfg, results


def test_grid_train_matches_the_jax_cli(data, jax_run, grid_run):
    root = data[0]
    want = jax_run[0]
    _, results = grid_run
    got = results[0][0]
    assert len(got["train_losses"]) == len(want["train_losses"]) == 4
    np.testing.assert_allclose(got["train_losses"], want["train_losses"],
                               rtol=2e-4)
    for r, _ in results[1:]:                 # every rank reports the same
        assert r["train_losses"] == got["train_losses"]
    assert (root / "grid" / "log.csv").read_text() == \
        (root / "jax" / "log.csv").read_text()
    assert got["best_dev_epoch"] == want["best_dev_epoch"]


def test_grid_train_matches_the_jax_cli_on_its_mesh(data, jax_run, grid_run):
    """The JAX CLI's 2 x 2 mesh run, from the same initial variables (one
    seed), gives the grid's losses too."""
    want, variables = _jax_train(data, "jax_mesh", **GRID)
    for name in ("params", "batch_stats"):
        for k, w in _flat(jax_run[1][name]).items():
            np.testing.assert_array_equal(_flat(variables[name])[k], w)
    got = grid_run[1][0][0]
    np.testing.assert_allclose(got["train_losses"], want["train_losses"],
                               rtol=2e-4)
    assert got["best_dev_epoch"] == want["best_dev_epoch"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_grid_checkpoint_matches_the_jax_checkpoint(data, jax_run, grid_run):
    """Rank 0's checkpoint holds the whole entity table (gathered from the
    model ranks), the trained parameters and BatchNorm statistics of the
    JAX CLI's."""
    from qagnn_tpu.utils import checkpoint as jax_checkpoint

    root, emb_path, vocab = data
    jax_state, _ = jax_checkpoint.load_checkpoint(str(root / "jax" /
                                                      "checkpoint"))
    state, saved_cfg = load_checkpoint(str(root / "grid" / "checkpoint"))
    assert (saved_cfg.mesh_data, saved_cfg.mesh_model) == (2, 2)
    _, model, _, _ = cli.build_model_and_data(
        dataclasses.replace(saved_cfg, mesh_data=0, mesh_model=1), "cpu",
        tokenizer=_tokenizer(vocab))
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
    np.testing.assert_array_equal(
        _flat(params)["decoder/concept_emb/emb/embedding"],
        np.load(emb_path).astype(np.float32))


def _questions(root, split):
    path = root / "data" / "statement" / f"{split}.statement.jsonl"
    return len(path.read_text().splitlines())


def test_grid_checkpoint_loads_on_one_rank(data, grid_run):
    """eval_detail at 1 x 1 from the grid's checkpoint: its dev logits are
    the grid's own evaluation of the checkpointed epoch."""
    root, _, vocab = data
    cfg, results = grid_run
    result, grid_logits = results[0]
    n_dev, n_test = (-(-_questions(root, split) // cfg.eval_batch_size)
                     for split in ("dev", "test"))
    epoch = result["best_dev_epoch"]
    dev_of_epoch = grid_logits[epoch * (n_dev + n_test):][:n_dev]

    logits = []
    cfg_eval = dataclasses.replace(
        cfg, mode="eval_detail", detail_batches=0,
        load_model_path=str(root / "grid" / "checkpoint"),
        save_dir=str(root / "grid_eval"))
    os.makedirs(cfg_eval.save_dir)
    with _patched_port(vocab, logits=logits):
        out = cli.eval_detail(cfg_eval, "cpu")
    assert out["dev_acc"] == result["best_dev_acc"]
    got = np.concatenate(logits[:n_dev])
    want = np.concatenate(dev_of_epoch)
    assert got.shape == want.shape == (n_dev * cfg.eval_batch_size, 2)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _rank_resume(cfg, vocab_path):
    with _patched_port(vocab_path):
        return cli.train(cfg, "cpu")


def test_one_rank_checkpoint_resumes_on_the_grid(data, grid_run):
    """A one-rank run's checkpoint resumed for an epoch on the 2 x 2 grid
    gives the losses of the same resume on one rank."""
    root, emb_path, vocab = data
    one = _cfg(config, str(root / "data"), emb_path,
               save_dir=str(root / "one"), **KW)
    resume = dict(n_epochs=1, save_model=False,
                  load_model_path=str(root / "one" / "checkpoint"))
    with _patched_port(vocab):
        cli.train(one, "cpu")
        want = cli.train(dataclasses.replace(
            one, save_dir=str(root / "one_resumed"), **resume), "cpu")
    grid_cfg = dataclasses.replace(one, save_dir=str(root / "grid_resumed"),
                                   **GRID, **resume)
    got = run_ranks(_rank_resume, 4, "gloo", "cpu", SPAWN_S, grid_cfg,
                    vocab)[0]
    assert len(got["train_losses"]) == len(want["train_losses"]) == 2
    np.testing.assert_allclose(got["train_losses"], want["train_losses"],
                               rtol=2e-4)
    assert got["best_dev_acc"] == want["best_dev_acc"]


def test_dryrun_multichip_trains_on_four_ranks():
    from qagnn_tpu_torch.parallel.dryrun import dryrun_multichip
    result = dryrun_multichip(4, device="cpu")
    assert len(result["train_losses"]) == 1
    assert np.isfinite(result["train_losses"]).all()


# the tiny LSTM's own dropouts, which its preset leaves at 0
LSTM_DROPOUT = dict(emb_p=0.2, input_p=0.2, hidden_p=0.2)
DROPOUT_ENCODERS = ("tiny-xlnet", "tiny-lstm")


@contextlib.contextmanager
def _dropout_on(vocab_path, seen=None):
    """Within the block: the port's CLI with the test's tokenizer (the
    LSTM reads --lstm_vocab itself) and the tiny LSTM's dropouts on; with
    `seen`, each mask drawn in training is recorded as (p, replicated)."""
    tok = _tokenizer(vocab_path)
    build, enc_config = cli.build_model_and_data, cli.encoder_config_for
    saved = [(cli, "build_model_and_data", build),
             (cli, "encoder_config_for", enc_config)]
    cli.build_model_and_data = lambda cfg, device, tokenizer=None, \
        gnn_mesh=None: build(cfg, device, tokenizer=None if "lstm" in
                             cfg.encoder else tok, gnn_mesh=gnn_mesh)
    cli.encoder_config_for = lambda cfg: dataclasses.replace(
        enc_config(cfg), **LSTM_DROPOUT) if "lstm" in cfg.encoder \
        else enc_config(cfg)
    if seen is not None:
        dropout = layers.dropout

        def spy(x, p, training, mask_shape=None, replicated=False):
            if training and p > 0:
                seen.add((p, replicated))
            return dropout(x, p, training, mask_shape, replicated)
        saved += [(mod, "dropout", dropout)
                  for name, mod in list(sys.modules.items())
                  if name.startswith("qagnn_tpu_torch.")
                  and getattr(mod, "dropout", None) is dropout]
        for mod, name, _ in saved[2:]:
            setattr(mod, name, spy)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


def _dropout_cfgs(data, **mesh):
    root, emb_path, _ = data
    cfgs = []
    for encoder in DROPOUT_ENCODERS:
        kw = dict(KW, n_epochs=2, unfreeze_epoch=0, save_model=False,
                  encoder=encoder, dropouti=0.2, dropoutg=0.2, dropoutf=0.2)
        if encoder == "tiny-lstm":
            kw["lstm_vocab"] = str(root / "words.json")
        cfgs.append(_cfg(config, str(root / "data"), emb_path, save_dir=str(
            root / f"dropout_{encoder}_{len(mesh)}"), **mesh, **kw))
    return cfgs


def _rank_train_dropout(cfgs, vocab_path):
    with _dropout_on(vocab_path):
        return [cli.train(cfg, "cpu") for cfg in cfgs]


@pytest.fixture(scope="module")
def dropout_runs(data):
    """Each of DROPOUT_ENCODERS trained with dropout on at 1 x 1 and on the
    2 x 2 grid (one spawn for both), and the masks the one-rank runs
    drew."""
    from qagnn_tpu_torch.data.word_tokenizer import make_word_vocab

    root, _, vocab = data
    make_word_vocab([str(root / "data" / "statement" /
                         f"{s}.statement.jsonl")
                     for s in ("train", "dev", "test")],
                    str(root / "words.json"), freq_cutoff=1)
    one, seen = [], {}
    for cfg in _dropout_cfgs(data):
        seen[cfg.encoder] = set()
        with _dropout_on(vocab, seen[cfg.encoder]):
            one.append(cli.train(cfg, "cpu"))
    grid = run_ranks(_rank_train_dropout, 4, "gloo", "cpu", SPAWN_S,
                     _dropout_cfgs(data, **GRID), vocab)[0]
    return dict(zip(DROPOUT_ENCODERS, zip(one, grid))), seen


@pytest.mark.parametrize("encoder", DROPOUT_ENCODERS)
def test_grid_draws_the_one_rank_dropout_masks(dropout_runs, encoder):
    runs, seen = dropout_runs
    want, got = runs[encoder]
    # the encoder drew a mask of a tensor that is not rows of the batch
    assert (0.1 if encoder == "tiny-xlnet" else 0.2, True) in seen[encoder]
    assert len(got["train_losses"]) == len(want["train_losses"]) == 4
    np.testing.assert_allclose(got["train_losses"], want["train_losses"],
                               rtol=2e-4)
    assert got["best_dev_acc"] == want["best_dev_acc"]
