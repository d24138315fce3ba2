"""Checkpoints of the port (CPU): utils/checkpoint.py.

save -> load -> restore_into gives back the parameters, BatchNorm
statistics, optimizer moments, counts and step, the dropout generator and
the run's config, bit for bit; and a run of 2 steps, a save, a restore into
freshly built objects and 2 more steps gives the losses and parameters of 4
uninterrupted steps exactly (dropout on, so the generator's state matters).
The model is a tiny RoBERTa-style encoder with a k=2 decoder; inputs are
made with numpy from a seed.
"""

import os

import numpy as np
import pytest
import torch

from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.models.qagnn import LMQAGNN
from qagnn_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from qagnn_tpu_torch.train.optim import (
    build_train_optimizer,
    entity_table_names,
)
from qagnn_tpu_torch.train.step import Batch, make_train_step
from qagnn_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    restore_into,
    save_checkpoint,
)
from qagnn_tpu_torch.utils.config import TrainConfig
from qagnn_tpu_torch.utils.initialization import init_weights

B, C, L, N, E = 2, 2, 10, 8, 16
G = B * C
OPT = dict(optim="radam", encoder_lr=3e-3, decoder_lr=1e-2,
           weight_decay=0.01, max_grad_norm=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 64, (B, C, L)).astype(np.int32)
    am = np.ones((B, C, L), np.int32)
    am[:, :, -2:] = 0
    num_nodes = rng.integers(3, N + 1, G).astype(np.int32)
    node_types = rng.integers(0, 3, (G, N)).astype(np.int32)
    node_types[:, 0] = 3
    concept_ids = rng.integers(1, 30, (G, N)).astype(np.int32)
    concept_ids[:, 0] = 0
    graph = BatchedGraphs(
        concept_ids=torch.from_numpy(concept_ids),
        node_types=torch.from_numpy(node_types),
        node_scores=torch.from_numpy(
            rng.standard_normal((G, N)).astype(np.float32)),
        num_nodes=torch.from_numpy(num_nodes),
        edge_src=torch.from_numpy(np.stack(
            [rng.integers(0, n, E) for n in num_nodes]).astype(np.int32)),
        edge_dst=torch.from_numpy(np.stack(
            [rng.integers(0, n, E) for n in num_nodes]).astype(np.int32)),
        edge_type=torch.from_numpy(
            rng.integers(0, 6, (G, E)).astype(np.int32)),
        edge_mask=torch.from_numpy(rng.random((G, E)) > 0.3))
    labels = torch.from_numpy(rng.integers(0, C, B).astype(np.int32))
    return Batch({"input_ids": torch.from_numpy(ids),
                  "attention_mask": torch.from_numpy(am)}, graph, labels)


def _run(seed):
    """A model, its optimizer and a generator, the weights drawn from
    `seed`; dropout 0.2 everywhere."""
    enc = TextEncoderConfig.tiny(vocab_size=64, hidden_size=16,
                                 num_layers=1, intermediate_size=32,
                                 max_position_embeddings=L + 4,
                                 hidden_dropout=0.2, attention_dropout=0.2)
    model = LMQAGNN(TextEncoder(enc), sent_dim=16, k=2, n_ntype=4, n_etype=6,
                    n_concept=30, concept_dim=8, concept_in_dim=12,
                    n_attention_head=2, fc_dim=8, n_fc_layer=1)
    gen = torch.Generator().manual_seed(seed)
    init_weights(model, gen)
    opt = build_train_optimizer(model, frozen=entity_table_names(model),
                                **OPT)
    return model, opt, gen, make_train_step(model, opt, device="cpu")


def _steps(step, gen, seeds, trainable=True):
    return [float(step(_batch(s), trainable, gen)["loss"]) for s in seeds]


def _state(model, opt, gen):
    return ({k: v.clone() for k, v in model.state_dict().items()},
            {k: v.clone() for k, v in opt.state.items()}, gen.get_state())


def _assert_states_equal(got, want):
    for g, w in zip(got[:2], want[:2]):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k
    assert torch.equal(got[2], want[2])


def test_save_load_restores_everything(tmp_path):
    model, opt, gen, step = _run(0)
    _steps(step, gen, (1, 2), trainable=True)
    _steps(step, gen, (3,), trainable=False)
    want = _state(model, opt, gen)
    assert int(opt.state["step"]) == 3 and int(opt.state["encoder.count"]) == 2
    cfg = TrainConfig(dataset="obqa", encoder="tiny", ent_emb_paths=("a.npy",),
                      test_adj=None).resolved()
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, model, opt, gen, cfg)
    assert os.listdir(path) == ["state.pt"]

    model2, opt2, gen2, _ = _run(7)
    assert not torch.equal(model2.decoder.svec2nvec.weight,
                           model.decoder.svec2nvec.weight)
    state, cfg2 = load_checkpoint(path)
    restore_into(state, model2, opt2, gen2)
    _assert_states_equal(_state(model2, opt2, gen2), want)
    assert cfg2 == cfg


def test_save_replaces_an_existing_checkpoint(tmp_path):
    model, opt, gen, step = _run(0)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, model, opt, gen)
    _steps(step, gen, (1,))
    save_checkpoint(path, model, opt, gen)
    state, cfg = load_checkpoint(path)
    assert cfg is None and int(state["optimizer"]["step"]) == 1
    assert torch.equal(state["model"]["decoder.svec2nvec.weight"],
                       model.decoder.svec2nvec.weight)


def test_restore_refuses_another_optimizer(tmp_path):
    model, opt, gen, _ = _run(0)
    save_checkpoint(str(tmp_path / "ckpt"), model, opt, gen)
    state, _ = load_checkpoint(str(tmp_path / "ckpt"))
    sgd = build_train_optimizer(model, **dict(OPT, optim="sgd"))
    with pytest.raises(KeyError, match="optimizer state keys differ"):
        restore_into(state, model, sgd)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    seeds = (11, 12, 13, 14)
    model, opt, gen, step = _run(0)
    want_losses = _steps(step, gen, seeds)
    want = _state(model, opt, gen)

    model, opt, gen, step = _run(0)
    losses = _steps(step, gen, seeds[:2])
    save_checkpoint(str(tmp_path / "ckpt"), model, opt, gen)
    del model, opt, gen, step

    model, opt, gen, step = _run(5)
    state, _ = load_checkpoint(str(tmp_path / "ckpt"))
    restore_into(state, model, opt, gen)
    losses += _steps(step, gen, seeds[2:])
    assert losses == want_losses
    _assert_states_equal(_state(model, opt, gen), want)
