"""The port's train step against the JAX package's (CPU, f32).

A tiny RoBERTa-style encoder and a k=2 decoder on the fused branch (the
kernels' plain versions here; Pallas in interpret mode on the JAX side),
three steps of `make_train_step` from the same variables, with RAdam, global
norm clipping and the entity table frozen; the middle step runs with the
encoder frozen. Compared: the loss of every step, and all parameters and
BatchNorm running statistics after the last one, for one microbatch with
cross entropy and two microbatches with the margin ranking loss.

Dropout is 0 on both sides (flax's Dropout is patched to the identity while
this module runs: the flax pooler's rate is not a constructor argument of the
flax model). Tolerance: losses rtol 2e-4; parameters and statistics rtol 1e-3
with an absolute floor of 2e-5 (three steps of at most 1e-2 each, whose
directions agree to about 1e-3).
"""

import flax.linen as fnn
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qagnn_tpu.graph.container import BatchedGraphs as JaxGraphs
from qagnn_tpu.models.qagnn import LMQAGNN as JaxLMQAGNN
from qagnn_tpu.models.text_encoder import (
    TextEncoder as JaxTextEncoder,
    TextEncoderConfig as JaxTextEncoderConfig,
)
from qagnn_tpu.train import optim as jax_optim
from qagnn_tpu.train import step as jax_step

from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.models.qagnn import LMQAGNN
from qagnn_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from qagnn_tpu_torch.train.optim import (
    build_train_optimizer,
    entity_table_names,
)
from qagnn_tpu_torch.train.step import Batch, make_train_step
from qagnn_tpu_torch.utils.convert import (
    load_flax_variables,
    to_flax_variables,
)

B, C, L, N, E = 4, 2, 12, 10, 20
G = B * C
K, D, N_NTYPE, N_ETYPE, N_CONCEPT, CIN, FC = 2, 16, 4, 7, 40, 24, 8
ENC = dict(hidden_dropout=0.0, attention_dropout=0.0, hidden_size=32,
           num_layers=2, num_heads=2, intermediate_size=64,
           max_position_embeddings=L + 4, type_vocab_size=1,
           layer_norm_eps=1e-5, pad_token_id=1, roberta_style_positions=True)
OPT = dict(optim="radam", encoder_lr=3e-3, decoder_lr=1e-2,
           weight_decay=0.01, max_grad_norm=1.0)
TRAINABLE = (True, False, True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the machine's cores: one intra-op thread keeps
    this file's torch ops from crowding out the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _flax_dropout_is_identity():
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__", lambda self, inputs, *a, **k: inputs)
    yield
    mp.undo()


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 128, (B, C, L)).astype(np.int32)
    am = np.ones((B, C, L), np.int32)
    ids[:, :, -3:] = 1
    am[:, :, -3:] = 0
    num_nodes = rng.integers(4, N + 1, G).astype(np.int32)
    concept_ids = rng.integers(1, N_CONCEPT, (G, N)).astype(np.int32)
    concept_ids[:, 0] = 0
    node_types = rng.integers(0, 3, (G, N)).astype(np.int32)
    node_types[:, 0] = 3
    mask = rng.random((G, E)) > 0.3
    mask[1] = False
    graph = dict(
        concept_ids=concept_ids, node_types=node_types,
        node_scores=rng.standard_normal((G, N)).astype(np.float32),
        num_nodes=num_nodes,
        edge_src=np.stack([rng.integers(0, n, E) for n in num_nodes])
        .astype(np.int32),
        edge_dst=np.stack([rng.integers(0, n, E) for n in num_nodes])
        .astype(np.int32),
        edge_type=rng.integers(0, N_ETYPE, (G, E)).astype(np.int32),
        edge_mask=mask)
    labels = rng.integers(0, C, B).astype(np.int32)
    return {"input_ids": ids, "attention_mask": am}, graph, labels


def _jax_model():
    return JaxLMQAGNN(
        encoder=JaxTextEncoder(JaxTextEncoderConfig.tiny(**ENC)),
        sent_dim=ENC["hidden_size"], k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE,
        n_concept=N_CONCEPT, concept_dim=D, concept_in_dim=CIN,
        n_attention_head=2, fc_dim=FC, n_fc_layer=1, p_emb=0.0, p_gnn=0.0,
        p_fc=0.0, gnn_backend="pallas")


def _port_model(p=0.0):
    enc = dict(ENC, hidden_dropout=p, attention_dropout=p)
    model = LMQAGNN(
        TextEncoder(TextEncoderConfig.tiny(**enc)),
        sent_dim=ENC["hidden_size"], k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE,
        n_concept=N_CONCEPT, concept_dim=D, concept_in_dim=CIN,
        n_attention_head=2, fc_dim=FC, n_fc_layer=1, p_emb=p, p_gnn=p,
        p_fc=p, gnn_backend="cuda")
    model.decoder.pooler.dropout = p
    model.decoder.pooler.attention.attn_dropout = p
    return model


def _torch_batch(lm, graph, labels):
    return Batch({k: torch.from_numpy(v) for k, v in lm.items()},
                 BatchedGraphs(**{k: torch.from_numpy(v)
                                  for k, v in graph.items()}),
                 torch.from_numpy(labels))


@pytest.fixture(scope="module")
def variables():
    lm, graph, _ = _batch(0)
    jlm = {k: jnp.asarray(v) for k, v in lm.items()}
    jgraph = JaxGraphs(**{k: jnp.asarray(v) for k, v in graph.items()})
    jmodel = _jax_model().clone(gnn_backend="scatter")
    v = jmodel.init(jax.random.PRNGKey(0), jlm, jgraph)
    return {"params": jax.tree.map(np.asarray, v["params"]),
            "batch_stats": jax.tree.map(np.asarray, v["batch_stats"])}


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(got, want, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-3, atol=2e-5,
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("microbatches,loss_name",
                         [(1, "cross_entropy"), (2, "margin_rank")])
def test_three_train_steps_match_jax(variables, microbatches, loss_name):
    batches = [_batch(seed) for seed in (1, 2, 3)]

    jmodel = _jax_model()
    jparams = jax.tree.map(jnp.asarray, variables["params"])
    frozen = jax.tree_util.tree_map_with_path(
        lambda path, _: "concept_emb" in jax_optim.path_str(path)
        and "embedding" in jax_optim.path_str(path), jparams)
    jopt = jax_optim.build_train_optimizer(jparams, frozen_param_mask=frozen,
                                           **OPT)
    state = jax_step.TrainState(
        params=jparams,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jopt.init(jparams), step=jnp.zeros([], jnp.int32),
        rng=jax.random.PRNGKey(0))
    jstep = jax_step.make_train_step(jmodel, jopt, loss_name=loss_name,
                                     num_microbatches=microbatches)
    want_losses = []
    for (lm, graph, labels), trainable in zip(batches, TRAINABLE):
        jb = jax_step.Batch(
            lm_inputs={k: jnp.asarray(v) for k, v in lm.items()},
            graph=JaxGraphs(**{k: jnp.asarray(v) for k, v in graph.items()}),
            labels=jnp.asarray(labels))
        state, metrics = jstep(state, jb, trainable)
        want_losses.append(float(metrics["loss"]))

    model = _port_model()
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    opt = build_train_optimizer(model, frozen=entity_table_names(model),
                                **OPT)
    step = make_train_step(model, opt, device="cpu", loss_name=loss_name,
                           num_microbatches=microbatches)
    got_losses = []
    for b, trainable in zip(batches, TRAINABLE):
        got_losses.append(float(step(_torch_batch(*b), trainable)["loss"]))

    np.testing.assert_allclose(got_losses, want_losses, rtol=2e-4)
    params, stats = to_flax_variables(model)
    _assert_trees_close(params, state.params, "parameters")
    _assert_trees_close(stats, state.batch_stats, "running statistics")
    assert int(opt.state["step"]) == 3
    assert int(opt.state["encoder.count"]) == 2
    np.testing.assert_array_equal(
        params["decoder"]["concept_emb"]["emb"]["embedding"],
        variables["params"]["decoder"]["concept_emb"]["emb"]["embedding"])


def test_frozen_step_leaves_the_encoder_alone(variables):
    model = _port_model()
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    opt = build_train_optimizer(model, frozen=entity_table_names(model),
                                **OPT)
    step = make_train_step(model, opt, device="cpu")
    before = {n: p.detach().clone()
              for n, p in model.encoder.named_parameters()}
    dec = model.decoder.svec2nvec.weight.detach().clone()
    step(_torch_batch(*_batch(1)), encoder_trainable=False)
    for n, p in model.encoder.named_parameters():
        assert torch.equal(p, before[n]), n
        assert p.grad is None and p.requires_grad, n
    assert not torch.equal(model.decoder.svec2nvec.weight, dec)
    assert int(opt.state["encoder.count"]) == 0
    assert all(float(v.abs().max()) == 0.0 for k, v in opt.state.items()
               if k.startswith("encoder.mu."))


def test_same_generator_seed_gives_the_same_step(variables):
    """With dropout on, a step is a function of the generator's seed."""
    losses = []
    for seed in (5, 5, 6):
        model = _port_model(p=0.2)
        load_flax_variables(model, variables["params"],
                            variables["batch_stats"])
        opt = build_train_optimizer(model, frozen=entity_table_names(model),
                                    **OPT)
        step = make_train_step(model, opt, device="cpu")
        gen = torch.Generator().manual_seed(seed)
        out = [float(step(_torch_batch(*_batch(1)), generator=gen)["loss"])
               for _ in range(2)]
        losses.append((out, to_flax_variables(model)[0]))
    assert losses[0][0] == losses[1][0]
    a, b = _flat(losses[0][1]), _flat(losses[1][1])
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert losses[0][0] != losses[2][0]
    assert losses[0][0][0] != losses[0][0][1]


def test_train_step_refuses_cpu_fallback(variables, monkeypatch):
    model = _port_model()
    opt = build_train_optimizer(model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(model, opt)
