"""The port's LMQAGNN against flax, eval logits and train mode (CPU, f32).

A tiny RoBERTa-style encoder and a k=2 decoder; the flax variables are
carried across by convert.py (strict) with perturbed BatchNorm running
statistics, and the port is driven through its serving entry points
`make_eval_step(device="cpu")` and `make_detail_step(device="cpu")` (logits,
pooler attention, per-layer edge and self-loop attention weights).
Tolerance rtol 3e-4 / atol 3e-5, as tests/test_torch_oracle.py holds the
decoder.

Train mode, dropout 0 on both sides: the logits, the updated running
statistics and every parameter gradient of the cross-entropy loss, at rtol
1e-3 with an absolute floor of 1e-4 of the leaf's largest value or 1e-6 of
the tree's. The flax pooler's dropout rate (0.1) is not a constructor
argument of the flax model, so flax's Dropout is patched to the identity
for that test.
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

from qagnn_tpu_torch.graph.container import BatchedGraphs
from qagnn_tpu_torch.models.qagnn import LMQAGNN
from qagnn_tpu_torch.models.text_encoder import TextEncoder, TextEncoderConfig
from qagnn_tpu_torch.train.step import (
    accuracy,
    make_detail_step,
    make_eval_step,
)
from qagnn_tpu_torch.train.losses import cross_entropy_loss
from qagnn_tpu_torch.utils.convert import (
    grads_to_flax,
    load_flax_variables,
    to_flax_variables,
)

B, C, L, N, E = 2, 2, 12, 10, 20
G = B * C
K, D, N_NTYPE, N_ETYPE, N_CONCEPT, CIN, FC = 2, 16, 4, 7, 40, 24, 8
ENC = dict(hidden_dropout=0.0, attention_dropout=0.0, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
           max_position_embeddings=L + 4, type_vocab_size=1,
           layer_norm_eps=1e-5, pad_token_id=1, roberta_style_positions=True)
TOL = dict(rtol=3e-4, atol=3e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the machine's cores: one intra-op thread keeps
    this file's torch ops from crowding out the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 128, (B, C, L)).astype(np.int32)
    am = np.ones((B, C, L), np.int32)
    ids[:, :, -3:] = 1                 # padding tokens
    am[:, :, -3:] = 0
    num_nodes = rng.integers(4, N + 1, G).astype(np.int32)
    concept_ids = rng.integers(1, N_CONCEPT, (G, N)).astype(np.int32)
    concept_ids[:, 0] = 0
    node_types = rng.integers(0, 3, (G, N)).astype(np.int32)
    node_types[:, 0] = 3
    mask = rng.random((G, E)) > 0.3
    mask[1] = False                    # a graph with every edge masked
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
    return {"input_ids": ids, "attention_mask": am}, graph


def _jax_model(backend):
    return JaxLMQAGNN(
        encoder=JaxTextEncoder(JaxTextEncoderConfig.tiny(**ENC)),
        sent_dim=ENC["hidden_size"], k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE,
        n_concept=N_CONCEPT, concept_dim=D, concept_in_dim=CIN,
        n_attention_head=2, fc_dim=FC, n_fc_layer=1, p_emb=0.0, p_gnn=0.0,
        p_fc=0.0, gnn_backend=backend)


def _port_model(backend):
    return LMQAGNN(
        TextEncoder(TextEncoderConfig.tiny(**ENC)),
        sent_dim=ENC["hidden_size"], k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE,
        n_concept=N_CONCEPT, concept_dim=D, concept_in_dim=CIN,
        n_attention_head=2, fc_dim=FC, n_fc_layer=1, p_emb=0.0, p_gnn=0.0,
        p_fc=0.0, gnn_backend=backend)


@pytest.fixture(scope="module")
def setup():
    lm, graph = _batch(0)
    jlm = {k: jnp.asarray(v) for k, v in lm.items()}
    jgraph = JaxGraphs(**{k: jnp.asarray(v) for k, v in graph.items()})
    v = _jax_model("scatter").init(jax.random.PRNGKey(0), jlm, jgraph)
    rng = np.random.default_rng(1)
    stats = jax.tree.map(
        lambda x: (rng.uniform(0.5, 2.0, x.shape) if np.all(np.asarray(x) == 1)
                   else rng.standard_normal(x.shape) * 0.1).astype(np.float32),
        jax.tree.map(np.asarray, v["batch_stats"]))
    variables = {"params": jax.tree.map(np.asarray, v["params"]),
                 "batch_stats": stats}
    return lm, graph, jlm, jgraph, variables


@pytest.mark.parametrize("backends", [("cuda", "pallas"),
                                      ("scatter", "scatter")])
def test_lmqagnn_eval_logits_match_flax(setup, backends):
    lm, graph, jlm, jgraph, variables = setup
    port_backend, jax_backend = backends
    want = _jax_model(jax_backend).apply(variables, jlm, jgraph, train=False)

    model = _port_model(port_backend)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    step = make_eval_step(model, device="cpu")
    got = step({k: torch.from_numpy(v) for k, v in lm.items()},
               BatchedGraphs(**{k: torch.from_numpy(v)
                                for k, v in graph.items()}))
    assert got.shape == (B, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    labels = torch.tensor([0, 1])
    assert float(accuracy(got, labels)) == float(
        np.mean(np.argmax(np.asarray(want), 1) == labels.numpy()))


def _port_inputs(lm, graph):
    return ({k: torch.from_numpy(v) for k, v in lm.items()},
            BatchedGraphs(**{k: torch.from_numpy(v)
                             for k, v in graph.items()}))


@pytest.mark.parametrize("backends", [("cuda", "pallas"), (None, "scatter"),
                                      ("scatter", "scatter")])
def test_detail_step_matches_flax(setup, backends):
    """Logits, pooler attention and the GNN's attention weights. Whatever
    backend the model names, the weights come from the scatter arm (the JAX
    model leaves its kernels for the one-hot backend there)."""
    lm, graph, jlm, jgraph, variables = setup
    port_backend, jax_backend = backends
    want, want_pool, (want_edge, want_self) = _jax_model(jax_backend).apply(
        variables, jlm, jgraph, train=False, detail=True)

    model = _port_model(port_backend)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    logits, pool, (edge, self_) = make_detail_step(model, device="cpu")(
        *_port_inputs(lm, graph))
    assert logits.shape == (B, C) and pool.shape == (2 * G, N)
    assert edge.shape == (K, G, E, 4) and self_.shape == (K, G, N, 4)
    for got, ref in ((logits, want), (pool, want_pool), (edge, want_edge),
                     (self_, want_self)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the detail step's logits are the eval step's
    served = make_eval_step(model, device="cpu")(*_port_inputs(lm, graph))
    np.testing.assert_allclose(logits.numpy(), served.numpy(), **TOL)
    np.testing.assert_allclose(pool.sum(1).numpy(), 1.0, rtol=1e-5)
    assert (edge[:, ~torch.from_numpy(graph["edge_mask"])] == 0).all()


def test_return_pool_attn_alone(setup):
    lm, graph, jlm, jgraph, variables = setup
    want, want_pool = _jax_model("scatter").apply(
        variables, jlm, jgraph, train=False, return_pool_attn=True)
    model = _port_model("scatter").eval()
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        out = model(*_port_inputs(lm, graph), return_pool_attn=True)
    assert len(out) == 2
    np.testing.assert_allclose(out[0].numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(want_pool), **TOL)


def test_convert_is_strict(setup):
    _, _, _, _, variables = setup
    model = _port_model("scatter")
    params = dict(variables["params"])
    params["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="not used"):
        load_flax_variables(model, params, variables["batch_stats"])
    params = {k: v for k, v in variables["params"].items() if k != "encoder"}
    with pytest.raises(KeyError):
        load_flax_variables(model, params, variables["batch_stats"])


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(got, want, what):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want), what
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(
            got[name], w, rtol=1e-3,
            atol=max(1e-4 * float(np.abs(w).max()), 1e-6 * top),
            err_msg=f"{what}: {name}")


@pytest.mark.parametrize("backends", [("cuda", "pallas"),
                                      ("scatter", "scatter")])
def test_lmqagnn_train_gradients_match_flax(setup, backends, monkeypatch):
    from qagnn_tpu.train.losses import cross_entropy_loss as jax_ce

    lm, graph, jlm, jgraph, variables = setup
    port_backend, jax_backend = backends
    labels = np.array([1, 0], np.int32)
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    jmodel = _jax_model(jax_backend)

    def loss(params):
        logits, new = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jlm, jgraph, train=True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(labels)), (logits,
                                                     new["batch_stats"])

    (_, (want, want_stats)), want_grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(variables["params"])

    model = _port_model(port_backend).train()
    model.decoder.pooler.dropout = 0.0
    model.decoder.pooler.attention.attn_dropout = 0.0
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    got = model({k: torch.from_numpy(v) for k, v in lm.items()},
                BatchedGraphs(**{k: torch.from_numpy(v)
                                 for k, v in graph.items()}))
    cross_entropy_loss(got, torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    _assert_trees_close(to_flax_variables(model)[1], want_stats,
                        "running statistics")
    _assert_trees_close(grads_to_flax(model), want_grads, "gradients")
