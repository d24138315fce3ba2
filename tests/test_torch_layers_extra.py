"""The rest of the JAX package's model and op library in the port (ROADMAP
A6), each against its JAX counterpart on the same seeded inputs.

Mirrors tests/test_layers_extra.py (but its test against the reference
implementation's own MLP, whose source the repository does not hold),
tests/test_graph_container.py::test_flat_views_offset, tests/test_maths.py
and tests/test_segment_ops.py's softmax cases: BatchedGraphs' flat views,
segment_softmax, normalize_sparse_adj, TypedLinear,
TypedMultiheadAttPoolLayer, BilinearAttentionLayer, diff_topk,
matrix_attention and TripleEncoder, weights carried across by
utils/convert.py (the GRUs' gates by hand). f32 on the CPU: rtol 1e-5 /
atol 1e-6 where the two compute the same sums, 1e-4 through the GRUs'
three steps. And the port's package exports name what the JAX package's
do, but for the TPU's forms that have no counterpart.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

from qagnn_tpu.graph.batching import batch_edge_lists as jax_batch
from qagnn_tpu.models import layers as jl
from qagnn_tpu.ops.segment import segment_softmax as jax_segment_softmax
from qagnn_tpu.utils.maths import normalize_sparse_adj as jax_normalize

from qagnn_tpu_torch.graph.batching import batch_edge_lists
from qagnn_tpu_torch.models import layers
from qagnn_tpu_torch.ops.segment import segment_softmax
from qagnn_tpu_torch.utils.convert import load_flax_variables
from qagnn_tpu_torch.utils.maths import normalize_sparse_adj

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _params(tree):
    return jax.tree.map(np.asarray, tree["params"])


def _graph_args(seed=0, n_graphs=3, n_nodes=8):
    rng = np.random.default_rng(seed)
    edge_indices, edge_types = [], []
    for _ in range(n_graphs):
        e = rng.integers(2, 12)
        edge_indices.append(rng.integers(0, n_nodes, size=(2, e)))
        edge_types.append(rng.integers(0, 5, size=e))
    return (edge_indices, edge_types,
            rng.integers(0, 100, size=(n_graphs, n_nodes)),
            rng.integers(0, 4, size=(n_graphs, n_nodes)),
            rng.normal(size=(n_graphs, n_nodes)),
            rng.integers(2, n_nodes + 1, size=n_graphs))


def test_flat_views_match_jax():
    args = _graph_args()
    g, j = batch_edge_lists(*args), jax_batch(*args)
    assert (g.n_graphs, g.edges_per_graph, g.total_nodes) == \
        (j.n_graphs, j.edges_per_graph, j.total_nodes)
    for name in ("flat_edge_src", "flat_edge_dst", "flat_edge_type",
                 "flat_edge_mask"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    assert int(g.real_edge_count()) == int(j.real_edge_count())
    flat = g.flat_edge_src.numpy().reshape(g.n_graphs, g.edges_per_graph)
    for i in range(g.n_graphs):
        np.testing.assert_array_equal(
            flat[i], g.edge_src[i].numpy() + i * g.nodes_per_graph)


@pytest.mark.parametrize("case", ["random", "dense", "large_scores"])
def test_segment_softmax_matches_jax(case):
    rng = np.random.default_rng(3)
    if case == "dense":
        seg, scores = np.zeros(3, np.int32), np.array([[1.0], [2.0], [3.0]])
        mask, n = np.ones(3, bool), 1
    elif case == "large_scores":
        seg, scores = np.zeros(2, np.int32), np.array([[1000.0], [1001.0]])
        mask, n = np.ones(2, bool), 1
    else:
        seg = rng.integers(0, 4, size=16).astype(np.int32)
        scores = rng.normal(size=(16, 2))
        mask, n = np.arange(16) < 12, 4
    scores = scores.astype(np.float32)
    x = _t(scores).requires_grad_()
    got = segment_softmax(x, _t(seg), n, _t(mask))
    want = jax_segment_softmax(jnp.asarray(scores), jnp.asarray(seg), n,
                               jnp.asarray(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert np.all(got.detach().numpy()[~mask] == 0)
    cot = rng.normal(size=scores.shape).astype(np.float32)
    (got * _t(cot)).sum().backward()
    jgrad = jax.grad(lambda s: jnp.sum(jax_segment_softmax(
        s, jnp.asarray(seg), n, jnp.asarray(mask)) * cot))(
        jnp.asarray(scores))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), **TOL)


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_normalize_sparse_adj_matches_jax(fmt):
    rng = np.random.default_rng(0)
    dense = (rng.random((7, 5)) < 0.4) * rng.random((7, 5))
    dense[2, :] = 0.0          # zero-degree row: divides by 1e-5, not 0
    A = sparse.csr_matrix(dense)
    got, want = normalize_sparse_adj(A, fmt), jax_normalize(A, fmt)
    assert got.format == want.format == fmt
    np.testing.assert_array_equal(got.toarray(), want.toarray())


def test_typed_linear_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    tid = np.array([0, 1, 2, 1, 0])
    jmod = jl.TypedLinear(in_features=6, out_features=4, n_type=3)
    p = _params(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(tid)))
    mod = layers.TypedLinear(6, 4, 3)
    load_flax_variables(mod, p)
    for ids in (tid, None):
        want = jmod.apply({"params": p}, jnp.asarray(x),
                          None if ids is None else jnp.asarray(ids))
        got = mod(_t(x), None if ids is None else _t(ids))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


def test_typed_multihead_att_pool_matches_flax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 12)).astype(np.float32)
    k = rng.standard_normal((3, 6, 8)).astype(np.float32)
    tid = rng.integers(0, 3, (3, 6))
    mask = np.zeros((3, 6), bool)
    mask[:, 4:] = True
    jmod = jl.TypedMultiheadAttPoolLayer(n_head=2, d_q_original=12,
                                         d_k_original=8, n_type=3)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(mask),
             jnp.asarray(tid))
    p = _params(jmod.init(jax.random.PRNGKey(0), *jargs))
    mod = layers.TypedMultiheadAttPoolLayer(2, 12, 8, n_type=3).eval()
    load_flax_variables(mod, p)
    want, want_attn = jmod.apply({"params": p}, *jargs)
    got, attn = mod(_t(q), _t(k), _t(mask), _t(tid))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(want_attn),
                               **TOL)
    assert float(attn.detach().reshape(2, 3, 6)[:, :, 4:].sum()) == 0.0


def test_bilinear_attention_matches_flax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((4, 10)).astype(np.float32)
    v = rng.standard_normal((4, 5, 7)).astype(np.float32)
    m = (rng.random((4, 5)) > 0.3).astype(np.float32)
    jmod = jl.BilinearAttentionLayer(query_dim=10, value_dim=7)
    jargs = (jnp.asarray(q), jnp.asarray(v), jnp.asarray(m))
    p = _params(jmod.init(jax.random.PRNGKey(0), *jargs))
    mod = layers.BilinearAttentionLayer(10, 7)
    load_flax_variables(mod, p)
    want, want_attn = jmod.apply({"params": p}, *jargs)
    got, attn = mod(_t(q), _t(v), _t(m))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(want_attn),
                               **TOL)
    # the gradient flows through the mask's renormalization, finite
    (got ** 2).sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in mod.parameters())
    jgrad = jax.grad(lambda p: jnp.sum(jmod.apply({"params": p}, *jargs)[0]
                                       ** 2))(p)
    np.testing.assert_allclose(mod.linear.weight.grad.numpy().T,
                               np.asarray(jgrad["linear"]["kernel"]),
                               rtol=1e-4, atol=1e-5)


def test_diff_topk_matches_jax():
    """reference utils/layers.py:621-628: the mask forward, the
    straight-through backward."""
    x = np.array([[3.0, 1.0, 2.0], [0.5, 9.0, -1.0]], np.float32)
    xt = _t(x).requires_grad_()
    mask = layers.diff_topk(xt, 2)
    np.testing.assert_array_equal(mask.detach().numpy(),
                                  np.asarray(jl.diff_topk(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(mask.detach().numpy(),
                                  [[1, 0, 1], [1, 1, 0]])
    (mask * 2).sum().backward()
    jgrad = jax.grad(lambda x: jnp.sum(jl.diff_topk(x, 2) * 2))(
        jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgrad))


@pytest.mark.parametrize("scale", [False, True])
def test_matrix_attention_matches_jax(scale):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, 5, 4)).astype(np.float32)
    got = layers.matrix_attention(
        _t(a), _t(b), lambda x, y: layers.dot_product_similarity(x, y, scale))
    want = jl.matrix_attention(
        jnp.asarray(a), jnp.asarray(b),
        lambda x, y: jl.dot_product_similarity(x, y, scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _gru_from_flax(gru: torch.nn.GRU, cell: dict) -> None:
    """torch's GRU (gates r, z, n) from a flax GRUCell: input biases ir, iz,
    in; hidden kernels hr, hz (no bias), hn with its bias."""
    cat = lambda names, what: np.concatenate(  # noqa: E731
        [np.asarray(cell[n][what]).T for n in names])
    with torch.no_grad():
        gru.weight_ih_l0.copy_(_t(cat(("ir", "iz", "in"), "kernel")))
        gru.weight_hh_l0.copy_(_t(cat(("hr", "hz", "hn"), "kernel")))
        gru.bias_ih_l0.copy_(_t(np.concatenate(
            [cell[n]["bias"] for n in ("ir", "iz", "in")])))
        h = cell["hn"]["bias"].shape[0]
        gru.bias_hh_l0.copy_(_t(np.concatenate(
            [np.zeros(2 * h, np.float32), cell["hn"]["bias"]])))


@pytest.mark.parametrize("bidirectional", [True, False])
def test_triple_encoder_matches_flax(bidirectional):
    rng = np.random.default_rng(4)
    h, r, t = (rng.standard_normal((5, 8)).astype(np.float32)
               for _ in range(3))
    jmod = jl.TripleEncoder(emb_dim=8, hidden_dim=12,
                            bidirectional=bidirectional)
    jargs = tuple(jnp.asarray(x) for x in (h, r, t))
    p = _params(jmod.init(jax.random.PRNGKey(0), *jargs))
    mod = layers.TripleEncoder(8, 12, bidirectional=bidirectional).eval()
    _gru_from_flax(mod.gru_fwd, p["GRUCell_0"])
    if bidirectional:
        _gru_from_flax(mod.gru_bwd, p["GRUCell_1"])
    want = jmod.apply({"params": p}, *jargs)
    got = mod(_t(h), _t(r), _t(t))
    assert got.shape == (5, 12)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)


# the JAX package's exports that are the TPU's forms or optax's: the
# one-hot aggregation (ROADMAP), flax's TrainState and its init, the optax
# optimizer builders, and the sharding objects of a JAX mesh
NOT_PORTED = {"aggregate_onehot", "TrainState", "init_train_state",
              "make_optimizer", "radam", "scale_by_radam_ref",
              "batch_sharding", "replicated", "param_shardings"}


@pytest.mark.parametrize("package", ["models", "train", "ops", "data",
                                     "graph", "parallel"])
def test_package_exports_match_jax(package):
    want = set(importlib.import_module(f"qagnn_tpu.{package}").__all__)
    port = importlib.import_module(f"qagnn_tpu_torch.{package}")
    assert want - NOT_PORTED <= set(port.__all__), \
        sorted(want - NOT_PORTED - set(port.__all__))
    for name in port.__all__:
        assert getattr(port, name) is not None, name
