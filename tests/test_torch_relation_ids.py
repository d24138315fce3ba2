"""Relation ids at or above n_rel in the port's edge encoder (CPU).

The JAX package builds an edge slot's feature row by a comparison with the
feature ids (`_feat_onehot`) on its kernel path and by `jax.nn.one_hot` on
its scatter path: a relation id outside [0, n_rel) sets no relation
feature, while its head and tail types and its count stand. The port
gives such a slot the same zero relation part on both of its branches. On
graphs whose relation ids run over 0-9 at n_rel = 8 (the JAX dress
rehearsal's synthetic case: 7 relations and the self loop):

  * `edge_feature_moments` equals the Pallas moments kernel exactly
    (integer counts), and so does the numpy mirror of the CUDA kernel's
    triple counts with its no-relation bucket;
  * `edge_hidden` and its gradients equal the Pallas hidden pass at
    tests/test_torch_edge_encoder.py's tolerances (f32: rtol/atol 2e-5,
    gradients with a floor of 2e-5 of their largest value; bf16: one bf16
    ulp of h, gradients within 1e-6 of their largest value);
  * QAGNNMessagePassing equals flax on the fused branch (against
    "pallas") and on the scatter branch (against "scatter"), eval and
    train mode, rtol/atol 2e-5 (the same f32 arithmetic in another order),
    and the two branches agree; the scatter branch no longer raises.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qagnn_tpu.models.gnn import QAGNNMessagePassing as JaxMP
from qagnn_tpu.ops.pallas_edge_encoder import (
    edge_feature_moments as jax_feature_moments,
    edge_hidden as jax_edge_hidden,
)
from test_torch_edge_encoder import _expand_triple_counts, _triple_counts

from qagnn_tpu_torch.models.gnn import QAGNNMessagePassing
from qagnn_tpu_torch.ops.edge_encoder_kernels import (
    edge_feature_moments,
    edge_hidden,
)
from qagnn_tpu_torch.utils.convert import (
    grads_to_flax,
    load_flax_variables,
)

N_REL, N_NTYPE, D = 8, 4, 16
F = N_REL + 2 * N_NTYPE
IDS = 10                    # relation ids 0-9: 8 and 9 lie past n_rel
TOL = dict(rtol=2e-5, atol=2e-5)
INTS = ("etype", "src", "dst", "ntype")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(seed, G=3, N=10, E=24):
    rng = np.random.default_rng(seed)
    g = dict(etype=rng.integers(0, IDS, (G, E)).astype(np.int32),
             src=rng.integers(0, N, (G, E)).astype(np.int32),
             dst=rng.integers(0, N, (G, E)).astype(np.int32),
             ntype=rng.integers(0, N_NTYPE, (G, N)).astype(np.int32),
             mask=rng.random((G, E)) > 0.25)
    assert (g["etype"][g["mask"]] >= N_REL).any()
    return g


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _params(seed):
    rng = np.random.default_rng(seed)
    w0 = rng.standard_normal((F, D)).astype(np.float32)
    return (w0, *(rng.standard_normal(D).astype(np.float32)
                  for _ in range(3)))


@pytest.mark.parametrize("E", [24, 13])
def test_feature_moments_match_pallas(E):
    g = _graph(0, E=E)
    keys = INTS + ("mask",)
    got = edge_feature_moments(*[_t(g[k]) for k in keys], N_REL, N_NTYPE)
    want = jax_feature_moments(*[jnp.asarray(g[k]) for k in keys], N_REL,
                               N_NTYPE, True)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    live = g["mask"].sum()
    assert float(got[2]) == live
    # the head and tail features of every live slot, its relation only in
    # range
    in_range = (g["etype"][g["mask"]] < N_REL).sum()
    assert float(got[0].sum()) == 2 * live + in_range


@pytest.mark.parametrize("n_rel, n_ntype, E", [(8, 4, 24), (39, 4, 13),
                                               (1, 7, 9)])
def test_triple_counts_with_the_no_relation_bucket_match_pallas(n_rel,
                                                                n_ntype, E):
    """The CUDA moments kernel's arithmetic (csrc/edge_moments.cu), ids
    from -1 to n_rel + 1: the no-relation bucket expands into the type
    entries and n, and into no relation entry."""
    rng = np.random.default_rng(n_rel + E)
    G, N = 3, 10
    g = dict(etype=rng.integers(-1, n_rel + 2, (G, E)).astype(np.int32),
             src=rng.integers(0, N, (G, E)).astype(np.int32),
             dst=rng.integers(0, N, (G, E)).astype(np.int32),
             ntype=rng.integers(0, n_ntype, (G, N)).astype(np.int32),
             mask=rng.random((G, E)) > 0.25)
    keys = INTS + ("mask",)
    want = jax_feature_moments(*[jnp.asarray(g[k]) for k in keys], n_rel,
                               n_ntype, True)
    got = _expand_triple_counts(_triple_counts(g, n_rel, n_ntype), n_rel,
                                n_ntype)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y))
    plain = edge_feature_moments(*[_t(g[k]) for k in keys], n_rel, n_ntype)
    for x, y in zip(plain, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E", [24, 13])
def test_edge_hidden_matches_pallas(E, dtype):
    g = _graph(1, E=E)
    params = _params(2)
    got = edge_hidden(*[_t(g[k]) for k in INTS], *map(_t, params), N_REL,
                      N_NTYPE, getattr(torch, dtype))
    want = jax_edge_hidden(*[jnp.asarray(g[k]) for k in INTS],
                           *map(jnp.asarray, params), N_REL, N_NTYPE,
                           getattr(jnp, dtype), True)
    want = np.swapaxes(np.asarray(want.astype(jnp.float32)), 1, 2)[:, :E]
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E", [24, 13])
def test_edge_hidden_gradients_match_pallas(E, dtype):
    g = _graph(3, E=E)
    params = _params(4)
    cot = np.random.default_rng(5).standard_normal(
        g["src"].shape + (D,)).astype(np.float32)
    cot = torch.from_numpy(cot).to(getattr(torch, dtype)).float().numpy()

    def jax_loss(w0, b0, a, b):
        h = jax_edge_hidden(*[jnp.asarray(g[k]) for k in INTS], w0, b0, a, b,
                            N_REL, N_NTYPE, getattr(jnp, dtype), True)
        return jnp.sum(h[:, :, :E].astype(jnp.float32)
                       * jnp.swapaxes(jnp.asarray(cot), 1, 2))

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, params))
    leaves = [_t(x).requires_grad_() for x in params]
    h = edge_hidden(*[_t(g[k]) for k in INTS], *leaves, N_REL, N_NTYPE,
                    getattr(torch, dtype))
    (h.float() * _t(cot)).sum().backward()
    for name, p, y in zip(("dW0", "db0", "da", "db"), leaves, want):
        y = np.asarray(y)
        if dtype == "float32":
            np.testing.assert_allclose(p.grad.numpy(), y, rtol=2e-5,
                                       atol=2e-5 * np.abs(y).max(),
                                       err_msg=name)
        else:
            err = np.abs(p.grad.numpy() - y).max()
            assert err <= 1e-6 * np.abs(y).max(), (name, err)
    # the out-of-range ids leave no mark on W0's relation rows beyond
    # their in-range neighbours': a relation no live or dead slot names
    # gets no gradient
    unused = sorted(set(range(N_REL)) - set(g["etype"].ravel()))
    for r in unused:
        assert not leaves[0].grad[r].any()


# --------------------------------------------------------------------------
# the message passing, both branches
# --------------------------------------------------------------------------

K, HEADS, N_ETYPE = 2, 4, N_REL - 1


def _case(seed, G=3, N=10, E=24):
    rng = np.random.default_rng(seed)
    mask = rng.random((G, E)) > 0.3
    args = (rng.standard_normal((G, N, D)).astype(np.float32),
            rng.integers(0, N_NTYPE, (G, N)).astype(np.int32),
            rng.standard_normal((G, N)).astype(np.float32),
            rng.integers(0, N, (G, E)).astype(np.int32),
            rng.integers(0, N, (G, E)).astype(np.int32),
            rng.integers(0, IDS, (G, E)).astype(np.int32), mask)
    assert (args[5][mask] > N_ETYPE).any()
    jmp = JaxMP(k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE, hidden_size=D,
                dropout=0.0, head_count=HEADS, backend="scatter")
    v = jax.tree.map(np.asarray, jmp.init(
        jax.random.PRNGKey(seed), *map(jnp.asarray, args), train=False))
    # weights and running statistics away from their initial values, so
    # that the edge features reach the output
    v["params"] = jax.tree.map(
        lambda x: (x + rng.standard_normal(x.shape) * 0.2).astype(np.float32),
        v["params"])
    v["batch_stats"] = jax.tree.map(
        lambda x: (rng.uniform(0.5, 2.0, x.shape) if np.all(x == 1)
                   else rng.standard_normal(x.shape) * 0.1)
        .astype(np.float32), v["batch_stats"])
    return args, v


def _jax_mp(backend):
    return JaxMP(k=K, n_ntype=N_NTYPE, n_etype=N_ETYPE, hidden_size=D,
                 dropout=0.0, head_count=HEADS, backend=backend)


def _port_mp(variables, backend):
    mp = QAGNNMessagePassing(K, N_NTYPE, N_ETYPE, D, dropout=0.0,
                             head_count=HEADS, backend=backend)
    load_flax_variables(mp, variables["params"], variables["batch_stats"])
    return mp


BRANCHES = [("cuda", "pallas"), ("scatter", "scatter")]


@pytest.mark.parametrize("backends", BRANCHES, ids=["fused", "scatter"])
def test_message_passing_eval_matches_flax(backends):
    args, variables = _case(6)
    want = _jax_mp(backends[1]).apply(variables, *map(jnp.asarray, args),
                                      train=False)
    with torch.no_grad():
        got = _port_mp(variables, backends[0]).eval()(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("backends", BRANCHES, ids=["fused", "scatter"])
def test_message_passing_train_matches_flax(backends):
    """Train mode (batch statistics: the fused branch's closed-form edge
    moments take the out-of-range slots' type features and count), the
    output and every parameter gradient of sum(out * cot)."""
    args, variables = _case(7)
    cot = np.random.default_rng(8).standard_normal(args[0].shape) \
        .astype(np.float32)
    jmp = _jax_mp(backends[1])

    def loss(params):
        out, _ = jmp.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *map(jnp.asarray, args), train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), out

    (_, want), want_grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    mp = _port_mp(variables, backends[0]).train()
    got = mp(*map(_t, args))
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in p):  # noqa
                      np.asarray(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    got_g, want_g = flat(grads_to_flax(mp)), flat(want_grads)
    assert sorted(got_g) == sorted(want_g)
    top = max(float(np.abs(w).max()) for w in want_g.values())
    for name, w in want_g.items():
        np.testing.assert_allclose(got_g[name], w, rtol=2e-5,
                                   atol=2e-5 * top, err_msg=name)


def test_fused_and_scatter_branches_agree():
    args, variables = _case(9)
    with torch.no_grad():
        fused = _port_mp(variables, "cuda").eval()(*map(_t, args))
        scatter = _port_mp(variables, "scatter").eval()(*map(_t, args))
    np.testing.assert_allclose(fused.numpy(), scatter.numpy(), **TOL)
