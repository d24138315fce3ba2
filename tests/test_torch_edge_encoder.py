"""The port's edge encoder against the JAX package (CPU, f32).

`edge_hidden` (the CUDA kernel's plain version on CPU tensors) against the
Pallas `edge_hidden` in interpret mode, and `EdgeEncoder` in eval mode with
non-trivial running statistics on both branches. Tolerance rtol/atol 2e-5:
the same f32 arithmetic summed in another order. `edge_feature_moments`
against the Pallas moments kernel exactly (integer counts), and
`edge_hidden`'s gradients in W0, b0, a, b against `jax.grad` over every slot,
masked ones included, at rtol 2e-5 with an absolute floor of 2e-5 of the
gradient's largest value.

The same two comparisons in bfloat16, where the plain version rounds where
`_hidden_fwd_kernel` / `_hidden_bwd_kernel` round (the W0 rows, h, d_x0
before it enters dW0): h within one bf16 ulp (2^-7 relative; the f32 sums
before the rounding agree to a few f32 ulps), the gradients within 1e-6 of
their largest value (f32 sums of the same terms in another order). Then the
Python the card's two routes share with the CPU: which route a dtype and
width take, what is refused, and how many rows of partial sums the
backward's scratch holds.

The moments kernel counts (relation, head type, tail type) triples and
expands the counts into (hist, M, n): a numpy mirror of that arithmetic is
held against the Pallas moments kernel exactly, for the CSQA / OBQA and
MedQA relations and for 7 node types, with the kernel's block count and
shared memory beside it.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qagnn_tpu.models.gnn import EdgeEncoder as JaxEdgeEncoder
from qagnn_tpu.ops.pallas_edge_encoder import (
    analytic_edge_moments as jax_moments,
    edge_feature_moments as jax_feature_moments,
    edge_hidden as jax_edge_hidden,
)

from qagnn_tpu_torch.models.gnn import EdgeEncoder
from qagnn_tpu_torch.ops import edge_encoder_kernels as ek
from qagnn_tpu_torch.ops.edge_encoder_kernels import (
    analytic_edge_moments,
    edge_feature_moments,
    edge_hidden,
)
from qagnn_tpu_torch.utils.convert import load_flax_variables

N_REL, N_NTYPE, D = 8, 4, 16
F = N_REL + 2 * N_NTYPE
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the machine's cores: one intra-op thread keeps
    this file's torch ops from crowding out the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(seed, G=3, N=10, E=24):
    rng = np.random.default_rng(seed)
    return dict(
        etype=rng.integers(0, N_REL - 1, (G, E)).astype(np.int32),
        src=rng.integers(0, N, (G, E)).astype(np.int32),
        dst=rng.integers(0, N, (G, E)).astype(np.int32),
        ntype=rng.integers(0, N_NTYPE, (G, N)).astype(np.int32),
        mask=rng.random((G, E)) > 0.25)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("E", [24, 13])
def test_edge_hidden_matches_pallas(E):
    g = _graph(0, E=E)
    rng = np.random.default_rng(1)
    w0 = rng.standard_normal((F, D)).astype(np.float32)
    b0, a, b = (rng.standard_normal(D).astype(np.float32) for _ in range(3))
    got = edge_hidden(_t(g["etype"]), _t(g["src"]), _t(g["dst"]),
                      _t(g["ntype"]), _t(w0), _t(b0), _t(a), _t(b),
                      N_REL, N_NTYPE, torch.float32)
    want = jax_edge_hidden(
        jnp.asarray(g["etype"]), jnp.asarray(g["src"]), jnp.asarray(g["dst"]),
        jnp.asarray(g["ntype"]), jnp.asarray(w0), jnp.asarray(b0),
        jnp.asarray(a), jnp.asarray(b), N_REL, N_NTYPE, jnp.float32, True)
    want = np.swapaxes(np.asarray(want), 1, 2)[:, :E]     # (G, E, D)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("E", [24, 13])
def test_edge_feature_moments_match_pallas(E):
    g = _graph(5, E=E)
    g["mask"][1] = False                       # a graph with no masked slot
    keys = ("etype", "src", "dst", "ntype", "mask")
    got = edge_feature_moments(*[_t(g[k]) for k in keys], N_REL, N_NTYPE)
    want = jax_feature_moments(*[jnp.asarray(g[k]) for k in keys], N_REL,
                               N_NTYPE, True)
    for x, y in zip(got, want):
        assert x.dtype == torch.float32
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert float(got[2]) == g["mask"].sum()
    assert float(got[0].sum()) == 3 * g["mask"].sum()
    assert float(got[1].sum()) == 9 * g["mask"].sum()


def _triple_counts(g, n_rel, n_ntype):
    """C[r, a, b]: the masked slots of each (relation, head type, tail
    type) triple, what the moments kernel's blocks count."""
    head = np.take_along_axis(g["ntype"], g["src"], 1)
    tail = np.take_along_axis(g["ntype"], g["dst"], 1)
    key = (g["etype"] * n_ntype + head) * n_ntype + tail
    return np.bincount(key[g["mask"]], minlength=n_rel * n_ntype ** 2) \
        .reshape(n_rel, n_ntype, n_ntype)


def _expand_triple_counts(C, n_rel, n_ntype):
    """hist, M, n from the triple counts as the moments kernel's last block
    expands them (csrc/edge_moments.cu): the three two-way tables RA = sum
    over tail types, RB = sum over head types, AB = sum over relations; the
    histogram from them; M's diagonal blocks diag(hist), its off-diagonal
    blocks the tables; n the sum over relations of the histogram."""
    nt, F = n_ntype, n_rel + 2 * n_ntype
    RA, RB, AB = C.sum(2), C.sum(1), C.sum(0)
    hist = np.concatenate([RA.sum(1), AB.sum(1), AB.sum(0)])
    M = np.diag(hist)
    rel, head, tail = slice(0, n_rel), slice(n_rel, n_rel + nt), \
        slice(n_rel + nt, F)
    M[rel, head], M[rel, tail], M[head, tail] = RA, RB, AB
    M[head, rel], M[tail, rel], M[tail, head] = RA.T, RB.T, AB.T
    return hist, M, hist[:n_rel].sum()


@pytest.mark.parametrize("n_rel, n_ntype, E", [
    (39, 4, 24),          # CSQA / OBQA: 38 relations and the self loop
    (35, 4, 13),          # MedQA: 34 relations and the self loop, ragged E
    (1, 7, 13),
    (38, 4, 24),          # the relations without the self loop
    (39, 4, 1),           # one slot a graph
    (2, 1, 9),            # one node type: head and tail features coincide
    (12, 5, 7),
    (4, 9, 31),           # more node types than relations
])
def test_triple_count_expansion_matches_pallas(n_rel, n_ntype, E):
    """The moments kernel's arithmetic, counting triples and expanding
    them, equals the Pallas moments kernel exactly."""
    rng = np.random.default_rng(n_rel * 100 + E)
    G, N = 3, 10
    g = dict(etype=rng.integers(0, n_rel, (G, E)).astype(np.int32),
             src=rng.integers(0, N, (G, E)).astype(np.int32),
             dst=rng.integers(0, N, (G, E)).astype(np.int32),
             ntype=rng.integers(0, n_ntype, (G, N)).astype(np.int32),
             mask=rng.random((G, E)) > 0.25)
    g["mask"][1] = False                       # a graph with no masked slot
    keys = ("etype", "src", "dst", "ntype", "mask")
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


def test_moments_shared_memory_takes_every_width_the_old_kernel_took():
    """The counting kernel that the triple counts replaced took F + F^2 + 1
    int32 counters in 48 KB of shared memory (F <= 110); every (n_rel,
    n_ntype) with such an F fits the triple counts and tables in a block."""
    assert ek._moments_smem(39, 4) == 4 * (624 + 2 * 156 + 16)
    for n_ntype in range(1, 55):
        for n_rel in range(1, 111 - 2 * n_ntype):
            assert ek._moments_smem(n_rel, n_ntype) <= ek.MOMENTS_MAX_SMEM


@pytest.mark.parametrize("E", [24, 13])
def test_edge_hidden_gradients_match_pallas(E):
    g = _graph(6, E=E)
    rng = np.random.default_rng(7)
    w0 = rng.standard_normal((F, D)).astype(np.float32)
    b0, a, b = (rng.standard_normal(D).astype(np.float32) for _ in range(3))
    cot = rng.standard_normal(g["src"].shape + (D,)).astype(np.float32)
    ints = ("etype", "src", "dst", "ntype")

    def jax_loss(w0, b0, a, b):
        h = jax_edge_hidden(*[jnp.asarray(g[k]) for k in ints], w0, b0, a, b,
                            N_REL, N_NTYPE, jnp.float32, True)   # (G, D, E')
        return jnp.sum(h[:, :, :E] * jnp.swapaxes(jnp.asarray(cot), 1, 2))

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(x) for x in (w0, b0, a, b)])
    params = [_t(x).requires_grad_() for x in (w0, b0, a, b)]
    h = edge_hidden(*[_t(g[k]) for k in ints], *params, N_REL, N_NTYPE,
                    torch.float32)
    (h * _t(cot)).sum().backward()
    for p, y in zip(params, want):
        y = np.asarray(y)
        np.testing.assert_allclose(p.grad.numpy(), y, rtol=2e-5,
                                   atol=2e-5 * np.abs(y).max())


def _bf16(x):
    """x rounded to bfloat16, as f32 numpy."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("E", [24, 13])
def test_edge_hidden_bf16_matches_pallas(E):
    g = _graph(8, E=E)
    rng = np.random.default_rng(9)
    w0 = rng.standard_normal((F, D)).astype(np.float32)
    b0, a, b = (rng.standard_normal(D).astype(np.float32) for _ in range(3))
    ints = ("etype", "src", "dst", "ntype")
    got = edge_hidden(*[_t(g[k]) for k in ints], _t(w0), _t(b0), _t(a),
                      _t(b), N_REL, N_NTYPE, torch.bfloat16)
    want = jax_edge_hidden(*[jnp.asarray(g[k]) for k in ints],
                           *[jnp.asarray(x) for x in (w0, b0, a, b)], N_REL,
                           N_NTYPE, jnp.bfloat16, True)
    want = np.swapaxes(np.asarray(want.astype(jnp.float32)), 1, 2)[:, :E]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=0)


@pytest.mark.parametrize("E", [24, 13])
def test_edge_hidden_bf16_gradients_match_pallas(E):
    g = _graph(10, E=E)
    rng = np.random.default_rng(11)
    w0 = rng.standard_normal((F, D)).astype(np.float32)
    b0, a, b = (rng.standard_normal(D).astype(np.float32) for _ in range(3))
    cot = _bf16(rng.standard_normal(g["src"].shape + (D,)).astype(np.float32))
    ints = ("etype", "src", "dst", "ntype")

    def jax_loss(w0, b0, a, b):
        h = jax_edge_hidden(*[jnp.asarray(g[k]) for k in ints], w0, b0, a, b,
                            N_REL, N_NTYPE, jnp.bfloat16, True)  # (G, D, E')
        return jnp.sum(h[:, :, :E].astype(jnp.float32)
                       * jnp.swapaxes(jnp.asarray(cot), 1, 2))

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(x) for x in (w0, b0, a, b)])
    params = [_t(x).requires_grad_() for x in (w0, b0, a, b)]
    h = edge_hidden(*[_t(g[k]) for k in ints], *params, N_REL, N_NTYPE,
                    torch.bfloat16)
    (h.float() * _t(cot)).sum().backward()
    for name, p, y in zip(("dW0", "db0", "da", "db"), params, want):
        y = np.asarray(y)
        err = np.abs(p.grad.numpy() - y).max()
        assert err <= 1e-6 * np.abs(y).max(), (name, err, np.abs(y).max())


@pytest.mark.parametrize("dtype, D, n_rel, n_ntype, route", [
    (torch.bfloat16, 200, 39, 4, 1),      # CSQA / OBQA: F = 47
    (torch.bfloat16, 200, 35, 4, 1),      # MedQA: F = 43
    (torch.bfloat16, 256, 56, 4, 1),      # the widest route 1 takes
    (torch.bfloat16, 24, 8, 4, 1),        # padded to 32 columns
    (torch.float32, 200, 39, 4, 0),       # f32: the CUDA-core kernels
    (torch.bfloat16, 100, 39, 4, 0),      # the default gnn_dim: D % 8 != 0
    (torch.bfloat16, 264, 39, 4, 0),
    (torch.bfloat16, 200, 57, 4, 0),      # F = 65
    (torch.bfloat16, 200, 33, 7, 0),      # a type table of 9800 floats
])
def test_hidden_route_by_dtype_and_width(dtype, D, n_rel, n_ntype, route):
    assert ek._hidden_route(dtype, D, n_rel, n_ntype) == route
    assert ek._hidden_route(dtype, D, n_rel, n_ntype, 0) == 0


@pytest.mark.parametrize("dtype, D, n_rel, n_ntype, route", [
    (torch.float32, 200, 39, 4, 1),
    (torch.bfloat16, 100, 39, 4, 1),
    (torch.bfloat16, 200, 57, 4, 1),
    (torch.bfloat16, 200, 39, 4, 2),
])
def test_hidden_route_refuses(dtype, D, n_rel, n_ntype, route):
    with pytest.raises(ValueError, match="no route"):
        ek._hidden_route(dtype, D, n_rel, n_ntype, route)


@pytest.mark.parametrize("route, n_edges, scratch", [
    (1, 64 * 4096, 3 * 64 * 4096),
    (1, 64 * 4093, 3 * 16 * 16372),       # whole tiles
    (0, 64 * 4096, 0),
])
def test_hidden_backward_rows_scratch(route, n_edges, scratch):
    """The backward's packed rows and one-hot masks: 3 int32 a slot."""
    assert ek._bwd_rows_scratch(route, n_edges) == scratch


def test_hidden_route_1_refuses_unaligned_rows():
    t = torch.zeros(12)
    ek._check_aligned(1, t, t[4:])
    ek._check_aligned(0, t[1:])
    with pytest.raises(ValueError, match="16-byte"):
        ek._check_aligned(1, t, t[1:])


@pytest.mark.parametrize("route, n_edges, n_sm, rows", [
    (1, 64 * 4096, 132, 132),     # the main path: one block an SM
    (1, 64 * 4093, 132, 132),
    (1, 40, 132, 3),              # 3 tiles, one a block
    (1, 16, 132, 1),
    (0, 64 * 4096, 132, ek.BWD_BLOCKS),
    (0, 100, 132, 2),
])
def test_hidden_backward_partial_rows(route, n_edges, n_sm, rows):
    """One (F + 3, D) row of partial sums for every block."""
    assert ek._bwd_blocks(route, n_edges, n_sm) == rows


def test_analytic_moments_match_jax():
    rng = np.random.default_rng(2)
    w0 = rng.standard_normal((F, D)).astype(np.float32)
    b0 = rng.standard_normal(D).astype(np.float32)
    hist = rng.integers(0, 9, F).astype(np.float32)
    M = rng.integers(0, 5, (F, F)).astype(np.float32)
    n = np.float32(31.0)
    got = analytic_edge_moments(_t(w0), _t(b0), _t(hist), _t(M), _t(n))
    want = jax_moments(jnp.asarray(w0), jnp.asarray(b0), jnp.asarray(hist),
                       jnp.asarray(M), jnp.asarray(n))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-4)


def _features(g):
    G, E = g["src"].shape
    N = g["ntype"].shape[1]
    oh = lambda i, n: np.eye(n, dtype=np.float32)[i]
    head = np.take_along_axis(g["ntype"], g["src"], 1)
    tail = np.take_along_axis(g["ntype"], g["dst"], 1)
    edge_feat = np.concatenate([oh(g["etype"], N_REL), oh(head, N_NTYPE),
                                oh(tail, N_NTYPE)], -1).reshape(G * E, F)
    self_feat = np.concatenate(
        [oh(np.full((G, N), N_REL - 1), N_REL), oh(g["ntype"], N_NTYPE),
         oh(g["ntype"], N_NTYPE)], -1).reshape(G * N, F)
    return edge_feat, self_feat


@pytest.fixture(scope="module")
def encoders():
    g = _graph(3)
    edge_feat, self_feat = _features(g)
    w = g["mask"].reshape(-1).astype(np.float32)
    jenc = JaxEdgeEncoder(hidden_size=D, num_updates=2)
    v = jenc.init(jax.random.PRNGKey(0), jnp.asarray(edge_feat),
                  jnp.asarray(w), train=False)
    params = jax.tree.map(np.asarray, v["params"])
    rng = np.random.default_rng(4)
    stats = {"bn": {"mean": rng.standard_normal(D).astype(np.float32) * 0.1,
                    "var": rng.uniform(0.5, 2.0, D).astype(np.float32)}}
    params["bn"] = {"scale": rng.uniform(0.5, 1.5, D).astype(np.float32),
                    "bias": rng.standard_normal(D).astype(np.float32) * 0.1}
    enc = EdgeEncoder(D, F, num_updates=2).eval()
    load_flax_variables(enc, params, stats)
    variables = {"params": params, "batch_stats": stats}
    return g, edge_feat, self_feat, w, jenc, variables, enc


def test_edge_encoder_eval_reference_branch(encoders):
    g, edge_feat, self_feat, w, jenc, variables, enc = encoders
    want = jenc.apply(variables, [(jnp.asarray(edge_feat), jnp.asarray(w)),
                                  (jnp.asarray(self_feat), None)],
                      train=False)
    got = enc([(_t(edge_feat), _t(w)), (_t(self_feat), None)])
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.detach().numpy(), np.asarray(y), **TOL)


def test_edge_encoder_eval_fused_branch(encoders):
    g, edge_feat, self_feat, w, jenc, variables, enc = encoders
    (jh_edge, jh_self), (jw1, jb1) = jenc.apply(
        variables, jnp.asarray(self_feat), train=False, return_hidden=True,
        edge_ints=tuple(jnp.asarray(g[k]) for k in
                        ("etype", "src", "dst", "ntype", "mask")),
        n_rel=N_REL, n_ntype=N_NTYPE)
    with torch.no_grad():
        (h_edge, h_self), (w1, b1) = enc(
            _t(self_feat),
            edge_ints=tuple(_t(g[k]) for k in
                            ("etype", "src", "dst", "ntype", "mask")),
            n_rel=N_REL, n_ntype=N_NTYPE)
    E = g["src"].shape[1]
    np.testing.assert_allclose(
        h_edge.numpy(), np.swapaxes(np.asarray(jh_edge), 1, 2)[:, :E], **TOL)
    np.testing.assert_allclose(h_self.numpy(), np.asarray(jh_self), **TOL)
    np.testing.assert_array_equal(w1.detach().numpy(), np.asarray(jw1))
    np.testing.assert_array_equal(b1.detach().numpy(), np.asarray(jb1))
    # both branches are one function: the fused hidden rows through
    # linear_1 are the reference branch's outputs
    ref_edge, ref_self = enc([(_t(edge_feat), _t(w)), (_t(self_feat), None)])
    np.testing.assert_allclose((h_edge.reshape(-1, D) @ w1 + b1).detach()
                               .numpy(), ref_edge.detach().numpy(), **TOL)
    np.testing.assert_allclose((h_self @ w1 + b1).detach().numpy(),
                               ref_self.detach().numpy(), **TOL)
