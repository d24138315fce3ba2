"""The port's unprojected GAT op against the JAX package (CPU).

`gat_unprojected_forward` / `gat_unprojected` (plain versions of the CUDA
kernels on CPU tensors) are held against `_fwd_impl` and the VJP of
`pallas_relational_gat` with the Pallas kernels in interpret mode, on the
same numpy-seeded inputs, and the op-level entry point
`relational_gat_attention_nodes(backend="cuda")` against the JAX function
with backend "pallas" and against both scatter backends.

Tolerances: f32 values rtol 2e-4 / atol 2e-5 and gradients rtol 5e-4 / atol
5e-5, as tests/test_pallas_gat.py holds the Pallas op against the XLA
backends (f32 sums in another order). In bf16 both sides round at the same
points, but a sum taken in another order can round a term the other way, one
bf16 ulp (2^-8 relative) of the largest value: values within 2^-7 of the
array's largest magnitude; gradients within the 5% drift of the f32 scatter
oracle that tests/test_pallas_gat.py allows the Pallas op.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qagnn_tpu.ops.gat_attention import (
    relational_gat_attention_nodes as jax_gat_nodes,
)
from qagnn_tpu.ops.pallas_gat import _fwd_impl, pallas_relational_gat

from qagnn_tpu_torch.models import gnn as port_gnn
from qagnn_tpu_torch.ops import _build, gat_attention
from qagnn_tpu_torch.ops import gat_unproj_kernels as uk
from qagnn_tpu_torch.ops.gat_attention import relational_gat_attention_nodes

HEADS = 2
FLOATS = ("nq", "nk", "nm", "ekb", "emb", "skb", "smb")
VAL_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
BF16_ULPS = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the machine's cores: one intra-op thread keeps
    this file's torch ops from crowding out the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, G, N, E, HD, mask_kind):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    a = dict(nq=f(G, N, HD), nk=f(G, N, HD), nm=f(G, N, HD),
             ekb=f(G, E, HD), emb=f(G, E, HD), skb=f(G, N, HD),
             smb=f(G, N, HD),
             src=rng.integers(0, N, (G, E)).astype(np.int32),
             dst=rng.integers(0, N, (G, E)).astype(np.int32))
    mask = rng.random((G, E)) > 0.25
    if mask_kind == "one_graph_empty":
        mask[1] = False
    elif mask_kind == "all_empty":
        mask[:] = False
    a["mask"] = mask
    a["g"] = f(G, N, HD)                   # the output's cotangent
    return a


CASES = {
    "masked25": (0, 3, 8, 16, 8, "masked25"),
    "one_graph_all_masked": (1, 3, 8, 16, 8, "one_graph_empty"),
    "all_masked": (2, 3, 8, 16, 8, "all_empty"),
    "ragged_e": (3, 3, 8, 13, 8, "masked25"),
}


def _torch_args(a, dtype=torch.float32):
    return [torch.from_numpy(a[k]).to(dtype) for k in FLOATS] + [
        torch.from_numpy(a[k]) for k in ("src", "dst", "mask")]


def _jax_args(a, dtype=jnp.float32):
    return [jnp.asarray(a[k], dtype) for k in FLOATS] + [
        jnp.asarray(a["src"]), jnp.asarray(a["dst"]),
        jnp.asarray(a["mask"], jnp.float32)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _torch_grads(fn, a, dtype=torch.float32):
    args = _torch_args(a, dtype)
    leaves = [t.requires_grad_() for t in args[:7]]
    out = fn(*leaves, *args[7:])
    out.backward(torch.from_numpy(a["g"]).to(out.dtype))
    return out, [t.grad for t in leaves]


def _jax_grads(a, dtype=jnp.float32):
    args = _jax_args(a, dtype)
    out, vjp = jax.vjp(
        lambda *f: pallas_relational_gat(*f, *args[7:], HEADS, True),
        *args[:7])
    return out, vjp(jnp.asarray(a["g"]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_residuals_match_pallas(case):
    a = _inputs(*CASES[case])
    got = uk.gat_unprojected_forward(*_torch_args(a), HEADS)
    want = _fwd_impl(*_jax_args(a), HEADS, True)
    names = ("out", "e_edge", "denom_raw", "scale", "e_self")
    live = np.broadcast_to(a["mask"][:, None, :], got[1].shape)
    for name, g, w in zip(names, got, want):
        g, w = _np(g), _np(w)
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, err_msg=name, **VAL_TOL)
    # masked slots of e_edge are exactly 0 on both sides
    assert (_np(got[1])[~live] == 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_pallas_vjp(case):
    a = _inputs(*CASES[case])
    out, got = _torch_grads(
        lambda *t: uk.gat_unprojected(*t, HEADS), a)
    j_out, want = _jax_grads(a)
    np.testing.assert_allclose(_np(out), _np(j_out), **VAL_TOL)
    for name, g, w in zip(FLOATS, got, want):
        assert np.isfinite(_np(g)).all(), name
        np.testing.assert_allclose(_np(g), _np(w), err_msg=f"d{name}",
                                   **GRAD_TOL)
    if not a["mask"].any():
        # no live edge: the edge biases get exact zeros
        assert (_np(got[3]) == 0).all() and (_np(got[4]) == 0).all()


def test_gradients_match_autograd_through_the_scatter_oracle():
    """The hand-written backward against autograd through plain torch ops."""
    a = _inputs(*CASES["masked25"])

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], HEADS, -1)

    _, got = _torch_grads(lambda *t: uk.gat_unprojected(*t, HEADS), a)
    _, want = _torch_grads(
        lambda *t: relational_gat_attention_nodes(
            *[heads(x) for x in t[:7]], *t[7:], backend="scatter"), a)
    for name, g, w in zip(FLOATS, got, want):
        np.testing.assert_allclose(_np(g), _np(w), err_msg=f"d{name}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("case", ["masked25", "ragged_e"])
def test_bf16_values_and_gradients(case):
    a = _inputs(*CASES[case])
    out, got = _torch_grads(lambda *t: uk.gat_unprojected(*t, HEADS), a,
                            torch.bfloat16)
    j_out, j_grads = _jax_grads(a, jnp.bfloat16)
    assert out.dtype == torch.float32
    for name, g, w in zip(("out",) + FLOATS, (out, *got), (j_out, *j_grads)):
        g, w = _np(g), _np(w)
        assert np.abs(g - w).max() <= BF16_ULPS * np.abs(w).max(), name
    assert all(g.dtype == torch.bfloat16 for g in got)

    # drift of the bf16 gradients from the f32 scatter oracle
    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], HEADS, -1)

    _, want = _torch_grads(
        lambda *t: relational_gat_attention_nodes(
            *[heads(x) for x in t[:7]], *t[7:], backend="scatter"), a)
    for name, g, w in zip(FLOATS, got, want):
        rel = np.abs(_np(g) - _np(w)).max() / max(np.abs(_np(w)).max(), 1e-6)
        assert rel < 0.05, f"bf16 gradient drift of d{name}: {rel:.4f}"


def _heads_t(t):
    return t.reshape(t.shape[0], t.shape[1], HEADS, -1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_cuda_backend_matches_jax_pallas_and_scatter(case):
    a = _inputs(*CASES[case])
    t, j = _torch_args(a), _jax_args(a)
    node_t = [_heads_t(x) for x in t[:7]]
    got = relational_gat_attention_nodes(*node_t, *t[7:], backend="cuda")
    scatter = relational_gat_attention_nodes(*node_t, *t[7:],
                                             backend="scatter")
    node_j = [_heads_t(x) for x in j[:7]]
    want = jax_gat_nodes(*node_j, j[7], j[8], jnp.asarray(a["mask"]),
                         backend="pallas")
    assert got.shape == scatter.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **VAL_TOL)
    np.testing.assert_allclose(_np(got), _np(scatter), **VAL_TOL)
    # int64 indices and an integer mask are taken too
    again = relational_gat_attention_nodes(
        *node_t, t[7].long(), t[8].long(), t[9].to(torch.int32),
        backend="cuda")
    assert torch.equal(again, got)


def test_return_alpha_takes_the_scatter_arm():
    a = _inputs(*CASES["masked25"])
    t = _torch_args(a)
    node = [_heads_t(x) for x in t[:7]]
    _build.reset_launch_counts()
    out, (ea, sa) = relational_gat_attention_nodes(
        *node, *t[7:], backend="cuda", return_alpha=True)
    want, (wea, wsa) = relational_gat_attention_nodes(
        *node, *t[7:], backend="scatter", return_alpha=True)
    assert torch.equal(out, want) and torch.equal(ea, wea) \
        and torch.equal(sa, wsa)
    G, E = a["src"].shape
    assert ea.shape == (G, E, HEADS) and sa.shape == (G, 8, HEADS)
    # each source's softmax sums to 1 over its live edges and its self loop
    total = sa.clone().scatter_add_(
        1, t[7].long()[..., None].expand(G, E, HEADS),
        ea * t[9][..., None])
    np.testing.assert_allclose(total.numpy(), 1.0, rtol=1e-5)
    assert (ea[~t[9]] == 0).all()


def test_backend_resolution():
    t = torch.zeros(1)
    assert gat_attention.default_backend(t) == "scatter"
    assert gat_attention.resolve_backend(None, t) == "scatter"
    assert gat_attention.resolve_backend("cuda", t) == "cuda"
    # the model and the op share one definition
    assert port_gnn.resolve_backend is gat_attention.resolve_backend
    a = _inputs(*CASES["masked25"])
    args = _torch_args(a)
    with pytest.raises(ValueError, match="unknown backend"):
        relational_gat_attention_nodes(
            *[_heads_t(x) for x in args[:7]], *args[7:], backend="onehot")


def test_default_backend_on_cpu_is_scatter():
    a = _inputs(*CASES["masked25"])
    t = _torch_args(a)
    node = [_heads_t(x) for x in t[:7]]
    assert torch.equal(
        relational_gat_attention_nodes(*node, *t[7:]),
        relational_gat_attention_nodes(*node, *t[7:], backend="scatter"))


WRAPPERS = {
    "edge_scores": lambda a, r: uk.edge_scores(
        a["nq"], a["nk"], a["ekb"], a["src"], a["dst"], a["mask"], HEADS),
    "edge_scores route 1": lambda a, r: uk.edge_scores(
        a["nq"], a["nk"], a["ekb"], a["src"], a["dst"], a["mask"], HEADS,
        _route=1),
    "edge_denoms": lambda a, r: uk.edge_denoms(
        r["scores"], r["gmax"], a["src"], a["mask"], 8),
    "edge_denoms route 1": lambda a, r: uk.edge_denoms(
        r["scores"], r["gmax"], a["src"], a["mask"], 8, _route=1),
    "aggregate": lambda a, r: uk.aggregate(
        a["nm"], a["emb"], r["e_edge"], r["scale"], a["src"], a["dst"],
        a["mask"], torch.zeros_like(a["nm"]), HEADS),
    "aggregate route 1": lambda a, r: uk.aggregate(
        a["nm"], a["emb"], r["e_edge"], r["scale"], a["src"], a["dst"],
        a["mask"], torch.zeros_like(a["nm"]), HEADS, _route=1),
    "bwd1": lambda a, r: uk.bwd1(
        a["g"], a["nm"], a["emb"], r["e_edge"], r["scale"], a["src"],
        a["dst"], a["mask"], torch.zeros_like(a["nm"]),
        torch.zeros_like(r["scale"]), HEADS),
    "bwd1 route 1": lambda a, r: uk.bwd1(
        a["g"], a["nm"], a["emb"], r["e_edge"], r["scale"], a["src"],
        a["dst"], a["mask"], torch.zeros_like(a["nm"]),
        torch.zeros_like(r["scale"]), HEADS, _route=1),
    "bwd2": lambda a, r: uk.bwd2(
        a["nq"], a["nk"], a["ekb"], r["e_edge"], r["e_edge"] * 0.5,
        r["scale"], r["scale"] * 0.1, a["src"], a["dst"], a["mask"],
        torch.zeros_like(a["nq"]), torch.zeros_like(a["nq"]), HEADS),
    "bwd2 route 1": lambda a, r: uk.bwd2(
        a["nq"], a["nk"], a["ekb"], r["e_edge"], r["e_edge"] * 0.5,
        r["scale"], r["scale"] * 0.1, a["src"], a["dst"], a["mask"],
        torch.zeros_like(a["nq"]), torch.zeros_like(a["nq"]), HEADS,
        _route=1),
}
PLAIN = {"edge_scores": uk.edge_scores_plain,
         "edge_scores route 1": uk.edge_scores_plain,
         "edge_denoms": uk.edge_denoms_plain,
         "edge_denoms route 1": uk.edge_denoms_plain,
         "aggregate": uk.aggregate_plain,
         "aggregate route 1": uk.aggregate_plain, "bwd1": uk.bwd1_plain,
         "bwd1 route 1": uk.bwd1_plain, "bwd2": uk.bwd2_plain,
         "bwd2 route 1": uk.bwd2_plain}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_takes_plain_version_only_on_cpu(name, monkeypatch):
    """On CPU tensors a wrapper runs its plain version, launches nothing
    and counts no launch."""
    a = {k: torch.from_numpy(v) for k, v in
         _inputs(*CASES["masked25"]).items()}
    _, e_edge, _, scale, _ = uk.gat_unprojected_forward(
        *[a[k] for k in FLOATS], a["src"], a["dst"], a["mask"], HEADS)
    scores, m_edge = uk.edge_scores_plain(
        a["nq"], a["nk"], a["ekb"], a["src"], a["dst"], a["mask"], HEADS)
    r = dict(e_edge=e_edge, scale=scale, scores=scores, gmax=m_edge)
    calls = []
    plain = PLAIN[name]
    monkeypatch.setattr(uk, plain.__name__,
                        lambda *args: calls.append(1) or plain(*args))
    monkeypatch.setattr(uk, "_lib", lambda: pytest.fail("kernel on CPU"))
    _build.reset_launch_counts()
    out = WRAPPERS[name](a, r)
    assert calls == [1]
    assert sum(_build.LAUNCHES.values()) == 0
    assert all(torch.isfinite(o).all() for o in out) \
        if isinstance(out, tuple) else torch.isfinite(out).all()


@pytest.mark.parametrize("dtype, N, E, HD, heads, route, cw", [
    (torch.bfloat16, 200, 4096, 200, 4, 1, 56),   # the op's main shapes
    (torch.float32, 200, 4096, 200, 4, 1, 24),
    (torch.bfloat16, 200, 4093, 96, 8, 1, 24),    # heads of 12 straddle
    (torch.bfloat16, 200, 4093, 256, 8, 1, 48),
    (torch.float32, 200, 4096, 256, 8, 1, 32),
    (torch.bfloat16, 1500, 4096, 200, 4, 1, 16),  # one block an SM
    (torch.bfloat16, 200, 4096, 32, 8, 0, 16),    # heads of 4 features
    (torch.bfloat16, 4000, 4093, 200, 4, 0, None),  # no slice fits
    (torch.bfloat16, 200, 20000, 200, 4, 0, None),
    (torch.bfloat16, 8, 70000, 16, 2, 0, None),   # the slots' tables
])
def test_bwd2_route_by_dtype_and_shape(dtype, N, E, HD, heads, route, cw):
    """Route 1 takes f32 and bf16 where heads have at least 8 features and
    a block of the widest slice that fits two an SM (else one) holds the
    graph's tables; route 0, the warp-per-edge kernel, the rest."""
    assert uk._bwd2_route(dtype, N, E, HD, heads) == route
    assert uk._bwd2_route(dtype, N, E, HD, heads, 0) == 0
    assert uk._bwd2_width(dtype, N, E, HD, heads) == cw
    if cw is not None:
        assert uk._bwd2_smem(N, E, HD, heads, cw, dtype.itemsize) \
            <= uk.BWD2_MAX_SMEM


@pytest.mark.parametrize("dtype, N, E, HD, heads, route", [
    (torch.bfloat16, 200, 4096, 32, 8, 1),
    (torch.bfloat16, 4000, 4096, 200, 4, 1),
    (torch.bfloat16, 8, 70000, 16, 2, 1),
    (torch.float16, 200, 4096, 200, 4, 1),
    (torch.bfloat16, 200, 4096, 200, 4, 2),
])
def test_bwd2_route_refuses(dtype, N, E, HD, heads, route):
    with pytest.raises(ValueError, match="no route"):
        uk._bwd2_route(dtype, N, E, HD, heads, route)


def test_bwd2_smem_counts_the_most_heads_a_slice_touches():
    """At HD=200 with heads of 50, one slice of all columns touches four
    heads, 72-column slices two each (72 to 144 straddles 100), and so do
    some 8-column ones (48 to 56 straddles 50). The block holds nq and nk
    (bf16 here); room for (scale, d_denom) per node and head that the sorts'
    two uint16 permutations reuse, the larger of the two; d_s per slot and
    head; each slot's packed (src, dst); the sorts' offsets and cursors."""
    for cw, hs in ((200, 4), (72, 2), (8, 2)):
        room = max(200 * hs * 8, 4096 * 4)
        assert uk._bwd2_smem(200, 4096, 200, 4, cw, 2) \
            == 200 * cw * 4 + room + 4096 * hs * 4 + 4096 * 4 + 802 * 4
    # few slots: the per-node terms set the shared room, rounded to 16
    assert uk._bwd2_smem(200, 100, 200, 4, 200, 2) \
        == 200 * 200 * 4 + 6400 + 100 * 4 * 4 + 100 * 4 + 802 * 4


ROUTES_OF_SORTED = (uk._aggr_route, uk._bwd1_route)


@pytest.mark.parametrize("dtype, N, E, HD, heads, routes", [
    (torch.bfloat16, 200, 4096, 200, 4, (1, 1)),   # the op's main shapes
    (torch.float32, 200, 4096, 200, 4, (1, 0)),    # bwd1: f32 on route 0
    (torch.bfloat16, 200, 4093, 96, 8, (1, 1)),    # heads of 12 straddle
    (torch.float32, 200, 4093, 256, 8, (1, 0)),
    (torch.bfloat16, 4000, 4093, 200, 4, (1, 1)),  # many nodes, few slots
    (torch.bfloat16, 200, 24000, 200, 4, (1, 1)),
    (torch.bfloat16, 200, 27000, 200, 4, (1, 0)),  # bwd1's ring holds more
    (torch.bfloat16, 200, 30000, 200, 4, (0, 0)),
    (torch.bfloat16, 200, 4096, 32, 8, (0, 0)),    # heads of 4 features
    (torch.bfloat16, 8, 70000, 16, 2, (0, 0)),     # beyond the uint16 slots
    (torch.float16, 200, 4096, 200, 4, (0, 0)),
])
def test_aggr_and_bwd1_route_by_dtype_and_shape(dtype, N, E, HD, heads,
                                                routes):
    """Route 1 of aggregate and bwd1 takes f32 and bf16 where heads have
    at least 8 features and the block (the warps' rings and the graph's
    slot tables) fits a block's shared memory, with N and E within its
    uint16 indices; route 0, the warp-per-edge kernel, the rest. bwd1's
    rule sends f32 to route 0, which is faster there; route 1 still takes
    f32 where the caller names it."""
    for route_of, route in zip(ROUTES_OF_SORTED, routes):
        assert route_of(dtype, N, E, HD, heads) == route
        assert route_of(dtype, N, E, HD, heads, 0) == 0
        if route:
            assert route_of(dtype, N, E, HD, heads, 1) == 1


@pytest.mark.parametrize("HD, heads", [(200, 4), (256, 8)])
def test_bwd1_route_1_takes_f32_where_named(HD, heads):
    assert uk._bwd1_route(torch.float32, 200, 4096, HD, heads) == 0
    assert uk._bwd1_route(torch.float32, 200, 4096, HD, heads, 1) == 1


@pytest.mark.parametrize("dtype, N, E, HD, heads, route", [
    (torch.bfloat16, 200, 4096, 32, 8, 1),
    (torch.bfloat16, 200, 30000, 200, 4, 1),
    (torch.bfloat16, 70000, 100, 200, 4, 1),
    (torch.float16, 200, 4096, 200, 4, 1),
    (torch.bfloat16, 200, 4096, 200, 4, 2),
    (torch.float32, 200, 4096, 200, 4, -1),
])
def test_aggr_and_bwd1_route_refuses(dtype, N, E, HD, heads, route):
    for route_of in ROUTES_OF_SORTED:
        with pytest.raises(ValueError, match="no route"):
            route_of(dtype, N, E, HD, heads, route)


@pytest.mark.parametrize("N, E, HD, elem, rows", [
    (200, 4096, 200, 2, 2), (200, 4096, 200, 2, 3), (200, 4096, 200, 4, 2),
    (200, 4096, 200, 4, 3), (200, 4093, 96, 2, 3), (4000, 4093, 256, 4, 3),
    (1, 1, 8, 2, 2),
])
def test_sorted_smem_holds_the_rings_and_the_slot_tables(N, E, HD, elem,
                                                         rows):
    """A route-1 block of aggregate (2 rows a slot) or bwd1 (3) holds, for
    each of its 8 warps, a ring of 8 slots in bf16 or 4 in f32 (the same
    bytes), a slot's rows and two floats for each of up to 8 heads; then
    each slot's packed (src, dst) as a uint32, the node offsets (N + 1)
    and cursors (N) as int32, and the permutation of the slots as
    uint16."""
    depth = {2: 8, 4: 4}[elem]
    stage = rows * HD * elem + 64
    assert stage % 16 == 0                 # 16-byte cp.async targets
    assert uk._sorted_smem(N, E, HD, elem, rows) \
        == 8 * depth * stage + E * 4 + (N + 1) * 4 + N * 4 + E * 2


def test_sorted_blocks_pair_on_an_sm_at_the_main_shapes():
    """At the op's main shapes two route-1 blocks of either kernel share
    an SM, in bf16 and f32, so that one's prologue overlaps the other's
    stream of rows."""
    for elem in (2, 4):
        for rows in (uk.AGGR_ROWS, uk.BWD1_ROWS):
            assert uk._sorted_smem(200, 4096, 200, elem, rows) \
                <= uk.BWD2_PAIR_SMEM


@pytest.mark.parametrize("dtype, N, E, HD, heads, routes", [
    (torch.bfloat16, 200, 4096, 200, 4, (1, 1)),   # the op's main shapes
    (torch.float32, 200, 4096, 200, 4, (1, 1)),
    (torch.bfloat16, 200, 4093, 96, 8, (1, 1)),    # heads of 12 straddle
    (torch.float32, 200, 4093, 256, 8, (1, 1)),
    (torch.bfloat16, 4000, 4093, 200, 4, (1, 1)),  # many nodes, few slots
    (torch.bfloat16, 20000, 4096, 200, 4, (1, 1)),
    (torch.bfloat16, 21000, 4096, 200, 4, (1, 0)),  # denoms' table too large
    (torch.float32, 12000, 4096, 256, 8, (1, 1)),
    (torch.float32, 13000, 4096, 256, 8, (1, 0)),
    (torch.bfloat16, 200, 14000, 200, 4, (1, 1)),
    (torch.bfloat16, 200, 14600, 200, 4, (1, 0)),
    (torch.bfloat16, 200, 70000, 200, 4, (1, 0)),  # beyond uint16 slots
    (torch.bfloat16, 200, 4096, 32, 8, (0, 1)),    # heads of 4 features
    (torch.float16, 200, 4096, 200, 4, (0, 1)),    # denoms read f32 scores
])
def test_scores_and_denoms_route_by_dtype_and_shape(dtype, N, E, HD, heads,
                                                    routes):
    """Route 1 of the scores takes f32 and bf16 where heads have at least 8
    features, at any N and E (a block takes a fixed range of slots and
    holds int32 node indices); route 1 of the denominators takes any dtype
    where a graph's exponentials, grouped by source, and its node offsets
    fit a block's shared memory. Route 0 takes the rest."""
    scores_route = uk._scores_route(dtype, N, E, HD, heads)
    denoms_route = uk._denoms_route(N, E, heads)
    assert (scores_route, denoms_route) == routes
    assert uk._scores_route(dtype, N, E, HD, heads, 0) == 0
    assert uk._denoms_route(N, E, heads, 0) == 0
    if routes[0]:
        assert uk._scores_route(dtype, N, E, HD, heads, 1) == 1
    if routes[1]:
        assert uk._denoms_route(N, E, heads, 1) == 1


@pytest.mark.parametrize("dtype, N, E, HD, heads, route", [
    (torch.bfloat16, 200, 4096, 32, 8, 1),
    (torch.float16, 200, 4096, 200, 4, 1),
    (torch.bfloat16, 200, 4096, 200, 4, 2),
    (torch.float32, 200, 4096, 200, 4, -1),
])
def test_scores_route_refuses(dtype, N, E, HD, heads, route):
    with pytest.raises(ValueError, match="no route"):
        uk._scores_route(dtype, N, E, HD, heads, route)


@pytest.mark.parametrize("N, E, heads, route", [
    (30000, 4096, 4, 1), (200, 70000, 4, 1), (13000, 4096, 8, 1),
    (200, 4096, 9, 1), (200, 4096, 4, 2),
])
def test_denoms_route_refuses(N, E, heads, route):
    with pytest.raises(ValueError, match="no route"):
        uk._denoms_route(N, E, heads, route)


@pytest.mark.parametrize("N, E, heads", [
    (200, 4096, 4), (4000, 4093, 4), (1, 1, 1), (200, 4093, 8),
    (12000, 4096, 8),
])
def test_denoms_smem_holds_a_graphs_runs_and_offsets(N, E, heads):
    """A route-1 denominators block holds the graph's exponentials grouped
    by source (f32, heads x E), then the node offsets (N + 1) and the
    counts, later the next places (N), as int32: 65,536 + 1,604 bytes at
    the main shapes."""
    assert uk._denoms_smem(N, E, heads) \
        == heads * E * 4 + (N + 1) * 4 + N * 4
    assert uk._denoms_smem(N, E, heads) <= uk.SORTED_MAX_SMEM
    assert uk._denoms_smem(200, 4096, 4) == 65_536 + 1_604
