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
width take (route 1 for both dtypes at every D with F <= 64), what is
refused, the column slices each route-1 kernel runs (held against the CUDA
source's shared-memory layout) and the backward's scratch and partial
sums. The plain versions, forward and gradients, at D = 37 and 100 in both
dtypes against the Pallas kernels too.

The moments kernel counts (relation, head type, tail type) triples, with
one more relation for the slots whose relation id is out of range, and
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
    type) triple, what the moments kernel's blocks count; relation n_rel
    is the bucket of slots whose relation id lies outside [0, n_rel)."""
    head = np.take_along_axis(g["ntype"], g["src"], 1)
    tail = np.take_along_axis(g["ntype"], g["dst"], 1)
    rel = np.where((g["etype"] >= 0) & (g["etype"] < n_rel), g["etype"],
                   n_rel)
    key = (rel * n_ntype + head) * n_ntype + tail
    return np.bincount(key[g["mask"]],
                       minlength=(n_rel + 1) * n_ntype ** 2) \
        .reshape(n_rel + 1, n_ntype, n_ntype)


def _expand_triple_counts(C, n_rel, n_ntype):
    """hist, M, n from the triple counts as the moments kernel's last block
    expands them (csrc/edge_moments.cu): the three two-way tables RA = sum
    over tail types, RB = sum over head types (both for the n_rel
    relations), AB = sum over relations and the no-relation bucket; the
    histogram from them; M's diagonal blocks diag(hist), its off-diagonal
    blocks the tables; n the sum of AB."""
    nt, F = n_ntype, n_rel + 2 * n_ntype
    RA, RB, AB = C[:n_rel].sum(2), C[:n_rel].sum(1), C.sum(0)
    hist = np.concatenate([RA.sum(1), AB.sum(1), AB.sum(0)])
    M = np.diag(hist)
    rel, head, tail = slice(0, n_rel), slice(n_rel, n_rel + nt), \
        slice(n_rel + nt, F)
    M[rel, head], M[rel, tail], M[head, tail] = RA, RB, AB
    M[head, rel], M[tail, rel], M[tail, head] = RA.T, RB.T, AB.T
    return hist, M, AB.sum()


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
    assert ek._moments_smem(39, 4) == 4 * (640 + 2 * 156 + 16)
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


WIDTHS = (37, 100, 200, 256, 300, 512, 1040)
DTYPES = (torch.bfloat16, torch.float32)


@pytest.mark.parametrize("dtype, D, n_rel, n_ntype, route", [
    *((dt, D, 39, 4, 1) for dt in DTYPES for D in WIDTHS),  # OBQA: F = 47
    (torch.bfloat16, 200, 35, 4, 1),      # MedQA: F = 43
    (torch.bfloat16, 256, 56, 4, 1),      # F = 64, the widest mask
    (torch.bfloat16, 24, 8, 4, 1),
    (torch.float32, 1, 1, 1, 1),
    (torch.bfloat16, 200, 33, 7, 1),      # a type table of 9800 floats
    (torch.float32, 200, 2, 31, 1),       # 961 type pairs: narrow slices
    (torch.bfloat16, 200, 57, 4, 0),      # F = 65: past the 64-bit mask
    (torch.float32, 1040, 57, 4, 0),
])
def test_hidden_route_by_dtype_and_width(dtype, D, n_rel, n_ntype, route):
    assert ek._hidden_route(dtype, D, n_rel, n_ntype) == route
    assert ek._hidden_route(dtype, D, n_rel, n_ntype, 0) == 0


@pytest.mark.parametrize("dtype, D, n_rel, n_ntype, route", [
    (torch.bfloat16, 200, 57, 4, 1),
    (torch.float32, 100, 57, 4, 1),
    (torch.float16, 200, 39, 4, 1),
    (torch.bfloat16, 200, 39, 4, 2),
])
def test_hidden_route_refuses(dtype, D, n_rel, n_ntype, route):
    with pytest.raises(ValueError, match="no route"):
        ek._hidden_route(dtype, D, n_rel, n_ntype, route)


@pytest.mark.parametrize("dtype, D, F, n_ntype, slices", [
    # one slice of all of D where W0 and U fit in half an SM
    (torch.bfloat16, 100, 47, 4, [(0, 100)]),
    (torch.bfloat16, 200, 47, 4, [(0, 200)]),
    (torch.float32, 200, 47, 4, [(0, 200)]),
    (torch.bfloat16, 37, 47, 4, [(0, 37)]),
    (torch.bfloat16, 512, 47, 4, [(0, 512)]),
    # past it the fewest slices of a multiple of 8 columns
    (torch.bfloat16, 1040, 47, 4, [(0, 520), (520, 1040)]),
    (torch.float32, 512, 47, 4, [(0, 256), (256, 512)]),
    (torch.float32, 1040, 47, 4, [(0, 352), (352, 704), (704, 1040)]),
    (torch.float32, 200, 64, 31, [(c, min(c + 24, 200))
                                  for c in range(0, 200, 24)]),
])
def test_hidden_forward_slices(dtype, D, F, n_ntype, slices):
    got = ek.tc_fwd_slices(D, F, n_ntype, dtype)
    assert got == slices == ek.fwd_slices(1, D, F, n_ntype, dtype)
    width = got[0][1]
    assert len(got) == 1 or width % 8 == 0
    assert ek._tc_tables_bytes(F, width, n_ntype, dtype) <= ek.TC_FWD_SMEM
    if len(got) > 1:       # one slice fewer would not fit
        n = len(got) - 1
        wider = D if n == 1 else (-(-D // n) + 7) // 8 * 8
        assert ek._tc_tables_bytes(F, wider, n_ntype, dtype) > ek.TC_FWD_SMEM


@pytest.mark.parametrize("dtype, D, F, n_ntype, slices", [
    (torch.bfloat16, 100, 47, 4, [(0, 100)]),
    (torch.float32, 200, 47, 4, [(0, 200)]),
    (torch.bfloat16, 256, 64, 4, [(0, 256)]),
    (torch.float32, 256, 64, 4, [(0, 256)]),
    (torch.bfloat16, 300, 47, 4, [(0, 160), (160, 300)]),
    (torch.bfloat16, 512, 47, 4, [(0, 256), (256, 512)]),
    (torch.bfloat16, 1040, 47, 4, [(c, c + 208) for c in range(0, 1040,
                                                               208)]),
    (torch.float32, 1040, 47, 4, [(c, c + 208) for c in range(0, 1040,
                                                              208)]),
    # a type table of 961 rows: slices of 48 columns fit
    (torch.bfloat16, 200, 64, 31, [(c, min(c + 48, 200))
                                   for c in range(0, 200, 48)]),
])
def test_hidden_backward_slices(dtype, D, F, n_ntype, slices):
    """At most 256 columns a slice (16 warps of 16), a multiple of 16
    where there are several, and the block in an SM's shared memory."""
    got = ek.tc_bwd_slices(D, F, n_ntype, dtype)
    assert got == slices == ek.bwd_slices(1, D, F, n_ntype, dtype)
    width = got[0][1]
    assert width <= ek.TC_BWD_COLS and (len(got) == 1 or width % 16 == 0)
    assert ek._tc_bwd_smem(F, width, n_ntype, dtype) <= ek.TC_SMEM


def test_hidden_route_0_slices_are_unchanged():
    assert ek.fwd_slices(0, 1025, 47, 4, torch.float32) == \
        ek.fwd_col_slices(1025, torch.float32) == [(0, 1024), (1024, 1025)]
    assert ek.bwd_slices(0, 1040, 47, 4, torch.bfloat16) == \
        ek.bwd_col_slices(47, 1040)


@pytest.mark.parametrize("route, D, dtype, n_slices, n_blocks", [
    (1, 200, torch.bfloat16, 1, 132),
    (1, 1040, torch.bfloat16, 5, 26),      # one wave of 130 blocks
    (1, 512, torch.float32, 2, 66),
    (0, 1040, torch.bfloat16, 2, ek.BWD_BLOCKS),
])
def test_hidden_backward_plan(route, D, dtype, n_slices, n_blocks):
    """One call: every slice's blocks write their columns of one (n_blocks,
    F + 3, D) array of partial sums (the rows D apart, the pitch of dh the
    kernel reads in place), and route 1 packs the slots' rows once for all
    the slices."""
    n_edges = 64 * 4093
    plan = ek.bwd_plan(route, n_edges, D, 47, 4, dtype, 132)
    assert len(plan.slices) == n_slices and plan.n_blocks == n_blocks
    assert plan.part == (n_blocks, 50, D)
    assert plan.slices[0][0] == 0 and plan.slices[-1][1] == D
    assert all(a[1] == b[0] for a, b in zip(plan.slices, plan.slices[1:]))
    assert plan.rows == ek._bwd_rows_scratch(route, n_edges) == \
        (3 * -(-n_edges // 16) * 16 if route == 1 else 0)


def test_hidden_smem_matches_the_kernel():
    """The Python plans' shared-memory sizes are the CUDA source's: the
    limits, the ring's stages, cells and tile pitch of each dtype."""
    import re
    from pathlib import Path
    src = (Path(ek.__file__).parent.parent / "csrc" /
           "edge_hidden_tc.cuh").read_text()
    for name, value in (("EH_MAX_F", ek.TC_MAX_F), ("EH_TILE", ek.TC_TILE),
                        ("EH_SMEM", ek.TC_SMEM),
                        ("EH_BWD_COLS", ek.TC_BWD_COLS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert re.search(r"EH_FWD_SMEM = EH_SMEM / 2;", src)
    for ctype, dt in (("bf16", torch.bfloat16), ("float", torch.float32)):
        stages, cell, pitch = ek.TC_RING[dt]
        assert re.search(rf"struct Ehb<{ctype}> {{\s*static constexpr int "
                         rf"STAGES = {stages}, CELL = {cell}, XLD = {pitch};",
                         src), ctype


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


def _wide(seed, D, E):
    """A graph and the encoder's weights at width D, F = 16."""
    g = _graph(seed, E=E)
    rng = np.random.default_rng(seed + 1)
    w0 = rng.standard_normal((F, D)).astype(np.float32)
    b0, a, b = (rng.standard_normal(D).astype(np.float32) for _ in range(3))
    return g, (w0, b0, a, b)


@pytest.mark.parametrize("E", [24, 21])
@pytest.mark.parametrize("D", [37, 100])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_edge_hidden_widths_match_pallas(dtype, D, E):
    """The plain version at widths route 1 takes since it takes every D
    (odd, and the CLI's default 100) against the Pallas kernel in interpret
    mode, at E and E - 3: f32 at rtol / atol 2e-5, bf16 within one ulp
    (2^-7 relative), the preset cases' tolerances."""
    g, p = _wide(20 + D, D, E)
    ints = ("etype", "src", "dst", "ntype")
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    got = edge_hidden(*[_t(g[k]) for k in ints], *map(_t, p), N_REL, N_NTYPE,
                      tdt)
    want = jax_edge_hidden(*[jnp.asarray(g[k]) for k in ints],
                           *map(jnp.asarray, p), N_REL, N_NTYPE, jdt, True)
    want = np.swapaxes(np.asarray(want.astype(jnp.float32)), 1, 2)[:, :E]
    assert got.dtype == tdt and got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=0)


@pytest.mark.parametrize("E", [24, 21])
@pytest.mark.parametrize("D", [37, 100])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_edge_hidden_widths_gradients_match_pallas(dtype, D, E):
    """Gradients in W0, b0, a, b of the plain version against jax.grad
    through the Pallas kernels in interpret mode at D = 37 and 100, E and
    E - 3: f32 at rtol 2e-5 with a floor of 2e-5 of the largest value, bf16
    within 1e-6 of it (the cotangent in bf16), as at the preset."""
    g, p = _wide(40 + D, D, E)
    rng = np.random.default_rng(D + E)
    cot = rng.standard_normal(g["src"].shape + (D,)).astype(np.float32)
    ints = ("etype", "src", "dst", "ntype")
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    if dtype == "bf16":
        cot = _bf16(cot)

    def jax_loss(w0, b0, a, b):
        h = jax_edge_hidden(*[jnp.asarray(g[k]) for k in ints], w0, b0, a, b,
                            N_REL, N_NTYPE, jdt, True)           # (G, D, E')
        return jnp.sum(h[:, :, :E].astype(jnp.float32)
                       * jnp.swapaxes(jnp.asarray(cot), 1, 2))

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, p))
    params = [_t(x).requires_grad_() for x in p]
    h = edge_hidden(*[_t(g[k]) for k in ints], *params, N_REL, N_NTYPE, tdt)
    (h.float() * _t(cot)).sum().backward()
    for name, x, y in zip(("dW0", "db0", "da", "db"), params, want):
        y = np.asarray(y)
        if dtype == "f32":
            np.testing.assert_allclose(x.grad.numpy(), y, rtol=2e-5,
                                       atol=2e-5 * np.abs(y).max())
        else:
            err = np.abs(x.grad.numpy() - y).max()
            assert err <= 1e-6 * np.abs(y).max(), (name, err)


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
