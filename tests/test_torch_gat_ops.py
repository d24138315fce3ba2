"""The port's GAT ops against the JAX package on the same inputs (CPU).

`gat_projected_forward` (plain versions of the CUDA kernels on CPU tensors)
is held against `_proj_fwd_impl` with the Pallas kernels in interpret mode,
intermediates included, in f32 (also at widths the tensor-core kernels must
pad) and bf16; pass C alone against `_proj_pass_c`; the port's scatter
oracle against the JAX scatter backend. Then the forward kernels' route
choice and the shared memory of their tensor-core plan, which are Python
that a CPU run reaches.

Tolerance in f32 rtol/atol 2e-4, as tests/test_pallas_gat.py uses for the
projected kernel (f32 sums in another order). The bf16 tolerances stand
beside their checks.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qagnn_tpu.ops.gat_attention import (
    relational_gat_attention_nodes as jax_gat_nodes,
)
from qagnn_tpu.ops.pallas_gat import _proj_fwd_impl, _proj_pass_c

from qagnn_tpu_torch.ops import gat_kernels
from qagnn_tpu_torch.ops.gat_attention import relational_gat_attention_nodes

HEADS = 2
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the machine's cores: one intra-op thread keeps
    this file's torch ops from crowding out the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, G, N, E, HD, D, mask_kind):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrays = dict(
        nq=f(G, N, HD), nk=f(G, N, HD), nm=f(G, N, HD),
        edge_emb=f(G, E, D), w_ke=f(D, HD) * 0.3, b_ke=f(HD),
        w_me=f(D, HD) * 0.3, b_me=f(HD), skb=f(G, N, HD), smb=f(G, N, HD),
        src=rng.integers(0, N, (G, E)).astype(np.int32),
        dst=rng.integers(0, N, (G, E)).astype(np.int32))
    mask = rng.random((G, E)) > 0.25
    if mask_kind == "one_graph_empty":
        mask[1] = False
    elif mask_kind == "all_empty":
        mask[:] = False
    arrays["mask"] = mask
    return arrays


CASES = {
    "masked25": (0, 3, 8, 16, 8, 8, "masked25"),
    "one_graph_all_masked": (1, 3, 8, 16, 8, 8, "one_graph_empty"),
    "all_masked": (2, 2, 8, 16, 8, 8, "all_empty"),
    "ragged_e": (3, 2, 8, 13, 8, 6, "masked25"),
}
# widths the tensor-core kernels pad (D = 24 to 32, HD = 40 to 64, heads of
# 10 split a lane's 8 columns) or take whole (96 x 128), with their heads
WIDTHS = {
    "widths_24x40": ((4, 2, 8, 16, 40, 24, "masked25"), 4),
    "widths_96x128": ((5, 2, 8, 16, 128, 96, "masked25"), 8),
}
CDT = ("nq", "nk", "nm", "edge_emb", "skb", "smb")


def _case(case):
    """(inputs, heads) of a case of CASES or WIDTHS."""
    if case in WIDTHS:
        shape, heads = WIDTHS[case]
        return _inputs(*shape), heads
    return _inputs(*CASES[case]), HEADS


def _rounded(a, dtype):
    """The node and edge inputs rounded to the compute dtype, as numpy f32."""
    if dtype == "float32":
        return a
    return {k: (torch.from_numpy(np.asarray(v)).to(torch.bfloat16).float()
                .numpy() if k in CDT else v) for k, v in a.items()}


def _torch_forward(a, heads=HEADS, dtype="float32"):
    cdt = getattr(torch, dtype)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
    t.update({k: t[k].to(cdt) for k in CDT})
    return gat_kernels.gat_projected_forward(
        t["nq"], t["nk"], t["nm"], t["edge_emb"], t["w_ke"], t["b_ke"],
        t["w_me"], t["b_me"], t["skb"], t["smb"], t["src"], t["dst"],
        t["mask"], heads)


def _jax_forward(a, heads=HEADS, dtype="float32"):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    j.update({k: j[k].astype(jnp.dtype(dtype)) for k in CDT})
    out, scores, gmax, denom_raw, scale, e_self, _ = _proj_fwd_impl(
        j["nq"], j["nk"], j["nm"], jnp.swapaxes(j["edge_emb"], 1, 2),
        j["w_ke"], j["b_ke"], j["w_me"], j["b_me"], j["skb"], j["smb"],
        j["src"], j["dst"], j["mask"].astype(jnp.float32), heads, True)
    return out, scores, gmax, denom_raw, scale, e_self


def _within(got, want, tol, what):
    """max|got - want| <= tol * max|want|."""
    want = np.asarray(want, dtype=np.float32)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    ref = float(np.abs(want).max()) if want.size else 0.0
    assert err <= tol * ref, f"{what}: err {err:.3e} of max {ref:.3e}"


# the f32 cases keep their ids; bf16 and the other widths add theirs
FORWARD_CASES = (
    [pytest.param(c, "float32", id=c) for c in sorted(CASES)]
    + [pytest.param(c, "bfloat16", id=f"{c}-bfloat16") for c in sorted(CASES)]
    + [pytest.param(c, "float32", id=c) for c in sorted(WIDTHS)])


@pytest.mark.parametrize("case,dtype", FORWARD_CASES)
def test_gat_projected_forward_matches_pallas(case, dtype):
    a, heads = _case(case)
    out, scores, gmax, denom_raw, scale, e_self = _torch_forward(a, heads,
                                                                 dtype)
    j_out, j_scores, j_gmax, j_denom_raw, j_scale, j_e_self = _jax_forward(
        a, heads, dtype)
    mask = a["mask"]
    # scores of masked slots are never read: the port writes 0 there, the
    # TPU kernel whatever its tile held; compare the live ones. The scores,
    # gmax and e_self are f32 sums of the same (rounded) values in either
    # dtype.
    live = np.broadcast_to(mask[:, None, :], scores.shape)
    assert (scores.numpy()[~live] == 0).all()
    np.testing.assert_allclose(scores.numpy()[live],
                               np.asarray(j_scores)[live], **TOL)
    np.testing.assert_allclose(gmax.numpy(), np.asarray(j_gmax)[:, :], **TOL)
    np.testing.assert_allclose(e_self.numpy(), np.asarray(j_e_self), **TOL)
    assert np.isfinite(out.numpy()).all()
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
        np.testing.assert_allclose(scale.numpy(), np.asarray(j_scale), **TOL)
        # the residuals that only the backward reads
        np.testing.assert_allclose(denom_raw.numpy(),
                                   np.asarray(j_denom_raw), **TOL)
        return
    # bf16: the TPU kernel sums bf16-rounded exponentials against a running
    # max and rescales them online; the port takes the max first and sums
    # in f32, so the denominators (and the scale made from them) agree
    # within bf16 rounding (measured up to 2.6e-3 relative)
    np.testing.assert_allclose(denom_raw.numpy(), np.asarray(j_denom_raw),
                               rtol=2 ** -7, atol=0)
    np.testing.assert_allclose(scale.numpy(), np.asarray(j_scale),
                               rtol=2 ** -7, atol=0)
    # the output carries that scale in every term, and pass C rounds alpha
    # and the weighted message on both sides from it
    _within(out.numpy(), j_out, 2 ** -6, "out")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pass_c_matches_pallas_alone(case, dtype):
    """Pass C on the same scores, gmax and scale on both sides (no self-loop
    seed): in bf16 the port rounds the scale, alpha and the weighted message
    where `_aggr_proj_kernel` does, and then only the order of the f32 sums
    of bf16 values may differ (measured: exactly equal)."""
    a = _rounded(_inputs(*CASES[case]), dtype)
    rng = np.random.default_rng(21)
    G, N, HD = a["nm"].shape
    E = a["src"].shape[1]
    scores = rng.standard_normal((G, HEADS, E)).astype(np.float32)
    gmax = (scores.max(-1) + rng.random((G, HEADS))).astype(np.float32)
    scale = rng.uniform(0.2, 3.0, (G, N, HEADS)).astype(np.float32)
    cdt = getattr(torch, dtype)
    t = lambda k: torch.from_numpy(np.asarray(a[k]))
    got = gat_kernels.pass_c_plain(
        t("nm").to(cdt), t("edge_emb").to(cdt), t("w_me"), t("b_me"),
        torch.from_numpy(scores), torch.from_numpy(gmax),
        torch.from_numpy(scale), t("src"), t("dst"), t("mask"),
        torch.zeros((G, N, HD)), HEADS).numpy()
    jdt = jnp.dtype(dtype)
    want = np.asarray(_proj_pass_c(
        jnp.asarray(a["nm"]).astype(jdt),
        jnp.swapaxes(jnp.asarray(a["edge_emb"]).astype(jdt), 1, 2),
        jnp.asarray(a["w_me"]), jnp.asarray(a["b_me"]), jnp.asarray(scores),
        jnp.asarray(gmax), jnp.asarray(scale), jnp.asarray(a["src"]),
        jnp.asarray(a["dst"]), jnp.asarray(a["mask"]).astype(jnp.float32),
        HEADS, True))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **TOL)
    else:
        _within(got, want, 1e-6, "pass C out")


def _heads(x):
    return x.reshape(x.shape[0], x.shape[1], HEADS, -1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_scatter_oracle_matches_jax_scatter(case):
    a = _inputs(*CASES[case])
    rng = np.random.default_rng(11)
    G, E = a["src"].shape
    ekb = rng.standard_normal(a["nq"].shape[:1] + (E,) + a["nq"].shape[2:])
    emb = rng.standard_normal(ekb.shape)
    ekb, emb = ekb.astype(np.float32), emb.astype(np.float32)
    node = [a["nq"], a["nk"], a["nm"], ekb, emb, a["skb"], a["smb"]]

    got, (ga, gs) = relational_gat_attention_nodes(
        *[_heads(torch.from_numpy(x)) for x in node],
        torch.from_numpy(a["src"]), torch.from_numpy(a["dst"]),
        torch.from_numpy(a["mask"]), return_alpha=True)
    want, (wa, ws) = jax_gat_nodes(
        *[_heads(jnp.asarray(x)) for x in node], jnp.asarray(a["src"]),
        jnp.asarray(a["dst"]), jnp.asarray(a["mask"]), backend="scatter",
        return_alpha=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)


def test_fused_op_matches_scatter_oracle():
    """The fused op and the scatter oracle are one function: the edge
    projections done outside, the same weights, the same masked edges."""
    a = _inputs(*CASES["masked25"])
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
    ekb = t["edge_emb"] @ t["w_ke"] + t["b_ke"]
    emb = t["edge_emb"] @ t["w_me"] + t["b_me"]
    want = relational_gat_attention_nodes(
        _heads(t["nq"]), _heads(t["nk"]), _heads(t["nm"]), _heads(ekb),
        _heads(emb), _heads(t["skb"]), _heads(t["smb"]), t["src"], t["dst"],
        t["mask"])
    got = _torch_forward(a)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_wrappers_take_plain_version_only_on_cpu():
    """On CPU tensors no kernel is launched and no launch is counted."""
    from qagnn_tpu_torch.ops import _build

    _build.reset_launch_counts()
    _torch_forward(_inputs(*CASES["masked25"]))
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("dtype,D,HD,heads,route,want", [
    (torch.float32, 200, 200, 4, None, 0),
    (torch.bfloat16, 200, 200, 4, None, 1),
    (torch.bfloat16, 24, 40, 4, None, 1),
    (torch.bfloat16, 256, 256, 8, None, 1),
    (torch.bfloat16, 264, 200, 4, None, 0),
    (torch.bfloat16, 16, 16, 8, None, 0),
    (torch.bfloat16, 200, 200, 4, 0, 0),
    (torch.bfloat16, 200, 200, 4, 1, 1),
    (torch.float32, 200, 200, 4, 0, 0)])
def test_forward_route_follows_dtype_and_widths(dtype, D, HD, heads, route,
                                                want):
    """Tensor cores for bf16 where D, HD <= 256 and heads of at least 4
    features; CUDA cores otherwise, or when route 0 is named."""
    assert gat_kernels._fwd_route(dtype, D, HD, heads, route) == want


@pytest.mark.parametrize("dtype,D,HD,heads,route", [
    (torch.float32, 200, 200, 4, 1),
    (torch.bfloat16, 200, 200, 4, 2),
    (torch.bfloat16, 264, 200, 4, 1),
    (torch.bfloat16, 16, 16, 8, 1)])
def test_forward_route_refuses(dtype, D, HD, heads, route):
    """No tensor-core route for float32 (TF32 would change the values), past
    its widths or for heads of fewer than 4 features, and no third route."""
    with pytest.raises(ValueError):
        gat_kernels._fwd_route(dtype, D, HD, heads, route)


# G, E, D, HD, SMs -> warps per block, blocks, shared memory of a block:
# W (WIDTH x (WIDTH + 8) bf16) + warps x (16 f32 rows of WIDTH + 4 and 160
# floats of tables), WIDTH the first of 64, 128, 208, 256 to hold D and HD
FWD_PLANS = {
    "200x200": ((64, 4096, 200, 200, 132), (8, 132, 89856 + 8 * 14208)),
    "24x40": ((2, 16, 24, 40, 132), (8, 1, 9216 + 8 * 4992)),
    "96x128": ((64, 4093, 96, 128, 132), (8, 132, 34816 + 8 * 9088)),
    "256x256": ((64, 4096, 256, 256, 132), (5, 132, 135168 + 5 * 17280)),
}


@pytest.mark.parametrize("case", sorted(FWD_PLANS))
def test_forward_tensor_core_plan(case):
    """As many warps a block as shared memory holds beside W (no cotangent
    tile: one stage a warp), one persistent block per SM at most."""
    (G, E, D, HD, n_sm), (warps, n_blocks, smem) = FWD_PLANS[case]
    assert gat_kernels._fwd_tc_plan(G, E, D, HD, n_sm) == (warps, n_blocks)
    assert gat_kernels._fwd_smem_bytes(D, HD, warps) == smem
    assert smem <= gat_kernels.TC_SMEM_LIMIT
    if warps < gat_kernels.TC_MAX_WARPS:
        assert gat_kernels._fwd_smem_bytes(D, HD, warps + 1) \
            > gat_kernels.TC_SMEM_LIMIT
