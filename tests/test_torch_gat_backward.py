"""Gradients of the port's projected GAT op against the JAX package (CPU).

`gat_projected` / `gat_projected_chained` (autograd Functions whose backward
runs the plain versions of the CUDA backward passes on CPU tensors) against
`jax.vjp` of `pallas_relational_gat_projected[_chained]` with the Pallas
kernels in interpret mode: the output and all ten gradients, with a graph
whose every edge is masked, a ragged E, widths that the tensor-core kernels
must pad (D = 24, HD = 40: neither a multiple of 16, and heads of 10 features
split their 8-column groups), and a non-zero carry on the chained form. Then
the width contract of the backward kernels and the sizes of their partial-sum
scratch on both routes (CUDA cores, tensor cores), which are Python that a CPU
run reaches.

Tolerances, each as max|got - want| <= tol * max|want| per array: f32 2e-4
(the tolerance tests/test_pallas_gat.py uses: f32 sums in another order);
bf16 6e-2: the backward passes round where the TPU kernels round, but the
forward's pass A sums its bf16-rounded exponentials against a running
per-tile max and rescales them online, where the port takes the max first
(a known difference), so the scale and every gradient downstream of it
differ by a few bf16 roundings (2^-8 each) of terms summed over few edges.

Each backward pass alone (`bwd_pass1`, `bwd_pass2` on CPU tensors) against
`_proj_bwd_pass1` / `_proj_bwd_pass2` in interpret mode, given the same
scores, gmax, scale and d_denom from `_proj_fwd_impl`: within 1e-6 of
max|want| for every array in both dtypes, since both round to the compute
dtype at the same points (the scale and d_denom as gathered, alpha, d_s,
the d_alpha * e term, the cotangents before products and scatters).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from qagnn_tpu.ops.pallas_gat import (
    _proj_bwd_glue,
    _proj_bwd_pass1,
    _proj_bwd_pass2,
    _proj_fwd_impl,
    pallas_relational_gat_projected,
    pallas_relational_gat_projected_chained,
)

from qagnn_tpu_torch.ops import gat_kernels

NAMES = ("nq", "nk", "nm", "edge_emb", "w_ke", "b_ke", "w_me", "b_me", "skb",
         "smb")
CDT_NAMES = ("nq", "nk", "nm", "edge_emb", "skb", "smb")
TOL = {"float32": 2e-4, "bfloat16": 6e-2}


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
    a = dict(
        nq=f(G, N, HD) * 0.5, nk=f(G, N, HD) * 0.5, nm=f(G, N, HD),
        edge_emb=f(G, E, D), w_ke=f(D, HD) * 0.3, b_ke=f(HD) * 0.3,
        w_me=f(D, HD) * 0.3, b_me=f(HD) * 0.3, skb=f(G, N, HD) * 0.5,
        smb=f(G, N, HD),
        src=rng.integers(0, N, (G, E)).astype(np.int32),
        dst=rng.integers(0, N, (G, E)).astype(np.int32),
        g=f(G, N, HD), carry=f(G, E, D))
    mask = rng.random((G, E)) > 0.25
    if mask_kind == "one_graph_empty":
        mask[1] = False
    a["mask"] = mask
    return a


# (seed, G, N, E, HD, D, mask kind), heads
CASES = {
    "masked25": ((0, 3, 8, 16, 8, 8, "masked25"), 2),
    "one_graph_all_masked": ((1, 3, 8, 16, 8, 8, "one_graph_empty"), 2),
    "ragged_e": ((3, 2, 8, 13, 8, 16, "masked25"), 2),
    "odd_widths": ((4, 2, 8, 16, 40, 24, "masked25"), 4),
}
HEADS = CASES["masked25"][1]


def _jax_grads(a, dtype, chained, carry, heads=HEADS):
    cdt = jnp.dtype(dtype)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    for k in CDT_NAMES:
        j[k] = j[k].astype(cdt)
    j["edge_emb"] = jnp.swapaxes(j["edge_emb"], 1, 2)       # (G, D, E)
    mask = j["mask"].astype(cdt)
    op = pallas_relational_gat_projected_chained if chained \
        else pallas_relational_gat_projected
    out, vjp = jax.vjp(
        lambda *ten: op(*ten, j["src"], j["dst"], mask, heads, True),
        *[j[k] for k in NAMES])
    if chained:
        cot = (j["g"], jnp.swapaxes(j["carry"], 1, 2).astype(cdt) if carry
               else jnp.zeros_like(j["edge_emb"]))
        out = out[0]
    else:
        cot = j["g"]
    grads = dict(zip(NAMES, vjp(cot)))
    grads["edge_emb"] = jnp.swapaxes(grads["edge_emb"], 1, 2)
    return out, grads


def _torch_grads(a, dtype, chained, carry, heads=HEADS):
    cdt = getattr(torch, dtype)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
    ten = [(t[k].to(cdt) if k in CDT_NAMES else t[k]).requires_grad_()
           for k in NAMES]
    tail = (t["src"], t["dst"], t["mask"], heads)
    if chained:
        out, emb = gat_kernels.gat_projected_chained(*ten, *tail)
        loss = (out * t["g"]).sum()
        if carry:
            loss = loss + (emb.float() * t["carry"].to(cdt).float()).sum()
    else:
        out = gat_kernels.gat_projected(*ten, *tail)
        loss = (out * t["g"]).sum()
    loss.backward()
    return out.detach(), dict(zip(NAMES, (x.grad for x in ten)))


def _close(got, want, tol, what):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    ref = float(np.abs(want).max())
    assert np.isfinite(got).all(), what
    assert err <= tol * max(ref, 1e-6), f"{what}: err {err:.3e} of {ref:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["plain", "chained", "chained_carry"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_gat_projected_gradients_match_pallas(case, form, dtype):
    shape, heads = CASES[case]
    a = _inputs(*shape)
    chained, carry = form != "plain", form == "chained_carry"
    j_out, j_grads = _jax_grads(a, dtype, chained, carry, heads)
    out, grads = _torch_grads(a, dtype, chained, carry, heads)
    _close(out, j_out, TOL[dtype], "out")
    for name in NAMES:
        assert grads[name] is not None, name
        assert grads[name].dtype == (
            torch.float32 if name[0] in "wb" else getattr(torch, dtype))
        _close(grads[name], j_grads[name], TOL[dtype], f"d{name}")


PASS_TOL = 1e-6


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _torch(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_passes_alone_match_pallas(case, dtype):
    """Each pass on the same inputs as the JAX pass, carry included."""
    shape, heads = CASES[case]
    a = _inputs(*shape)
    cdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    for k in CDT_NAMES:
        j[k] = j[k].astype(cdt)
    emb_t = jnp.swapaxes(j["edge_emb"], 1, 2)                # (G, D, E)
    jmask = j["mask"].astype(cdt)
    nodes = (j["nq"], j["nk"], j["nm"], emb_t, j["w_ke"], j["b_ke"],
             j["w_me"], j["b_me"], j["skb"], j["smb"], j["src"], j["dst"],
             jmask)
    _, scores, gmax, denom_raw, scale, e_self, nms = _proj_fwd_impl(
        *nodes, heads, True)
    carry_t = jnp.swapaxes(j["carry"], 1, 2).astype(cdt)
    (d_alpha_self, d_msg_self, _), b1 = _proj_bwd_pass1(
        *nodes, scores, gmax, scale, e_self, j["g"], heads, True,
        carry=carry_t, fold_self=True, packed=nms)
    demb_m, dalpha, dscale, dnm, dw_me, db_me = b1
    HD = a["nq"].shape[-1]
    d_denom, _, dnq_self, dnk_self = _proj_bwd_glue(
        j["nq"], j["nk"], j["skb"], denom_raw, scale, e_self, d_alpha_self,
        dscale, HD)
    want2 = _proj_bwd_pass2(
        j["nq"], j["nk"], emb_t, j["w_ke"], j["b_ke"], scores, gmax, dalpha,
        scale, d_denom, j["src"], j["dst"], jmask, demb_m, heads, True,
        self_terms=(dnq_self, dnk_self))

    t = {k: _torch(v, tdt if k in CDT_NAMES else None) for k, v in a.items()}
    f = {k: _torch(_np(v)) for k, v in dict(
        scores=scores, gmax=gmax, scale=scale, d_denom=d_denom,
        dalpha=dalpha, dnm=d_msg_self,
        dscale=d_alpha_self * e_self, dnq=dnq_self, dnk=dnk_self).items()}
    got1 = gat_kernels.bwd_pass1(
        _torch(a["g"], tdt), t["nm"], t["edge_emb"], t["w_me"], t["b_me"],
        f["scores"], f["gmax"], f["scale"], t["src"], t["dst"], t["mask"],
        _torch(a["carry"], tdt), f["dnm"], f["dscale"], heads)
    # the TPU kernel leaves d_alpha of a masked slot as computed (nothing
    # reads it: e is 0 there); the port writes 0
    want1 = (jnp.swapaxes(demb_m, 1, 2), dalpha * jmask[:, None, :], dnm,
             dscale, dw_me, db_me.reshape(-1))
    for name, x, y in zip(("demb", "dalpha", "dnm", "dscale", "dW_me",
                           "db_me"), got1, want1):
        _close(x, y, PASS_TOL, f"pass 1 {name}")
    got2 = gat_kernels.bwd_pass2(
        t["nq"], t["nk"], t["edge_emb"], t["w_ke"], t["b_ke"], f["scores"],
        f["gmax"], f["dalpha"], f["scale"], f["d_denom"], t["src"],
        t["dst"], t["mask"], _torch(_np(jnp.swapaxes(demb_m, 1, 2)), tdt),
        f["dnq"], f["dnk"], heads)
    demb2, dnq, dnk, dw_ke, db_ke = want2
    want2 = (jnp.swapaxes(demb2, 1, 2), dnq, dnk, dw_ke, db_ke.reshape(-1))
    for name, x, y in zip(("demb", "dnq", "dnk", "dW_ke", "db_ke"), got2,
                          want2):
        _close(x, y, PASS_TOL, f"pass 2 {name}")


def test_carry_is_added_once_and_masked_slots_pass_it_through():
    """d_edge_emb of a masked slot is the carry alone, and the carry enters
    the sum exactly once."""
    a = _inputs(*CASES["one_graph_all_masked"][0])
    _, with_carry = _torch_grads(a, "float32", True, True)
    _, without = _torch_grads(a, "float32", True, False)
    carry = torch.from_numpy(a["carry"])
    torch.testing.assert_close(with_carry["edge_emb"],
                               without["edge_emb"] + carry, rtol=1e-6,
                               atol=1e-6)
    dead = ~torch.from_numpy(a["mask"])
    assert torch.equal(without["edge_emb"][dead],
                       torch.zeros_like(without["edge_emb"][dead]))
    for name in NAMES:
        if name != "edge_emb":
            torch.testing.assert_close(with_carry[name], without[name])


def test_unused_passthrough_gives_no_carry():
    """A passthrough that nothing consumes reaches the backward as None,
    not as an array of zeros."""
    seen = []
    real = gat_kernels.gat_projected_backward

    def spy(*args):
        seen.append(args[-2])
        return real(*args)

    a = _inputs(*CASES["masked25"][0])
    gat_kernels.gat_projected_backward = spy
    try:
        _torch_grads(a, "float32", True, False)
        _torch_grads(a, "float32", True, True)
    finally:
        gat_kernels.gat_projected_backward = real
    assert seen[0] is None and seen[1] is not None


def test_no_gradient_flows_through_the_max():
    """The fused op's gradients equal autograd's through the scatter oracle,
    whose shift is detached too."""
    from qagnn_tpu_torch.ops.gat_attention import (
        relational_gat_attention_nodes,
    )

    a = _inputs(*CASES["masked25"][0])
    _, got = _torch_grads(a, "float32", False, False)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
    ten = {k: t[k].clone().requires_grad_() for k in NAMES}
    heads = lambda x: x.reshape(*x.shape[:-1], HEADS, -1)
    out = relational_gat_attention_nodes(
        heads(ten["nq"]), heads(ten["nk"]), heads(ten["nm"]),
        heads(ten["edge_emb"] @ ten["w_ke"] + ten["b_ke"]),
        heads(ten["edge_emb"] @ ten["w_me"] + ten["b_me"]),
        heads(ten["skb"]), heads(ten["smb"]), t["src"], t["dst"], t["mask"])
    (out * t["g"]).sum().backward()
    for name in NAMES:
        _close(got[name], jnp.asarray(ten[name].grad.numpy()), 2e-4,
               f"d{name}")


@pytest.mark.parametrize("D,HD,heads", [(200, 200, 4), (24, 40, 4),
                                         (256, 256, 8), (8, 8, 2),
                                         (264, 200, 4), (512, 256, 2)])
def test_backward_kernels_accept_widths(D, HD, heads):
    """Any D a multiple of 8: past 256 the kernels run W's rows in
    slices."""
    gat_kernels._check_bwd_widths(D, HD, heads)


@pytest.mark.parametrize("D,HD,heads,why", [
    (200, 264, 4, "HD over 256"),
    (12, 40, 4, "D not a multiple of 8"),
    (260, 200, 4, "D over 256 not a multiple of 8"),
    (72, 72, 9, "nine heads"),
    (16, 16, 8, "heads of two features"),
    (24, 40, 3, "heads that do not divide HD"),
])
def test_backward_kernels_refuse_widths(D, HD, heads, why):
    with pytest.raises(ValueError):
        gat_kernels._check_bwd_widths(D, HD, heads)


@pytest.mark.parametrize("dtype,route,want", [
    (torch.float32, None, 1), (torch.bfloat16, None, 1),
    (torch.bfloat16, 0, 0), (torch.bfloat16, 1, 1), (torch.float32, 0, 0),
    (torch.float32, 1, 1)])
def test_backward_route_follows_the_dtype(dtype, route, want):
    """Tensor cores in both dtypes (split-TF32 products in float32); route
    0, the CUDA-core kernels, when named."""
    assert gat_kernels._bwd_route(dtype, route) == want


@pytest.mark.parametrize("dtype,route", [(torch.float32, 2),
                                         (torch.bfloat16, 2)])
def test_backward_route_refuses(dtype, route):
    """No third route in either dtype."""
    with pytest.raises(ValueError):
        gat_kernels._bwd_route(dtype, route)


# G, E, D, HD, SMs -> warps per block, blocks, and the slot ranges of
# route 0 of the dW launch (`bwd_dw`: `dw_tc_kernel`, once a range an SM)
TC_PLANS = {
    "main": ((64, 4096, 200, 200, 132), (8, 132, 132)),
    "widest": ((64, 4096, 256, 256, 132), (5, 132, 132)),
    "ragged_e": ((64, 4093, 200, 200, 132), (8, 132, 132)),
    "odd_widths": ((2, 16, 24, 40, 132), (8, 1, 1)),
    "few_edges": ((3, 100, 200, 200, 132), (8, 3, 10)),
}


@pytest.mark.parametrize("case", sorted(TC_PLANS))
def test_split_scratch_sizes_on_tensor_cores(case):
    """One db partial per persistent block, no dW partial (one `bwd_dw`
    launch a pass makes dW; its route 0 one partial per slot range), and a
    block's shared memory within what the card grants."""
    (G, E, D, HD, n_sm), (warps, n_blocks, n_split) = TC_PLANS[case]
    got = gat_kernels._split_scratch(G, E, D, HD, "cpu", route=1, n_sm=n_sm)
    assert got[:3] == (0, warps, n_blocks) and got[3] is None
    assert gat_kernels._dw_splits(G, E, n_sm) == n_split
    assert got[4].shape == (n_blocks, HD) and got[4].dtype == torch.float32
    assert gat_kernels._tc_smem_bytes(D, HD, warps) \
        <= gat_kernels.TC_SMEM_LIMIT
    if warps < gat_kernels.TC_MAX_WARPS:
        assert gat_kernels._tc_smem_bytes(D, HD, warps + 1) \
            > gat_kernels.TC_SMEM_LIMIT
    # every 16-edge unit has a warp to take it
    assert n_blocks * warps >= min(n_sm * warps, G * -(-E // 16))


@pytest.mark.parametrize("G,E,D,HD,n_split,db_rows", [
    (64, 4096, 200, 200, 128, 64 * 64), (64, 4093, 200, 200, 128, 64 * 64),
    (2, 16, 24, 40, 1, 2), (3, 100, 8, 8, 10, 6)])
def test_split_scratch_sizes_on_cuda_cores(G, E, D, HD, n_split, db_rows):
    """One db partial per (64-edge tile, graph) block; no block plan."""
    got = gat_kernels._split_scratch(G, E, D, HD, "cpu")
    assert got[:3] == (n_split, 0, 0)
    assert got[3].shape == (n_split, D, HD)
    assert got[4].shape == (db_rows, HD)
