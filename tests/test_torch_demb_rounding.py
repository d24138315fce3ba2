"""Backward passes 1 and 2 of more than one launch round demb once (CPU).

A pass whose columns run as more than one launch (`gk.launches`: more than
8 heads, more than 256 columns, or a head wider than 256 features) writes
each launch's cotangent rows into its columns of one (G, E, HD) array, and
one more launch (`bwd_demb`, csrc/gat_demb.cu `demb_tc_kernel`) forms
demb = cot W^T + add over all HD columns in f32 and rounds it once, as
`_bwd1_proj_kernel` / `_bwd2_proj_kernel` do in their one pass over all
columns (ROADMAP C17; before, each launch's bf16 demb was the next one's
carry, n roundings for n launches). The kernels run only on the card;
here, with the Python that a CPU run reaches:

  * every multi-launch bf16 (and f32) pass, with a carry and without,
    against one unsliced call of its plain version: within one bf16 step
    in every element, |got - want| <= 2^-7 |want| + 1e-6 max|want| (the
    second term for the order of the f32 sums);
  * bf16 and f32 passes at two-launch widths against the JAX package's
    `_proj_bwd_pass1` / `_proj_bwd_pass2` in Pallas interpret mode: demb
    within one bf16 step in every element (f32: 1e-6 of max|want|), the
    other outputs within 1e-6 of max|want| (tests/test_torch_gat_backward.py's
    tolerance);
  * the demb product's plain version against an f64 einsum;
  * a single-launch pass (the preset, gnn_dim 100 and 256) is bit for bit
    the arithmetic it was, and makes no demb launch;
  * what the wrappers hand the C entry points on the card (a CPU tensor
    that reports itself on the card and a stand-in for the library): the
    column launches with no demb and their cotangent columns in place in
    one array, then one `gat_bwd_demb` with the carry (pass 1) or demb in
    place (pass 2), on the route asked for.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bwd_f32_route import _card, _Lib, _OnCard
from test_torch_gat_backward import (  # noqa: F401  (fixture by name)
    CDT_NAMES,
    PASS_TOL,
    _close,
    _inputs,
    _np,
    _one_torch_thread,
    _torch,
)

from qagnn_tpu.ops.pallas_gat import (
    _proj_bwd_glue,
    _proj_bwd_pass1,
    _proj_bwd_pass2,
    _proj_fwd_impl,
)
from qagnn_tpu_torch.ops import _build
from qagnn_tpu_torch.ops import gat_kernels as gk

BF16 = torch.bfloat16
DTYPES = {"bf16": BF16, "f32": torch.float32}
# (D, HD, heads) of the passes of several launches: two head groups of 256;
# eight launches of 128 / 136 columns (4 heads of 264, each split in two),
# at D 40 and 520; more than 8 heads (10 heads of 16: two groups)
MULTI = [(40, 512, 4), (40, 1056, 4), (520, 1056, 4), (40, 160, 10)]


def bf16_step_gap(got, want):
    """The elements of got further than one bf16 step from want: |got -
    want| > 2^-7 |want| + 1e-6 max|want|; and max|got - want| / max|want|."""
    got, want = got.double(), want.double()
    top = float(want.abs().max())
    gap = (got - want).abs()
    far = int((gap > 2 ** -7 * want.abs() + 1e-6 * top).sum())
    return far, float(gap.max()) / max(top, 1e-30)


def _pass_inputs(seed, G, N, E, D, HD, heads, dt):
    """Node, edge and per-head inputs of both passes from a numpy seed, with
    a graph of no live slot."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    mask = torch.from_numpy(rng.random((G, E)) > 0.25)
    mask[1] = False
    idx = lambda: torch.from_numpy(  # noqa: E731
        rng.integers(0, N, (G, E)).astype(np.int32))
    return dict(
        gout=f(G, N, HD).to(dt), nm=(f(G, N, HD) * 0.5).to(dt),
        nq=(f(G, N, HD) * 0.3).to(dt), nk=(f(G, N, HD) * 0.5).to(dt),
        emb=torch.relu(f(G, E, D)).to(dt), w_me=f(D, HD) * 0.05,
        w_ke=f(D, HD) * 0.05, b_me=f(HD) * 0.1, b_ke=f(HD) * 0.1,
        scores=f(G, heads, E), gmax=f(G, heads).abs() + 2.0,
        scale=torch.from_numpy(rng.random((G, N, heads)).astype(np.float32))
        + 0.5, d_denom=f(G, N, heads) * 0.1, carry=(f(G, E, D) * 0.1).to(dt),
        src=idx(), dst=idx(), mask=mask)


def _pass1_args(t, carry):
    return (t["gout"], t["nm"], t["emb"], t["w_me"], t["b_me"], t["scores"],
            t["gmax"], t["scale"], t["src"], t["dst"], t["mask"],
            t["carry"] if carry else None)


def _pass2_args(t, dalpha):
    return (t["nq"], t["nk"], t["emb"], t["w_ke"], t["b_ke"], t["scores"],
            t["gmax"], dalpha, t["scale"], t["d_denom"], t["src"], t["dst"],
            t["mask"])


# --------------------------------------------------------------------------
# one unsliced call of the plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("carry", [True, False], ids=["carry", "no_carry"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("D,HD,heads", MULTI)
def test_multi_launch_passes_match_one_unsliced_call(D, HD, heads, dt,
                                                     carry):
    G, N, E = 2, 7, 256
    cdt = DTYPES[dt]
    assert len(gk.launches(HD, heads)) > 1
    t = _pass_inputs(D + HD + heads, G, N, E, D, HD, heads, cdt)
    seeds = (torch.randn(G, N, HD), torch.randn(G, N, heads))
    a1 = _pass1_args(t, carry)
    got1 = gk.bwd_pass1(*a1, *(x.clone() for x in seeds), heads)
    want1 = gk.bwd_pass1_plain(*a1, *(x.clone() for x in seeds), heads)
    a2 = _pass2_args(t, want1[1])
    seeds2 = (torch.randn(G, N, HD), torch.randn(G, N, HD))
    got2 = gk.bwd_pass2(*a2, want1[0].clone(), *(x.clone() for x in seeds2),
                        heads)
    want2 = gk.bwd_pass2_plain(*a2, want1[0].clone(),
                               *(x.clone() for x in seeds2), heads)
    for what, got, want in (("pass 1", got1, want1), ("pass 2", got2, want2)):
        assert got[0].dtype == want[0].dtype == cdt
        far, rel = bf16_step_gap(got[0], want[0])
        assert far == 0, (what, "demb", far, rel)
        if cdt == torch.float32:
            assert rel <= 1e-6, (what, "demb", rel)
        # the other outputs: f32 sums over a head's columns in another order
        # (a split head's d_alpha), each rounded to bf16 where the TPU rounds
        tol = 1e-5 if cdt == torch.float32 else 2 ** -7
        for i, (g, w) in enumerate(zip(got[1:], want[1:])):
            g, w = g.double(), w.double()
            err = float((g - w).abs().max())
            assert err <= tol * float(w.abs().max()), (what, i + 1, err)
    # a masked slot passes its carry (or 0), then pass 1's demb, exactly
    dead = ~t["mask"]
    assert torch.equal(got1[0][dead],
                       t["carry"][dead] if carry
                       else torch.zeros_like(got1[0][dead]))
    assert torch.equal(got2[0][dead], want1[0][dead])


# --------------------------------------------------------------------------
# the JAX package's passes
# --------------------------------------------------------------------------

# (seed, G, N, E, HD, D, mask kind), heads: two launches a pass, two head
# groups of 256 columns; ten heads of 16, two groups of five
PALLAS = {
    "d40_hd512": ((31, 2, 8, 13, 512, 40, "one_graph_empty"), 4),
    "d24_ten_heads": ((32, 2, 8, 13, 160, 24, "masked25"), 10),
}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", sorted(PALLAS))
def test_two_launch_passes_match_pallas(case, dtype):
    shape, heads = PALLAS[case]
    a = _inputs(*shape)
    HD = a["nq"].shape[-1]
    assert len(gk.launches(HD, heads)) == 2
    # the query as the op takes it, W_q x / sqrt(features a head)
    a["nq"] = (a["nq"] / np.sqrt(HD // heads)).astype(np.float32)
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
    d_denom, _, dnq_self, dnk_self = _proj_bwd_glue(
        j["nq"], j["nk"], j["skb"], denom_raw, scale, e_self, d_alpha_self,
        dscale, HD)
    demb2, dnq, dnk, dw_ke, db_ke = _proj_bwd_pass2(
        j["nq"], j["nk"], emb_t, j["w_ke"], j["b_ke"], scores, gmax, dalpha,
        scale, d_denom, j["src"], j["dst"], jmask, demb_m, heads, True,
        self_terms=(dnq_self, dnk_self))

    t = {k: _torch(v, tdt if k in CDT_NAMES else None) for k, v in a.items()}
    f = {k: _torch(_np(v)) for k, v in dict(
        scores=scores, gmax=gmax, scale=scale, d_denom=d_denom,
        dalpha=dalpha, dnm=d_msg_self, dscale=d_alpha_self * e_self,
        dnq=dnq_self, dnk=dnk_self).items()}
    got1 = gk.bwd_pass1(
        _torch(a["g"], tdt), t["nm"], t["edge_emb"], t["w_me"], t["b_me"],
        f["scores"], f["gmax"], f["scale"], t["src"], t["dst"], t["mask"],
        _torch(a["carry"], tdt), f["dnm"], f["dscale"], heads)
    got2 = gk.bwd_pass2(
        t["nq"], t["nk"], t["edge_emb"], t["w_ke"], t["b_ke"], f["scores"],
        f["gmax"], f["dalpha"], f["scale"], f["d_denom"], t["src"],
        t["dst"], t["mask"], _torch(_np(jnp.swapaxes(demb_m, 1, 2)), tdt),
        f["dnq"], f["dnk"], heads)
    # the TPU kernel leaves d_alpha of a masked slot as computed (nothing
    # reads it: e is 0 there); the port writes 0
    want1 = (jnp.swapaxes(demb_m, 1, 2), dalpha * jmask[:, None, :], dnm,
             dscale, dw_me, db_me.reshape(-1))
    want2 = (jnp.swapaxes(demb2, 1, 2), dnq, dnk, dw_ke, db_ke.reshape(-1))
    for what, got, want, names in (
            ("pass 1", got1, want1,
             ("demb", "dalpha", "dnm", "dscale", "dW_me", "db_me")),
            ("pass 2", got2, want2, ("demb", "dnq", "dnk", "dW_ke",
                                     "db_ke"))):
        far, _ = bf16_step_gap(got[0], _torch(_np(want[0])))
        assert far == 0, (what, "demb", far)
        if dtype == "float32":
            _close(got[0], want[0], PASS_TOL, f"{what} demb")
        for name, x, y in zip(names[1:], got[1:], want[1:]):
            _close(x, y, PASS_TOL, f"{what} {name}")


# --------------------------------------------------------------------------
# the demb product's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_add", [True, False], ids=["add", "no_add"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_demb_plain_matches_f64(dt, with_add):
    cdt = DTYPES[dt]
    rng = np.random.default_rng(7)
    G, E, D, HD = 3, 40, 104, 1056
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    cot = (f(G, E, HD) * torch.from_numpy(rng.random((G, E, 1)) > 0.25)) \
        .to(cdt)
    w = f(D, HD) * 0.05
    add = (f(G, E, D) * 0.1).to(cdt) if with_add else None
    got = gk.bwd_demb_plain(cot, w, add)
    assert got.dtype == cdt and got.shape == (G, E, D)
    want = torch.einsum("gek,dk->ged", cot.double(), w.to(cdt).double())
    if with_add:
        want = want + add.double()
    far, rel = bf16_step_gap(got, want)
    assert far == 0, (far, rel)
    if cdt == torch.float32:
        assert rel <= 1e-6, rel
    # on the CUDA wrapper's CPU path, the plain version itself
    assert torch.equal(gk.bwd_demb(cot, w, add), got)


# --------------------------------------------------------------------------
# single-launch passes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("width", [200, 100, 256])
def test_single_launch_pass_is_unchanged(monkeypatch, width, dt):
    """The preset's width, the CLI's default gnn_dim and 256: one launch a
    pass, no demb launch, and demb the arithmetic it was, bit for bit:
    d_msg W^T + carry (pass 1), demb + dekb W^T (pass 2), in f32 with W
    rounded to the compute dtype, rounded once."""
    cdt = DTYPES[dt]
    D, HD = gk.kernel_widths(width, width, 4)
    assert len(gk.launches(HD, 4)) == 1
    G, N, E = 2, 7, 64
    t = _pass_inputs(width, G, N, E, D, HD, 4, cdt)
    calls = []
    monkeypatch.setattr(gk, "bwd_demb", lambda *a, **k: calls.append(a))
    z = lambda *s: torch.zeros(s)  # noqa: E731
    a1 = _pass1_args(t, True)
    got1 = gk.bwd_pass1(*a1, z(G, N, HD), z(G, N, 4), 4)
    cot1 = gk.bwd_pass1_plain(*a1, z(G, N, HD), z(G, N, 4), 4,
                              cot=torch.empty((G, E, HD), dtype=cdt))[0]
    old1 = (cot1.float() @ t["w_me"].to(cdt).float().t()
            + t["carry"].float()).to(cdt)
    assert torch.equal(got1[0], old1)
    a2 = _pass2_args(t, got1[1])
    got2 = gk.bwd_pass2(*a2, got1[0].clone(), z(G, N, HD), z(G, N, HD), 4)
    cot2 = gk.bwd_pass2_plain(*a2, None, z(G, N, HD), z(G, N, HD), 4,
                              cot=torch.empty((G, E, HD), dtype=cdt))[0]
    old2 = (got1[0].float() + cot2.float() @ t["w_ke"].to(cdt).float().t()) \
        .to(cdt)
    assert torch.equal(got2[0], old2)
    assert calls == []


# --------------------------------------------------------------------------
# what the wrappers hand the kernels
# --------------------------------------------------------------------------

# the positions among the C entry points' arguments: pass 1's carry, dmsg
# and demb, pass 2's dekb and demb, and the cotangent rows' stride (the last
# int of either pass); the demb launch's cot, W (route 1: W rounded to
# bf16 and W's tf32 lo, None in bf16; route 0: W^T in slices), add and
# demb, and route 1's tile width and ring slots
P1_CARRY, P1_COT, P1_DEMB, P2_COT, P2_DEMB, LD_COT = 12, 13, 14, 14, 15, -2
DM_COT, DM_W = 0, 1
DM_ADD, DM_OUT = {1: 3, 0: 2}, {1: 4, 0: 3}
DM_W_LO, DM_BN, DM_STAGES = 2, 8, 9


@pytest.mark.parametrize("route", [1, 0])
@pytest.mark.parametrize("D,HD,heads", [(40, 512, 4), (520, 160, 10)])
def test_wrappers_run_one_demb_launch_a_pass(monkeypatch, D, HD, heads,
                                             route):
    G, N, E = 2, 8, 13
    t = {k: _card(v) for k, v in _pass_inputs(5, G, N, E, D, HD, heads,
                                              BF16).items()}
    lib = _Lib()
    cots = []

    def cot_rows(src, HD_, like):
        cots.append(torch.empty((*src.shape, HD_), dtype=like.dtype)
                    .as_subclass(_OnCard))
        return cots[-1]
    monkeypatch.setattr(gk, "_bwd_lib", lambda: lib)
    monkeypatch.setattr(gk, "_demb_lib", lambda: lib)
    monkeypatch.setattr(gk, "_dw_lib", lambda: lib)
    monkeypatch.setattr(gk, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(gk, "_stream", lambda: 0)
    monkeypatch.setattr(gk, "_cot_rows", cot_rows)
    acc = lambda *s: _card(torch.zeros(s))  # noqa: E731
    plan = gk.launches(HD, heads)
    entry = "gat_demb_tc" if route == 1 else "gat_bwd_demb"
    try:
        demb = gk.bwd_pass1(*_pass1_args(t, True), acc(G, N, HD),
                            acc(G, N, heads), heads, _route=route)[0]
        demb2 = gk.bwd_pass2(*_pass2_args(t, acc(G, heads, E)), demb,
                             acc(G, N, HD), acc(G, N, HD), heads,
                             _route=route)[0]
        counts = dict(_build.LAUNCHES), dict(_build.ROUTES)
    finally:
        _build.reset_launch_counts()
    n = len(plan)
    # route 1: each pass then one dW launch over all of its columns (its
    # column launches make none); route 0's column launches make their own
    dw = {"gat_bwd_dw": 2} if route == 1 else {}
    assert counts == ({"gat_bwd_pass1": n, "gat_bwd_pass2": n,
                       "gat_bwd_demb": 2} | dw,
                      {("gat_bwd_pass1", route): n,
                       ("gat_bwd_pass2", route): n,
                       ("gat_bwd_demb", route): 2}
                      | {(k, route): v for k, v in dw.items()})
    names = [name for name, _ in lib.calls]
    tail = [entry] + (["gat_dw_tc"] if route == 1 else [])
    assert names == ["gat_bwd_pass1"] * n + tail \
        + ["gat_bwd_pass2"] * n + tail
    for k, (cot, first) in enumerate(((cots[0], 0),
                                      (cots[1], n + len(tail)))):
        launches = lib.calls[first:first + n]
        demb_call = lib.calls[first + n][1]
        at_cot, at_demb = (P1_COT, P1_DEMB) if k == 0 else (P2_COT, P2_DEMB)
        for (_, args), (_, _, c0, _) in zip(launches, plan):
            # no demb product and no carry in a launch; its cotangent rows
            # in place in its columns of the one array
            assert args[at_demb] is None
            if k == 0:
                assert args[P1_CARRY] is None
            assert args[at_cot] == cot.data_ptr() + 2 * c0
            assert args[LD_COT] == HD
        assert demb_call[DM_COT] == cot.data_ptr()
        assert demb_call[DM_W] is not None
        if route == 1:
            want = gk.demb_plan(D, HD, BF16)
            assert demb_call[DM_W_LO] is None
            assert demb_call[DM_BN:DM_STAGES + 1] == (want.bn, want.stages)
        add_at, out_at = DM_ADD[route], DM_OUT[route]
        if k == 0:
            assert demb_call[add_at] == t["carry"].data_ptr()
            assert demb_call[out_at] == demb.data_ptr()
        else:
            # pass 2 adds into pass 1's demb in place
            assert demb_call[add_at] == demb_call[out_at] == demb.data_ptr()
            assert demb2 is demb
        if route == 1:
            # dW over the same cotangent rows, after the demb launch
            dw_call = lib.calls[first + n + 1][1]
            assert dw_call[0] == t["emb"].data_ptr()
            assert dw_call[1] == cot.data_ptr() and dw_call[4] == G * E
