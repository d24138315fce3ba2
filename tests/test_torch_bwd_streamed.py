"""Backward passes 1 and 2 past D = 256, and the f64 reference (CPU).

Route 1 of `gat_bwd_pass1` / `gat_bwd_pass2` streams W's rows through
shared memory past D = 256 (csrc/gat_bwd_tc.cuh, `edge_pass_tc_kernel<PASS,
PAIRS, true>`): one launch a column launch, handed W rounded to bf16 by the
wrapper. The kernel runs only on the card; here, with the Python that a CPU
run reaches:

  * the decision to stream (`_bwd_streams`, D > 256 only) and the bf16 W
    the wrapper hands the kernel (route 1 past 256 only);
  * the tiles and warps of the plan (`BWD_STREAM_TILES`) against the
    constants the kernel is compiled with, parsed from csrc, and the
    launch's switch over them;
  * every streamed plan within the shared memory a block may ask for;
  * both passes through their wrappers (the kernels' plain versions on CPU
    tensors: the head groups, column slices and partial mode the launches
    take) against the JAX package's `_proj_bwd_pass1` / `_proj_bwd_pass2`
    in interpret mode at D = 264 and 520, a head of 264 features split over
    two column launches among them, with a carry, masked slots and E = 13,
    the query scaled by 1 / sqrt(features a head) as the op takes it.
    Tolerance, max|got - want| <= tol * max|want| per array: 1e-6, as
    tests/test_torch_gat_backward.py holds one launch (both sides round at
    the same points), d_edge_emb of a split head included: a pass of
    several launches rounds it once, in its one demb product (ROADMAP
    C17).

And the f64 reference of the card's gradient checks (ROADMAP C14):

  * MaskedBatchNorm keeps f64 rows in f64: its batch moments (equal to
    numpy's f64 weighted moments within 1e-12) and its output;
  * its f32 and bf16 results, running statistics and folded affine stay
    bit for bit those of the f32-moment arithmetic, a copy of which is
    written out here;
  * QAGNNMessagePassing on the scatter path built in f64 (k = 2, D = 64, 4
    heads, train mode) gives every parameter gradient within 1e-5 of the
    largest of the f32 scatter path's: the same function, in f64.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
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
from qagnn_tpu_torch.models.gnn import QAGNNMessagePassing
from qagnn_tpu_torch.models.norm import MaskedBatchNorm, MomentPart
from qagnn_tpu_torch.ops import gat_kernels as gk
from qagnn_tpu_torch.utils.initialization import init_weights

CSRC = Path(__file__).resolve().parents[1] / "qagnn_tpu_torch" / "csrc"
TC_COMMON = (CSRC / "gat_tc_common.cuh").read_text()
BWD_TC = (CSRC / "gat_bwd_tc.cuh").read_text()


# --------------------------------------------------------------------------
# the decision and the plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("route,D,want", [
    (1, 264, torch.bfloat16), (1, 512, torch.bfloat16),
    (1, 1040, torch.bfloat16), (1, 256, None), (1, 200, None),
    (0, 512, None), (0, 256, None)])
def test_backward_streams_past_256_only(route, D, want):
    """Route 1 past D = 256 reads W rounded to bf16 from device memory and
    streams it; route 0 and the resident kernel round W themselves."""
    assert gk._bwd_streams(D) == (D > 256)
    w = torch.randn(D, 64)
    got = gk._streamed_w(route, w, gk._bwd_streams)
    if want is None:
        assert got is None
    else:
        assert got.dtype == want and torch.equal(got, w.to(want))


def _function_body(text, name):
    return re.search(name + r"\([^)]*\)\s*\{(.*?)\n\}", text, re.S).group(1)


def _cuda_bwd_stream_tile(HD):
    """(columns, warps) of the tile the backward kernel instantiates for
    HD: `tc_stream_pairs`' ladder of widths (gat_tc_common.cuh) with
    `tc_bwd_stream_pairs`' floor, and `tc_bwd_stream_warps`' limit
    (gat_bwd_tc.cuh)."""
    body = _function_body(TC_COMMON, "tc_stream_pairs")
    rungs = [(int(a), int(b)) for a, b in
             re.findall(r"HD <= (\d+) \? (\d+)", body)]
    last = int(re.search(r": (\d+);", body).group(1))
    pairs = next((p for top, p in rungs if HD <= top), last)
    body = _function_body(BWD_TC, "tc_bwd_stream_pairs")
    below, floor = re.search(r"pairs < (\d+) \? (\d+) : pairs;",
                             body).groups()
    pairs = int(floor) if pairs < int(below) else pairs
    body = _function_body(BWD_TC, "tc_bwd_stream_warps")
    most, many, few = re.search(r"pairs <= (\d+) \? (\d+) : (\w+);",
                                body).groups()
    if not few.isdigit():
        few = re.search(rf"constexpr int {few} = (\d+);", TC_COMMON).group(1)
    return 16 * pairs, int(many) if pairs <= int(most) else int(few)


@pytest.mark.parametrize("HD", [8, 64, 72, 128, 136, 144, 152, 208, 216,
                                256])
def test_backward_stream_tiles_match_the_kernel(HD):
    """BWD_STREAM_TILES is the table the kernel compiles, and TC_KC and
    TC_STAGES, which size its ring, are the kernel's."""
    assert gk._bwd_stream_tile(HD) == _cuda_bwd_stream_tile(HD)
    for name in ("TC_KC", "TC_STAGES", "TC_MAX_WARPS"):
        assert int(re.search(rf"constexpr int {name} = (\d+);", TC_COMMON)
                   .group(1)) == getattr(gk, name)


def test_the_launch_instantiates_every_streamed_tile():
    """`launch_pass_tc`'s streaming switch has a case for each tile width
    of the plan, and the resident one none of the streaming widths it
    does not compile."""
    body = _function_body(BWD_TC, r"int launch_pass_tc")
    streamed = {int(p) for p in
                re.findall(r"launch_edge_tc<PASS, (\d+), true>", body)}
    resident = {int(p) for p in
                re.findall(r"launch_edge_tc<PASS, (\d+), false>", body)}
    assert streamed == {w // 16 for w, _ in gk.BWD_STREAM_TILES}
    assert resident == {4, 8, 13, 16}
    assert "tc_bwd_stream_pairs(a.HD)" in body


@pytest.mark.parametrize("D", [264, 512, 520, 1040, 2048])
def test_every_streamed_plan_fits(D):
    """At every launch width HD (8 to 256 by 8), the streaming kernel's
    plan leaves room for at least one warp and no more than the tile's
    most, as many as shared memory holds, one persistent block an SM."""
    for HD in range(8, 257, 8):
        warps, n_blocks = gk._tc_plan(64, 4096, D, HD, 132)
        most = gk._bwd_stream_tile(HD)[1]
        assert 1 <= warps <= most and n_blocks == 132, (D, HD)
        assert gk._tc_smem_bytes(D, HD, warps) <= gk.TC_SMEM_LIMIT
        if warps < most:
            assert gk._tc_smem_bytes(D, HD, warps + 1) > gk.TC_SMEM_LIMIT
        assert gk._split_scratch(64, 4096, D, HD, "cpu", route=1,
                                 n_sm=132)[1:3] == (warps, n_blocks)


# --------------------------------------------------------------------------
# the passes against the JAX package
# --------------------------------------------------------------------------

# (seed, G, N, E, HD, D, mask kind), heads: D past 256, E = 13; HD = 264
# with one head is a head split over two column launches (128 + 136)
CASES = {
    "d264": ((5, 2, 8, 13, 16, 264, "masked25"), 2),
    "d264_split_head": ((6, 2, 8, 13, 264, 264, "one_graph_empty"), 1),
    "d520": ((7, 2, 8, 13, 40, 520, "one_graph_empty"), 4),
    "d520_split_head": ((8, 2, 8, 13, 264, 520, "masked25"), 1),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_backward_passes_match_pallas(case, dtype):
    shape, heads = CASES[case]
    assert gk._bwd_streams(shape[5])
    split = passes_match_pallas(shape, heads, dtype)
    assert split == case.endswith("split_head")


def passes_match_pallas(shape, heads, dtype):
    """Both backward passes through their wrappers at `shape` ((seed, G, N,
    E, HD, D, mask kind) of `_inputs`), with a carry, against the JAX
    package's passes in interpret mode; the tolerances of this file's head
    note. Returns whether a head runs in column launches."""
    a = _inputs(*shape)
    HD = a["nq"].shape[-1]
    # the query as the op takes it, W_q x / sqrt(features a head): unscaled,
    # a 264-feature head scores at +-90, where f32 sums in another order
    # alone move dnq by 8e-5 of its largest
    a["nq"] = (a["nq"] / np.sqrt(HD // heads)).astype(np.float32)
    split = len(gk.launches(HD, heads)) > 1
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
    want2 = _proj_bwd_pass2(
        j["nq"], j["nk"], emb_t, j["w_ke"], j["b_ke"], scores, gmax, dalpha,
        scale, d_denom, j["src"], j["dst"], jmask, demb_m, heads, True,
        self_terms=(dnq_self, dnk_self))

    t = {k: _torch(v, tdt if k in CDT_NAMES else None) for k, v in a.items()}
    f = {k: _torch(_np(v)) for k, v in dict(
        scores=scores, gmax=gmax, scale=scale, d_denom=d_denom,
        dalpha=dalpha, dnm=d_msg_self,
        dscale=d_alpha_self * e_self, dnq=dnq_self, dnk=dnk_self).items()}
    got1 = gk.bwd_pass1(
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
    dead = ~t["mask"]
    assert torch.equal(got1[0][dead], _torch(a["carry"], tdt)[dead])
    got2 = gk.bwd_pass2(
        t["nq"], t["nk"], t["edge_emb"], t["w_ke"], t["b_ke"], f["scores"],
        f["gmax"], f["dalpha"], f["scale"], f["d_denom"], t["src"],
        t["dst"], t["mask"], _torch(_np(jnp.swapaxes(demb_m, 1, 2)), tdt),
        f["dnq"], f["dnk"], heads)
    demb2, dnq, dnk, dw_ke, db_ke = want2
    want2 = (jnp.swapaxes(demb2, 1, 2), dnq, dnk, dw_ke, db_ke.reshape(-1))
    for name, x, y in zip(("demb", "dnq", "dnk", "dW_ke", "db_ke"), got2,
                          want2):
        _close(x, y, PASS_TOL, f"pass 2 {name}")
    return split


# --------------------------------------------------------------------------
# the f64 reference (ROADMAP C14)
# --------------------------------------------------------------------------

FEAT = 12


def _bn_inputs(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x1 = torch.from_numpy(rng.standard_normal((20, FEAT)) * 2 + 0.5)
    x2 = torch.from_numpy(rng.standard_normal((7, FEAT)))
    w1 = torch.from_numpy((rng.random(20) > 0.3).astype(np.float32))
    bn = MaskedBatchNorm(FEAT, num_updates=3)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, FEAT)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(FEAT)))
        bn.mean.copy_(torch.from_numpy(rng.standard_normal(FEAT)))
        bn.var.copy_(torch.from_numpy(rng.uniform(0.3, 3.0, FEAT)))
    moment = MomentPart(torch.from_numpy(rng.standard_normal(FEAT) * 5)
                        .float(),
                        torch.from_numpy(rng.uniform(40, 60, FEAT)).float(),
                        torch.tensor(9.0))
    return bn, x1.to(dtype), x2.to(dtype), w1, moment


def test_batchnorm_keeps_f64_rows_in_f64():
    bn, x1, x2, w1, _ = _bn_inputs(torch.float64)
    mean, var, n = bn.train()._batch_stats([(x1, w1), (x2, None)], [])
    assert mean.dtype == var.dtype == n.dtype == torch.float64
    rows = np.concatenate([x1.numpy(), x2.numpy()])
    w = np.concatenate([w1.numpy().astype(np.float64), np.ones(7)])
    want_mean = (rows * w[:, None]).sum(0) / w.sum()
    want_var = (np.square(rows - want_mean) * w[:, None]).sum(0) / w.sum()
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=0, atol=1e-12)
    np.testing.assert_allclose(var.numpy(), want_var, rtol=0, atol=1e-12)
    outs, (a, b) = bn([(x1, w1), (x2, None)], return_affine=True)
    assert all(o.dtype == torch.float64 for o in outs)
    assert a.dtype == b.dtype == torch.float64
    assert bn.mean.dtype == bn.var.dtype == torch.float32
    want = (x1 - mean) * torch.rsqrt(var + bn.eps) * bn.scale.double() \
        + bn.bias.double()
    torch.testing.assert_close(outs[0], want, rtol=0, atol=1e-12)


def _f32_moment_reference(bn, array_parts, moment_parts):
    """MaskedBatchNorm's batch statistics as the f32-moment arithmetic took
    them, written out: what f32 and bf16 rows must still get bit for bit."""
    f32 = torch.float32
    n = torch.zeros((), dtype=f32)
    s1 = torch.zeros(bn.features, dtype=f32)
    for xi, wi in array_parts:
        x32 = xi.float()
        if wi is None:
            n = n + x32.shape[0]
            s1 = s1 + x32.sum(0)
        else:
            w = wi.float()
            n = n + w.sum()
            s1 = s1 + (x32 * w[:, None]).sum(0)
    for mp in moment_parts:
        n = n + mp.n
        s1 = s1 + mp.s1
    n = torch.clamp_min(n, 1.0)
    mean = s1 / n
    s2 = torch.zeros(bn.features, dtype=f32)
    for xi, wi in array_parts:
        d2 = torch.square(xi.float()) if moment_parts \
            else torch.square(xi.float() - mean)
        s2 = s2 + (d2.sum(0) if wi is None
                   else (d2 * wi.float()[:, None]).sum(0))
    if moment_parts:
        for mp in moment_parts:
            s2 = s2 + mp.s2
        var = torch.clamp_min(s2 / n - torch.square(mean), 0.0)
    else:
        var = s2 / n
    return mean, var, n


def _f32_moment_forward(bn, parts, training):
    """Outputs, folded affine and running statistics as the f32-moment
    arithmetic gave them."""
    moment_parts = [p for p in parts if isinstance(p, MomentPart)]
    array_parts = [p for p in parts if not isinstance(p, MomentPart)]
    run_mean, run_var = bn.mean.clone(), bn.var.clone()
    if training:
        mean, var, n = _f32_moment_reference(bn, array_parts, moment_parts)
        unbiased = var * n / torch.clamp_min(n - 1.0, 1.0)
        decay = (1.0 - bn.momentum) ** bn.num_updates
        run_mean.mul_(decay).add_((1.0 - decay) * mean)
        run_var.mul_(decay).add_((1.0 - decay) * unbiased)
    else:
        mean, var = run_mean, run_var
    inv = torch.rsqrt(var + bn.eps)

    def norm(xi):
        if xi.dtype == torch.float32:
            return (xi - mean) * inv * bn.scale + bn.bias
        a = (inv * bn.scale).to(xi.dtype)
        b = (bn.bias - mean * inv * bn.scale).to(xi.dtype)
        return xi * a + b

    outs = [None if isinstance(p, MomentPart) else norm(p[0]) for p in parts]
    a32 = inv * bn.scale
    return outs, (a32, bn.bias - mean * a32), run_mean, run_var


@pytest.mark.parametrize("mode", ["train", "train_moments", "eval"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_f32_and_bf16_unchanged(dtype, mode):
    bn, x1, x2, w1, moment = _bn_inputs(dtype)
    parts = [(x1, w1), (x2, None)]
    if mode == "train_moments":
        parts.insert(0, moment)
    bn.train(mode != "eval")
    with torch.no_grad():
        want_outs, want_affine, want_mean, want_var = _f32_moment_forward(
            bn, parts, mode != "eval")
        outs, affine = bn(parts, return_affine=True)
    for got, want in zip(outs, want_outs):
        assert (got is None) == (want is None)
        if got is not None:
            assert got.dtype == dtype and torch.equal(got, want)
    for got, want in zip(affine, want_affine):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(bn.mean, want_mean) and torch.equal(bn.var, want_var)


def _message_passing_grads(dtype):
    """Parameter gradients of a train-mode forward + backward of
    QAGNNMessagePassing on the scatter path at k = 2, D = 64, 4 heads, in
    compute dtype `dtype`, weights and inputs from fixed seeds (H in f32
    either way)."""
    G, N, E, D, n_ntype, n_etype = 2, 8, 13, 64, 4, 5
    mp = QAGNNMessagePassing(2, n_ntype, n_etype, D, dropout=0.0,
                             head_count=4, backend="scatter", dtype=dtype)
    init_weights(mp, torch.Generator().manual_seed(0), 0.02)
    rng = np.random.default_rng(1)
    H = torch.from_numpy(rng.standard_normal((G, N, D)).astype(np.float32))
    args = (torch.from_numpy(rng.integers(0, n_ntype, (G, N))),
            torch.from_numpy(rng.random((G, N)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, N, (G, E))),
            torch.from_numpy(rng.integers(0, N, (G, E))),
            torch.from_numpy(rng.integers(0, n_etype + 1, (G, E))),
            torch.from_numpy(rng.random((G, E)) > 0.25))
    cot = torch.from_numpy(rng.standard_normal((G, N, D)).astype(np.float32))
    out = mp.train()(H, *args)
    assert out.dtype == dtype
    (out.float() * cot).sum().backward()
    return {n: p.grad.double() for n, p in mp.named_parameters()
            if p.grad is not None}


def test_f64_scatter_path_matches_f32():
    g64 = _message_passing_grads(torch.float64)
    g32 = _message_passing_grads(torch.float32)
    assert sorted(g64) == sorted(g32)
    top = max(float(g.abs().max()) for g in g64.values())
    gap = max(float((g32[n] - g).abs().max()) for n, g in g64.items())
    assert 0 < gap <= 1e-5 * top, (gap, top)
