"""Forward passes A and C in float32 on tensor cores (CPU).

In float32 `gat_pass_a_scores` / `gat_pass_c` run the per-edge projection
emb W on the tf32 tensor cores as split-TF32 products (csrc/mma_tile.cuh:
hi = tf32(x), lo = x - hi, a_lo b_hi + a_hi b_lo + a_hi b_hi in f32) in
the streaming kernel at every D (csrc/gat_fwd_tc.cuh, `fwd_pass_tc_kernel<
PASS, PAIRS, true, float>` on `TcStream32Shape`), handed W itself in f32.
The kernels run only on the card; here, with the Python that a CPU run
reaches:

  * the route rule: tensor cores in float32 by default, route 0 when
    named, refused past the route's widths;
  * the f32 plan within the shared memory a block may ask for, with 8
    warps a block, at every (D, HD) launch that chip_smoke.py runs, and
    its tile table against the constants the kernel is compiled with,
    parsed from csrc;
  * the W the wrappers hand the C entry points on route 1: f32 W itself,
    the same storage as w_ke / w_me, never rounded to bf16 (the wrappers
    driven to their launch with a CPU tensor that reports itself on the
    card and a stand-in for the library);
  * both passes through their f32 wrappers (the plain versions on CPU
    tensors, with the head groups and column launches the kernels take)
    against the JAX package's `_proj_pass_a` / `_proj_pass_c` in interpret
    mode, at the preset's D = 200 and at D = 1040, each with a head wider
    than a launch, to 1e-6 of max|want|.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bwd_f32_route import _card, _Lib
from test_torch_gat_backward import (  # noqa: F401  (fixture by name)
    CDT_NAMES,
    PASS_TOL,
    _close,
    _inputs,
    _np,
    _one_torch_thread,
    _torch,
)

from qagnn_tpu.ops.pallas_gat import _proj_fwd_impl, _proj_pass_a, _proj_pass_c
from qagnn_tpu_torch.ops import _build
from qagnn_tpu_torch.ops import gat_kernels as gk

CSRC = Path(__file__).resolve().parents[1] / "qagnn_tpu_torch" / "csrc"
TC_COMMON = (CSRC / "gat_tc_common.cuh").read_text()
FWD_TC = (CSRC / "gat_fwd_tc.cuh").read_text()
F32 = torch.float32


# --------------------------------------------------------------------------
# the route and the plan
# --------------------------------------------------------------------------

@pytest.mark.parametrize("D,HD,heads", [(200, 200, 4), (24, 40, 4),
                                        (256, 256, 8), (1040, 136, 1),
                                        (512, 256, 2)])
def test_float32_takes_the_tensor_core_route(D, HD, heads):
    assert gk._fwd_route(F32, D, HD, heads, None) == 1
    assert gk._fwd_route(F32, D, HD, heads, 1) == 1
    assert gk._fwd_route(F32, D, HD, heads, 0) == 0
    assert gk._fwd_streams(D, F32)


@pytest.mark.parametrize("D,HD,heads,route", [
    (200, 16, 8, None), (200, 264, 1, None), (200, 200, 4, 2)])
def test_float32_route_one_is_refused_past_its_widths(D, HD, heads, route):
    """Heads of fewer than 4 features or more than 256 columns a launch
    stay on CUDA cores by default and are refused route 1; no third
    route."""
    if route is None:
        assert gk._fwd_route(F32, D, HD, heads, None) == 0
        route = 1
    with pytest.raises(ValueError):
        gk._fwd_route(F32, D, HD, heads, route)


def _chip_smoke_widths():
    """(D, HD) of every launch of passes A and C in chip_smoke.py: the
    forward phase's widths (FWD_WIDTHS, the preset's first), the OBQA
    preset's (train, grads, mesh), and gnn_dim 512 and 1040 in the widths
    phase, a launch a head group or column slice."""
    widths = {(200, 200), (24, 40), (96, 128), (256, 256), (264, 200),
              (520, 64), (1040, 136)}
    for gnn_dim in (512, 1040):
        D, HD = gk.kernel_widths(gnn_dim, gnn_dim, 4)
        widths |= {(D, c1 - c0) for _, _, c0, c1 in gk.launches(HD, 4)}
    return sorted(widths)


@pytest.mark.parametrize("D,HD", _chip_smoke_widths())
@pytest.mark.parametrize("E", [4096, 4093, 1024])
def test_f32_plan_fits_with_eight_warps(D, HD, E):
    """One persistent block an SM of 8 warps, the ring of W's f32 chunks
    and the warps' stages within what a block may ask for, at every D."""
    warps, n_blocks = gk._fwd_tc_plan(64, E, D, HD, 132, F32)
    assert warps == 8 and n_blocks == 132
    assert gk._fwd_smem_bytes(D, HD, warps, F32) <= gk.TC_SMEM_LIMIT
    assert gk._fwd_max_warps(D, HD, F32) == 8


def test_f32_plan_at_the_widest_tile():
    """256 columns: the ring of two 32-row chunks (2 x 32 x 264 floats,
    67,584 bytes) and 8 stages of 16 f32 rows of 260 with the forward's
    tables (160 floats), 205,824 bytes in all; a ninth warp would fit, but
    the kernel is compiled for 8."""
    assert gk._fwd_smem_bytes(512, 256, 8, F32) == 205_824
    assert gk._fwd_smem_bytes(512, 256, 9, F32) <= gk.TC_SMEM_LIMIT
    assert gk._fwd_tc_plan(64, 4096, 512, 256, 132, F32) == (8, 132)


def _body(text, name):
    return re.search(name + r"\([^)]*\)\s*\{(.*?)\n\}", text, re.S).group(1)


def test_f32_tiles_match_the_kernel():
    """STREAM32_TILES is what the forward kernel compiles in f32: the
    streaming kernel's ladder of widths (`tc_stream_pairs`), one case of
    `launch_fwd_stream` each, TC_MAX_WARPS a block for f32
    (`tc_fwd_max_warps`), and TC_KC32 rows a chunk."""
    body = _body(TC_COMMON, "tc_stream_pairs")
    pairs = [int(p) for p in re.findall(r"\? (\d+)", body)] \
        + [int(re.search(r": (\d+);", body).group(1))]
    assert [w for w, _ in gk.STREAM32_TILES] == [16 * p for p in pairs]
    cases = re.findall(r"launch_fwd_shape<PASS, (\d+), true>",
                       _body(FWD_TC, "int launch_fwd_stream"))
    assert sorted(int(p) for p in cases) == pairs
    assert re.search(r"return f32 \|\| !stream \? TC_MAX_WARPS",
                     _body(FWD_TC, "constexpr int tc_fwd_max_warps"))
    assert {w for _, w in gk.STREAM32_TILES} == {gk.TC_MAX_WARPS}
    assert int(re.search(r"constexpr int TC_KC32 = (\d+);", TC_COMMON)
               .group(1)) == gk.TC_KC32
    for HD in range(8, 257, 8):
        width = gk._stream_tile(HD, F32)[0]
        assert width == 16 * next(p for p in pairs if HD <= 16 * p)


# --------------------------------------------------------------------------
# the W the wrappers hand the kernels
# --------------------------------------------------------------------------

# the positions of W, the streamed W, the dtype code, the route, warps and
# blocks among each C entry point's arguments
ARGS_AT = {"gat_pass_a_scores": (3, 4, 17, 18, 19, 20),
           "gat_pass_c": (2, 3, 18, 19, 20, 21)}


@pytest.mark.parametrize("cdt,D", [(F32, 200), (F32, 512),
                                   (torch.bfloat16, 512),
                                   (torch.bfloat16, 200)])
def test_wrappers_hand_the_kernels_w_unrounded_in_f32(monkeypatch, cdt, D):
    G, N, E, HD, heads = 2, 8, 13, 64, 4
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    lib = _Lib()
    handed = []
    streamed_w = gk._streamed_w

    def spy(*a, **k):
        handed.append(streamed_w(*a, **k))
        return handed[-1]
    monkeypatch.setattr(gk, "_lib", lambda: lib)
    monkeypatch.setattr(gk, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(gk, "_stream", lambda: 0)
    monkeypatch.setattr(gk, "_streamed_w", spy)
    nq, nk, nm = (_card(r(G, N, HD).to(cdt)) for _ in range(3))
    emb = _card(r(G, E, D).to(cdt))
    w_ke, w_me = _card(r(D, HD)), _card(r(D, HD))
    b = _card(r(HD))
    idx = lambda: _card(torch.randint(0, N, (G, E), generator=gen,  # noqa
                                      dtype=torch.int32))
    src, dst = idx(), idx()
    mask = _card(torch.rand((G, E), generator=gen) > 0.25)
    scores, gmax = _card(r(G, heads, E)), _card(r(G, heads))
    scale, out = _card(r(G, N, heads)), _card(r(G, N, HD))
    try:
        gk.pass_a_scores(nq, nk, emb, w_ke, b, src, dst, mask, heads)
        gk.pass_c(nm, emb, w_me, b, scores, gmax, scale, src, dst, mask,
                  out, heads)
    finally:
        _build.reset_launch_counts()
    assert [name for name, _ in lib.calls] == ["gat_pass_a_scores",
                                               "gat_pass_c"]
    for (name, args), w, ws in zip(lib.calls, (w_ke, w_me), handed):
        w_at, ws_at, dtype_at, route_at, warps_at, blocks_at = ARGS_AT[name]
        assert args[dtype_at] == gk._dtype_code(nq)
        assert args[route_at] == 1
        assert (args[warps_at], args[blocks_at]) == \
            gk._fwd_tc_plan(G, E, D, HD, 132, cdt)
        if cdt == F32:
            # W itself (pass A's launch takes a column view of it): the
            # same storage, f32, never rounded
            assert ws.dtype == F32 and torch.equal(ws, w)
            assert ws.untyped_storage().data_ptr() \
                == w.untyped_storage().data_ptr()
            assert args[ws_at] == args[w_at] == w.data_ptr()
        elif D > 256:
            assert ws.dtype == torch.bfloat16
            assert torch.equal(ws, w.to(torch.bfloat16))
            assert args[ws_at] == ws.data_ptr() != args[w_at]
        else:
            assert ws is None and args[ws_at] is None


# --------------------------------------------------------------------------
# the f32 passes against the JAX package
# --------------------------------------------------------------------------

# (seed, G, N, E, HD, D, mask kind), heads: one head of 264 features (two
# column launches, 128 + 136) at the preset's D = 200; two heads of 264 at
# D = 1040, the widths phase's gnn_dim
F32_CASES = {
    "d200_split_head": ((21, 2, 8, 13, 264, 200, "masked25"), 1),
    "d1040_split_heads": ((22, 2, 8, 13, 528, 1040, "one_graph_empty"), 2),
}


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_f32_passes_match_pallas(case):
    """Pass A's scores (0 at masked slots, which the TPU kernel leaves as
    computed and nothing reads) and its max over masked slots (NEG for a
    graph with none), and pass C's sum on the JAX forward's own scores,
    max and scale, through the f32 wrappers, each within 1e-6 of
    max|want|; masked slots score exactly 0."""
    shape, heads = F32_CASES[case]
    a = _inputs(*shape)
    HD, D = a["nq"].shape[-1], a["edge_emb"].shape[-1]
    assert gk._fwd_route(F32, D, 256, 1, None) == 1 and gk._fwd_streams(D, F32)
    assert len(gk.launches(HD, heads)) > 1
    # the query as the op takes it, W_q x / sqrt(features a head)
    a["nq"] = (a["nq"] / np.sqrt(HD // heads)).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    emb_t = jnp.swapaxes(j["edge_emb"], 1, 2)                # (G, D, E)
    jmask = j["mask"].astype(jnp.float32)
    scores, m, _, _ = _proj_pass_a(j["nq"], j["nk"], emb_t, j["w_ke"],
                                   j["b_ke"], j["src"], j["dst"], jmask,
                                   heads, True)
    t = {k: _torch(v, F32 if k in CDT_NAMES else None) for k, v in a.items()}
    got_s, got_m = gk.pass_a_scores(t["nq"], t["nk"], t["edge_emb"],
                                    t["w_ke"], t["b_ke"], t["src"], t["dst"],
                                    t["mask"], heads)
    _close(got_s, scores * jmask[:, None, :], PASS_TOL, "pass A scores")
    _close(got_m, m[..., 0], PASS_TOL, "pass A max")
    dead = ~t["mask"]
    assert bool((got_s.transpose(1, 2)[dead] == 0).all())
    assert bool((got_m[~t["mask"].any(1)] == gk.NEG).all())

    _, scores, gmax, _, scale, _, _ = _proj_fwd_impl(
        j["nq"], j["nk"], j["nm"], emb_t, j["w_ke"], j["b_ke"], j["w_me"],
        j["b_me"], j["skb"], j["smb"], j["src"], j["dst"], jmask, heads,
        True)
    want = _proj_pass_c(j["nm"], emb_t, j["w_me"], j["b_me"], scores, gmax,
                        scale, j["src"], j["dst"], jmask, heads, True)
    f = {k: _torch(_np(v)) for k, v in dict(scores=scores, gmax=gmax,
                                            scale=scale).items()}
    G, N = a["nm"].shape[:2]
    got = gk.pass_c(t["nm"], t["edge_emb"], t["w_me"], t["b_me"],
                    f["scores"], f["gmax"], f["scale"], t["src"], t["dst"],
                    t["mask"], torch.zeros((G, N, HD)), heads)
    _close(got, want, PASS_TOL, "pass C out")
