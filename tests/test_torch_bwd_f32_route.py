"""Backward passes 1 and 2 in float32 on tensor cores (CPU).

In float32 `gat_bwd_pass1` / `gat_bwd_pass2` run their three products on
the tf32 tensor cores as split-TF32 products (csrc/mma_tile.cuh: hi =
tf32(x), lo = tf32(x - hi), a_lo b_hi + a_hi b_lo + a_hi b_hi in f32) in
the streaming edge kernel at every D (csrc/gat_bwd_tc.cuh,
`TcStream32Shape`), handed W itself in f32. The kernels run only on the
card; here, with the Python that a CPU run reaches:

  * the route rule: tensor cores in float32 by default, route 0 when
    named;
  * the f32 plan within the shared memory a block may ask for, with 8
    warps a block, at every (D, HD) launch that chip_smoke.py runs, and
    its tile table against the constants the kernel is compiled with,
    parsed from csrc;
  * the W the wrappers hand the C entry points on route 1: f32 W itself,
    the same storage as w_me / w_ke, never rounded to bf16 (the wrappers
    driven to their launch with a CPU tensor that reports itself on the
    card and a stand-in for the library);
  * both passes through their f32 wrappers (the plain versions on CPU
    tensors, with the head groups and column launches the kernels take)
    against the JAX package's passes in interpret mode, at the preset's D
    = 200 and at D = 1040, each with heads wider than a launch, to 1e-6 of
    max|want| (tests/test_torch_bwd_streamed.py's tolerance).
"""

import re
from pathlib import Path

import pytest
import torch
from test_torch_bwd_streamed import passes_match_pallas
from test_torch_gat_backward import _one_torch_thread  # noqa: F401

from qagnn_tpu_torch.ops import _build
from qagnn_tpu_torch.ops import gat_kernels as gk

CSRC = Path(__file__).resolve().parents[1] / "qagnn_tpu_torch" / "csrc"
TC_COMMON = (CSRC / "gat_tc_common.cuh").read_text()
BWD_TC = (CSRC / "gat_bwd_tc.cuh").read_text()
F32 = torch.float32


# --------------------------------------------------------------------------
# the route and the plan
# --------------------------------------------------------------------------

def test_float32_takes_the_tensor_core_route():
    assert gk._bwd_route(F32, None) == 1
    assert gk._bwd_route(F32, 0) == 0
    assert gk._bwd_route(F32, 1) == 1
    with pytest.raises(ValueError):
        gk._bwd_route(F32, 2)


def _chip_smoke_widths():
    """(D, HD) of every launch of backward passes 1 and 2 in chip_smoke.py:
    the kernel phase's widths, the OBQA preset's (train, grads, mesh), and
    gnn_dim 512 and 1040 in the widths phase, a launch a head group or
    column slice."""
    widths = {(200, 200), (24, 40), (96, 128), (256, 256), (264, 200),
              (520, 64)}
    for gnn_dim in (512, 1040):
        D, HD = gk.kernel_widths(gnn_dim, gnn_dim, 4)
        widths |= {(D, c1 - c0) for _, _, c0, c1 in gk.launches(HD, 4)}
    return sorted(widths)


@pytest.mark.parametrize("D,HD", _chip_smoke_widths())
@pytest.mark.parametrize("E", [4096, 4093, 2048, 1024])
def test_f32_plan_fits_with_eight_warps(D, HD, E):
    """One persistent block an SM of 8 warps, the ring of W's f32 chunks
    and their stages within what a block may ask for, streamed at every D,
    and the partial arrays sized from that plan."""
    assert gk._bwd_streams(D, F32)
    warps, n_blocks = gk._tc_plan(64, E, D, HD, 132, F32)
    assert warps == 8 and n_blocks == 132
    assert gk._tc_smem_bytes(D, HD, warps, F32) <= gk.TC_SMEM_LIMIT
    got = gk._split_scratch(64, E, D, HD, "cpu", route=1, n_sm=132, cdt=F32)
    assert got[:3] == (0, 8, 132)
    assert got[3] is None and got[4].shape == (132, HD)


def test_f32_plan_at_the_widest_tile():
    """256 columns: the ring of two 32-row chunks (67,584 bytes) and 8
    stages of 16 f32 rows with their tables, 214,016 bytes in all."""
    assert gk._tc_smem_bytes(512, 256, 8, F32) == 214_016
    assert gk._tc_smem_bytes(512, 256, 9, F32) <= gk.TC_SMEM_LIMIT


def _body(text, name):
    return re.search(name + r"\([^)]*\)\s*\{(.*?)\n\}", text, re.S).group(1)


def test_f32_tiles_match_the_kernel():
    """STREAM32_TILES is what the kernel compiles: the forward
    streaming kernel's ladder of widths (`tc_stream_pairs`), one case of
    `launch_edge_f32` each, TC_MAX_WARPS a block for f32
    (`tc_bwd_max_warps`), and TC_KC32 rows a chunk."""
    body = _body(TC_COMMON, "tc_stream_pairs")
    pairs = [int(p) for p in re.findall(r"\? (\d+)", body)] \
        + [int(re.search(r": (\d+);", body).group(1))]
    assert [w for w, _ in gk.STREAM32_TILES] == [16 * p for p in pairs]
    cases = re.findall(r"launch_edge_tc<PASS, (\d+), true>",
                       _body(BWD_TC, "cudaError_t launch_edge_f32"))
    assert sorted(int(p) for p in cases) == pairs
    assert re.search(r"return f32 \|\| !stream \? TC_MAX_WARPS",
                     _body(BWD_TC, "constexpr int tc_bwd_max_warps"))
    assert {w for _, w in gk.STREAM32_TILES} == {gk.TC_MAX_WARPS}
    assert int(re.search(r"constexpr int TC_KC32 = (\d+);", TC_COMMON)
               .group(1)) == gk.TC_KC32
    for HD in range(8, 257, 8):
        width = gk._bwd_stream_tile(HD, F32)[0]
        assert width == 16 * next(p for p in pairs if HD <= 16 * p)


# --------------------------------------------------------------------------
# the W the wrappers hand the kernels
# --------------------------------------------------------------------------

@pytest.mark.parametrize("D", [24, 200, 256, 264, 1040])
def test_streamed_w_is_w_itself_in_f32(D):
    w = torch.randn(D, 64)
    got = gk._streamed_w(1, w, gk._bwd_streams, F32)
    assert got is w and got.dtype == F32
    assert gk._streamed_w(0, w, gk._bwd_streams, F32) is None
    bf16 = gk._streamed_w(1, w, gk._bwd_streams, torch.bfloat16)
    assert (bf16 is None) == (D <= 256)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card: it takes a wrapper
    down to its launch, where `_Lib` stands in for the library."""

    @property
    def is_cuda(self):
        return True


class _Lib:
    """Records each entry point's arguments; every launch succeeds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


def _card(t):
    return t.contiguous().as_subclass(_OnCard)


# the positions of w_me / w_ke, the streamed W, the dtype code, the route,
# warps and blocks among the C entry points' arguments; route 2's
# (csrc/gat_edge.cu `gat_edge_tc`): W rounded to bf16, and its plan (nb,
# stream, hp, stages, tables, blocks)
W_AT, WS_AT, DTYPE_AT, ROUTE_AT, WARPS_AT, BLOCKS_AT = 3, 22, 31, 32, 33, 34
EDGE_W_AT, EDGE_PLAN_AT = 3, slice(31, 37)


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
    monkeypatch.setattr(gk, "_bwd_lib", lambda: lib)
    monkeypatch.setattr(gk, "_dw_lib", lambda: lib)
    monkeypatch.setattr(gk, "_edge_lib", lambda: lib)
    monkeypatch.setattr(gk, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(gk, "_stream", lambda: 0)
    monkeypatch.setattr(gk, "_streamed_w", spy)
    nodes = [_card(r(G, N, HD).to(cdt)) for _ in range(4)]
    emb = _card(r(G, E, D).to(cdt))
    w_me, w_ke = _card(r(D, HD)), _card(r(D, HD))
    b = _card(r(HD))
    idx = lambda: _card(torch.randint(0, N, (G, E), generator=gen,  # noqa
                                      dtype=torch.int32))
    src, dst = idx(), idx()
    mask = _card(torch.rand((G, E), generator=gen) > 0.25)
    scores, gmax = _card(r(G, heads, E)), _card(r(G, heads))
    per_node = [_card(r(G, N, heads)) for _ in range(3)]
    acc = [_card(r(G, N, HD)) for _ in range(3)]
    try:
        gk.bwd_pass1(nodes[0], nodes[1], emb, w_me, b, scores, gmax,
                     per_node[0], src, dst, mask, None, acc[0], per_node[1],
                     heads)
        gk.bwd_pass2(nodes[2], nodes[3], emb, w_ke, b, scores, gmax,
                     _card(r(G, heads, E)), per_node[0], per_node[2], src,
                     dst, mask, _card(r(G, E, D).to(cdt)), acc[1], acc[2],
                     heads)
    finally:
        _build.reset_launch_counts()
    # bf16 up to D = 256: the route the rule gives a launch with product 2
    # (route 2: the wgmma edge kernel, csrc/gat_edge.cu)
    edge = gk._edge_route(cdt, None, D, True) == 2
    passes = ["gat_edge_tc"] * 2 if edge else ["gat_bwd_pass1",
                                               "gat_bwd_pass2"]
    assert [name for name, _ in lib.calls] == [passes[0], "gat_dw_tc",
                                               passes[1], "gat_dw_tc"]
    for (_, args), w, ws in zip(lib.calls[::2], (w_me, w_ke), handed):
        if edge:
            # W rounded to bf16 once a call, and the launch's plan
            assert ws.dtype == torch.bfloat16
            assert torch.equal(ws, w.to(torch.bfloat16))
            assert args[EDGE_W_AT] == ws.data_ptr() != w.data_ptr()
            p = gk.edge_plan(G, E, D, HD, heads, 132)
            assert args[EDGE_PLAN_AT] == (p.nb, int(p.stream), p.hp,
                                          p.stages, p.tables, p.blocks)
            continue
        assert args[DTYPE_AT] == gk._dtype_code(nodes[0])
        assert args[ROUTE_AT] == 1
        assert (args[WARPS_AT], args[BLOCKS_AT]) == \
            gk._tc_plan(G, E, D, HD, 132, cdt)
        if cdt == F32:
            # W itself: the same storage, f32, never rounded
            assert ws is w and ws.dtype == F32
            assert args[WS_AT] == args[W_AT] == w.data_ptr()
        elif D > 256:
            assert ws.dtype == torch.bfloat16
            assert torch.equal(ws, w.to(torch.bfloat16))
            assert args[WS_AT] == ws.data_ptr() != args[W_AT]
        else:
            assert ws is None and args[WS_AT] is None


# --------------------------------------------------------------------------
# the f32 passes against the JAX package
# --------------------------------------------------------------------------

# (seed, G, N, E, HD, D, mask kind), heads: one head of 264 features (two
# column launches, 128 + 136) at the preset's D = 200; two heads of 264 at
# D = 1040, the widths phase's gnn_dim
F32_CASES = {
    "d200_split_head": ((11, 2, 8, 13, 264, 200, "masked25"), 1),
    "d1040_split_heads": ((12, 2, 8, 13, 528, 1040, "one_graph_empty"), 2),
}


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_f32_passes_match_pallas(case):
    shape, heads = F32_CASES[case]
    assert gk._bwd_route(F32, None) == 1 and gk._bwd_streams(shape[5], F32)
    assert passes_match_pallas(shape, heads, "float32")
