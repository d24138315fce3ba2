"""The plan and the route of rows 8 and 9's bf16 edge launch on Hopper
(CPU).

In bfloat16 backward passes 1 and 2 run their edge launch on route 2:
`edge_wgmma_kernel` (csrc/gat_edge.cu), wgmma fed by TMA through an
mbarrier ring, a producer warpgroup and two consumer warpgroups of 64 slots
each, W resident in shared memory up to D = 256 and its rows streamed past
that, where a launch makes no demb product. Its ring, tables and blocks are
chosen on the host (`gat_kernels.edge_plan`), its route by dtype and width
(`gat_kernels._edge_route`). The kernel runs only on the card; here:

  * the plan's constants and shared-memory formula against csrc;
  * the plan at every (D, HD) that `kernel_widths` gives at gnn_dim 4-1100
    and 1-32 heads, a launch a head group or column slice, at a batch's
    slots and the grid's halves and quarters: the ring and the tables
    within the card's shared memory, the TMA boxes within its limits;
  * the route rule in both dtypes: bf16 takes route 2, f32 keeps the
    mma.sync kernel (`edge_pass_tc_kernel`), and bf16's one launch of a
    pass past D = 256 too; the named routes;
  * the arguments each wrapper hands the kernel, its plan among them, with
    the library patched.
"""

import re
from pathlib import Path

import pytest
import torch
from test_torch_bwd_f32_route import _card, _Lib

from qagnn_tpu_torch.ops import _build
from qagnn_tpu_torch.ops import gat_kernels as gk

CSRC = (Path(__file__).resolve().parents[1] / "qagnn_tpu_torch" / "csrc"
        / "gat_edge.cu").read_text()
BF16, F32 = torch.bfloat16, torch.float32
SMEM = 227 * 1024 + 1024            # 232,448 bytes: an H100 block's most
SWIZZLE_SPAN = 128
N_SM = 132
# a batch's slots a graph (E = 4096 and E - 3) and a rank's of the grid's
# 1 x 2 and 1 x 4 (E / 2, E / 4), 64 graphs
EDGES = (4096, 4093, 2048, 1024)
# the positions among gat_edge_tc's arguments: W rounded to bf16, the add,
# the cotangent rows, demb, then the ints from the pass on
W16_AT, ADD_AT, COT_AT, DEMB_AT, INTS_AT = 3, 13, 14, 15, 22


def _int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CSRC).group(1))


def _kernel_launches(heads):
    """Every (D, launch HD, launch heads, launches a pass) of the passes at
    gnn_dim 4-1100 with `heads` heads (the op's D and HD both gnn_dim)."""
    out = set()
    for dim in range(4, 1101):
        if dim % heads:
            continue
        D, HD = gk.kernel_widths(dim, dim, heads)
        plan = gk.launches(HD, heads)
        for h0, h1, c0, c1 in plan:
            out.add((D, c1 - c0, h1 - h0, len(plan)))
    return sorted(out)


def test_plan_constants_match_the_kernel():
    for name, value in (("EDGE_SMEM_LIMIT", gk.TC_SMEM_LIMIT),
                        ("EDGE_ALIGN", gk.EDGE_ALIGN),
                        ("EDGE_ROWS", gk.EDGE_ROWS),
                        ("EDGE_BOX", gk.EDGE_BOX),
                        ("EDGE_MAX_D", gk.EDGE_MAX_D),
                        ("EDGE_MAX_COLS", gk.MAX_COLS),
                        ("EDGE_MAX_STAGES", gk.EDGE_MAX_STAGES),
                        ("EDGE_MAX_TABLES", gk.EDGE_MAX_TABLES),
                        ("EDGE_LDS", gk.EDGE_LDS)):
        assert _int(name) == value, name
    assert "constexpr int EDGE_PAIR = 2 * EDGE_ROWS;" in CSRC
    assert gk.EDGE_PAIR == 2 * gk.EDGE_ROWS
    assert "constexpr int EDGE_BOX_BYTES = EDGE_ROWS * 128;" in CSRC
    assert gk.EDGE_BOX_BYTES == gk.EDGE_ROWS * SWIZZLE_SPAN
    assert "constexpr int EDGE_WARP_STAGE = 16 * EDGE_LDS * 4;" in CSRC
    assert gk.EDGE_WARP_STAGE == 16 * gk.EDGE_LDS * 4
    # a table: the pair's two node rows, then the weights and e of each
    # (slot, head), MAX_H + 1 floats a slot
    assert "constexpr int EDGE_TAB_LD = MAX_H + 1;" in CSRC
    body = re.search(r"struct EdgeTable \{(.*?)\};", CSRC, re.S).group(1)
    assert re.findall(r"(int|float) (\w+)\[(.*?)\];", body) == [
        ("int", "src", "EDGE_PAIR"), ("int", "dst", "EDGE_PAIR"),
        ("float", "wt", "EDGE_PAIR * EDGE_TAB_LD"),
        ("float", "e", "EDGE_PAIR * EDGE_TAB_LD")]
    assert gk.EDGE_TABLE_BYTES == 4 * (2 * gk.EDGE_PAIR
                                       + 2 * gk.EDGE_PAIR * (8 + 1))
    # the shared memory the kernel asks for, term by term
    smem = re.search(r"constexpr int edge_smem_bytes\(int D, int HD, bool "
                     r"stream,\s+int stages, int tables\) \{(.*?)\n\}",
                     CSRC, re.S).group(1)
    assert re.sub(r"\s+", " ", smem).strip() == (
        "return EDGE_ALIGN + edge_w_bytes(D, HD, stream) + stages * "
        "edge_stage_bytes(D, HD, stream) + tables * (int)sizeof(EdgeTable) "
        "+ 8 * EDGE_WARP_STAGE + EDGE_MAX_COLS * 5 + (2 * stages + 2 * "
        "tables + 1) * 8;")
    w = re.search(r"constexpr int edge_w_bytes\(int D, int HD, bool "
                  r"stream\) \{(.*?)\n\}", CSRC, re.S).group(1)
    assert re.sub(r"\s+", " ", w).strip() == (
        "return stream ? 0 : edge_nb(HD) * edge_dp(D) * 128;")
    stage = re.search(r"constexpr int edge_stage_bytes\(int D, int HD,\s+"
                      r"bool stream\) \{(.*?)\n\}", CSRC, re.S).group(1)
    assert re.sub(r"\s+", " ", stage).strip() == (
        "return stream ? (2 + edge_nb(HD)) * EDGE_BOX_BYTES : 2 * ((D + 63) "
        "/ 64) * EDGE_BOX_BYTES;")
    assert "return (HD + 63) / 64;" in CSRC and \
        "return (D + 15) / 16 * 16;" in CSRC
    # the kernel is built for one to four 64-column blocks, both passes,
    # W streamed (no product 2) or resident with or without product 2, and
    # pass 1's heads at 4 or 8
    assert re.search(r"switch \(edge_nb\(a\.HD\)\) \{\s+case 1:.*case 2:.*"
                     r"case 3:.*default:", CSRC, re.S)
    assert "static_assert(!(STREAM && DEMB)" in CSRC
    for args in ("PASS, true, false, HP", "PASS, false, true, HP",
                 "PASS, false, false, HP"):
        assert f"launch_edge_nb<{args}>" in CSRC, args
    for args in ("2, 4", "1, 4", "1, 8"):
        assert f"launch_edge_mode<{args}>" in CSRC, args


def _check_plan(p, G, E, D, HD, heads):
    where = f"G={G} E={E} D={D} HD={HD} heads={heads} {p}"
    assert p.nb == -(-HD // 64) and 1 <= p.nb <= 4, where
    assert p.stream == (D > gk.EDGE_MAX_D), where
    assert p.hp == (4 if heads <= 4 else 8), where
    assert 1 <= p.stages <= gk.EDGE_MAX_STAGES, where
    assert 1 <= p.tables <= gk.EDGE_MAX_TABLES, where
    assert p.smem == gk.edge_smem_bytes(D, HD, p.stream, p.stages,
                                        p.tables) <= SMEM, where
    # the most ring slots beside the most tables that leave one
    if p.stages < gk.EDGE_MAX_STAGES:
        assert gk.edge_smem_bytes(D, HD, p.stream, p.stages + 1,
                                  p.tables) > SMEM, where
    if p.tables < gk.EDGE_MAX_TABLES:
        assert gk.edge_smem_bytes(D, HD, p.stream, 1, p.tables + 1) > SMEM, \
            where
    assert p.pairs == G * -(-E // gk.EDGE_PAIR), where
    assert 1 <= p.blocks <= min(N_SM, max(p.pairs, 1)), where
    for inner, rows, swizzled in (p.w_box, p.emb_box):
        assert 0 < inner <= 256 and 0 < rows <= 256 and swizzled, where
        assert inner * 2 == SWIZZLE_SPAN, where
    # W whole: all of D's rows (rounded up to 16) in one box a block; the
    # depth of product 1 runs over them 16 at a time
    assert p.w_box[1] == (64 if p.stream else -(-D // 16) * 16), where


@pytest.mark.parametrize("heads", range(1, 33))
def test_plan_fits_every_kernel_width(heads):
    for D, HD, h, n in _kernel_launches(heads):
        for E in EDGES:
            _check_plan(gk.edge_plan(64, E, D, HD, h, N_SM), 64, E, D, HD, h)
        # a launch of a pass of several takes route 2; one launch a pass,
        # which makes its demb product, route 1, the faster there
        want = 2 if n > 1 else 1
        assert gk._edge_route(BF16, None, D, n == 1) == want, (D, HD, h, n)


def test_plan_at_the_main_widths():
    """The preset (D = HD = 200), gnn_dim 256, 100 and the column launches
    of gnn_dim 512 and 1040: W resident at the first three (one ring slot
    at 200 and 256, two tables but at 256), streamed at the others."""
    want = {(200, 200, 4): (4, False, 1, 2), (256, 256, 4): (4, False, 1, 1),
            (104, 104, 4): (2, False, 4, 2), (512, 256, 2): (4, True, 3, 2),
            (1040, 136, 1): (3, True, 4, 2), (1040, 128, 1): (2, True, 4, 2)}
    for (D, HD, heads), (nb, stream, stages, tables) in want.items():
        p = gk.edge_plan(64, 4096, D, HD, heads, N_SM)
        assert (p.nb, p.stream, p.stages, p.tables) == \
            (nb, stream, stages, tables), (D, HD, p)
        assert (p.pairs, p.blocks) == (64 * 32, N_SM)
    # a few slots: one pair a graph, no more blocks than pairs
    p = gk.edge_plan(2, 13, 40, 64, 4, N_SM)
    assert (p.pairs, p.blocks) == (2, 2)


def test_plan_refuses_widths_the_kernel_does_not_take():
    for D, HD, heads in ((36, 64, 4), (64, 60, 4), (64, 264, 4),
                         (64, 64, 9)):
        with pytest.raises(ValueError):
            gk.edge_plan(64, 4096, D, HD, heads, N_SM)


@pytest.mark.parametrize("cdt,route,D,demb,want", [
    (BF16, None, 200, True, 1), (BF16, None, 256, True, 1),
    (BF16, None, 264, True, 1), (BF16, None, 264, False, 2),
    (BF16, None, 1040, False, 2), (F32, None, 200, True, 1),
    (F32, None, 1040, False, 1), (BF16, 0, 200, True, 0),
    (BF16, 1, 200, True, 1), (BF16, 2, 1040, False, 2),
    (F32, 0, 200, True, 0), (F32, 1, 520, False, 1), (BF16, 2, 200, True, 2)])
def test_edge_route_follows_dtype_and_width(cdt, route, D, demb, want):
    """bf16 takes the wgmma kernel for every launch without product 2 and
    the mma.sync kernel for one with it, as float32 does everywhere; route
    0 and 1 may be named in either dtype, route 2 in bf16 where it runs
    the launch."""
    assert gk._edge_route(cdt, route, D, demb) == want


@pytest.mark.parametrize("cdt,route,D,demb", [
    (F32, 2, 200, True), (BF16, 2, 264, True), (BF16, 3, 200, True),
    (F32, 3, 200, True)])
def test_edge_route_refuses(cdt, route, D, demb):
    with pytest.raises(ValueError):
        gk._edge_route(cdt, route, D, demb)


def _inputs(gen, G, N, E, D, HD, heads, cdt):
    r = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    idx = lambda: _card(torch.randint(0, N, (G, E), generator=gen,  # noqa
                                      dtype=torch.int32))
    return dict(nodes=[_card(r(G, N, HD).to(cdt)) for _ in range(4)],
                emb=_card(r(G, E, D).to(cdt)), w=_card(r(D, HD)),
                b=_card(r(HD)), src=idx(), dst=idx(),
                mask=_card(torch.rand((G, E), generator=gen) > 0.25),
                scores=_card(r(G, heads, E)), gmax=_card(r(G, heads)),
                per_node=[_card(r(G, N, heads)) for _ in range(3)],
                acc=[_card(r(G, N, HD)) for _ in range(3)],
                dalpha=_card(r(G, heads, E)),
                carry=_card(r(G, E, D).to(cdt)),
                demb=_card(r(G, E, D).to(cdt)))


def _patched(monkeypatch):
    lib = _Lib()
    for name in ("_bwd_lib", "_edge_lib", "_dw_lib", "_demb_lib"):
        monkeypatch.setattr(gk, name, lambda: lib)
    monkeypatch.setattr(gk, "_sm_count", lambda dev: N_SM)
    monkeypatch.setattr(gk, "_stream", lambda: 0)
    monkeypatch.setattr(gk, "_cot_rows", lambda src, HD, like: _card(
        torch.empty((*src.shape, HD), dtype=like.dtype)))
    return lib


def _passes(t, heads, route=None):
    n = t["nodes"]
    try:
        gk.bwd_pass1(n[0], n[1], t["emb"], t["w"], t["b"], t["scores"],
                     t["gmax"], t["per_node"][0], t["src"], t["dst"],
                     t["mask"], t["carry"], t["acc"][0], t["per_node"][1],
                     heads, _route=route)
        gk.bwd_pass2(n[2], n[3], t["emb"], t["w"], t["b"], t["scores"],
                     t["gmax"], t["dalpha"], t["per_node"][0],
                     t["per_node"][2], t["src"], t["dst"], t["mask"],
                     t["demb"], t["acc"][1], t["acc"][2], heads,
                     _route=route)
        return dict(_build.ROUTES)
    finally:
        _build.reset_launch_counts()


@pytest.mark.parametrize("D,HD,heads", [(40, 64, 4), (200, 200, 4),
                                        (96, 128, 8)])
def test_wrappers_hand_the_kernel_its_plan(monkeypatch, D, HD, heads):
    """A pass of one launch on route 2: the edge kernel with the plan of its
    widths, W rounded to bf16, pass 1 the carry as its add and a new demb,
    pass 2 its demb as the add, updated in place; then one dW launch a
    pass. With no route named it runs on the mma.sync kernel (route 1)."""
    G, N, E = 2, 8, 13
    t = _inputs(torch.Generator().manual_seed(0), G, N, E, D, HD, heads,
                BF16)
    lib = _patched(monkeypatch)
    routes = _passes(t, heads, route=2)
    assert routes == {("gat_bwd_pass1", 2): 1, ("gat_bwd_pass2", 2): 1,
                      ("gat_bwd_dw", 1): 2}
    assert [name for name, _ in lib.calls] == ["gat_edge_tc", "gat_dw_tc"] * 2
    p = gk.edge_plan(G, E, D, HD, heads, N_SM)
    for pass_, (_, args) in zip((1, 2), lib.calls[::2]):
        assert args[INTS_AT:-1] == (pass_, G, N, E, D, HD, heads, 0, HD,
                                    p.nb, int(p.stream), p.hp, p.stages,
                                    p.tables, p.blocks)
        # rows_src: pass 1's nm, pass 2's nq
        assert args[0] == t["nodes"][pass_].data_ptr()
        assert args[W16_AT] not in (None, t["w"].data_ptr())
        assert args[DEMB_AT] is not None
    p1, p2 = lib.calls[0][1], lib.calls[2][1]
    assert p1[ADD_AT] == t["carry"].data_ptr() != p1[DEMB_AT]
    assert p2[ADD_AT] == p2[DEMB_AT] == t["demb"].data_ptr()
    lib.calls.clear()
    assert _passes(t, heads) == {("gat_bwd_pass1", 1): 1,
                                 ("gat_bwd_pass2", 1): 1,
                                 ("gat_bwd_dw", 1): 2}
    assert [name for name, _ in lib.calls] == ["gat_bwd_pass1", "gat_dw_tc",
                                               "gat_bwd_pass2", "gat_dw_tc"]


def test_wrappers_run_column_launches_on_route_2(monkeypatch):
    """Past D = 256 a pass of several launches runs each on route 2, W's
    rows streamed, no demb product in a launch (it writes its columns of
    the cotangent rows), then one demb and one dW launch; route 1 named
    runs the mma.sync kernel instead, and its demb launch route 1 too."""
    G, N, E, D, HD, heads = 2, 8, 13, 520, 320, 4
    t = _inputs(torch.Generator().manual_seed(1), G, N, E, D, HD, heads,
                BF16)
    n = len(gk.launches(HD, heads))
    lib = _patched(monkeypatch)
    routes = _passes(t, heads)
    assert n == 2 and routes == {
        ("gat_bwd_pass1", 2): n, ("gat_bwd_pass2", 2): n,
        ("gat_bwd_demb", 1): 2, ("gat_bwd_dw", 1): 2}
    names = [name for name, _ in lib.calls]
    assert names == (["gat_edge_tc"] * n + ["gat_demb_tc", "gat_dw_tc"]) * 2
    for _, args in lib.calls[:n]:
        p = gk.edge_plan(G, E, D, args[INTS_AT + 5], args[INTS_AT + 6],
                         N_SM)
        assert p.stream and args[INTS_AT + 9:-1] == (
            p.nb, 1, p.hp, p.stages, p.tables, p.blocks)
        assert args[DEMB_AT] is None and args[ADD_AT] is None
        # the cotangent's column view, rows HD apart
        assert args[INTS_AT + 8] == HD
    lib.calls.clear()
    routes = _passes(t, heads, route=1)
    assert routes == {("gat_bwd_pass1", 1): n, ("gat_bwd_pass2", 1): n,
                      ("gat_bwd_demb", 1): 2, ("gat_bwd_dw", 1): 2}
    assert [name for name, _ in lib.calls][:n] == ["gat_bwd_pass1"] * n


def test_one_launch_past_256_keeps_the_mma_sync_kernel(monkeypatch):
    """A pass of one launch past D = 256 (the op at D != HD) makes its demb
    product in the launch: route 1, which streams W for it; route 2 named
    there is refused."""
    G, N, E, D, HD, heads = 2, 8, 13, 264, 200, 4
    t = _inputs(torch.Generator().manual_seed(2), G, N, E, D, HD, heads,
                BF16)
    lib = _patched(monkeypatch)
    routes = _passes(t, heads)
    assert routes == {("gat_bwd_pass1", 1): 1, ("gat_bwd_pass2", 1): 1,
                      ("gat_bwd_dw", 1): 2}
    assert [name for name, _ in lib.calls] == ["gat_bwd_pass1", "gat_dw_tc",
                                               "gat_bwd_pass2", "gat_dw_tc"]
    with pytest.raises(ValueError):
        _passes(t, heads, route=2)
