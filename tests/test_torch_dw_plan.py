"""The plan of rows 8 and 9's dW product on Hopper, and the passes around
it (CPU).

Every route-1 backward pass makes dW = emb^T cot in one `bwd_dw` launch
over all of its HD columns: `dw_wgmma_kernel` (csrc/gat_dw.cu), tiles of
BM rows of dW x BN columns over ranges of slots, wgmma fed by TMA from a
ring of slices, then the sum of the ranges' partials. The tile and the
ranges are chosen on the host (`gat_kernels.dw_plan`). The kernel runs
only on the card; here:

  * the plan at every (D, HD) that `kernel_widths` gives at gnn_dim
    4-1100 and 1-32 heads, over the slots of a whole batch (G = 64, E =
    4096 and E - 3) and of the grid's E/2 and E/4, in both dtypes: the
    tiles cover D and HD, the ranges cover the slots once with no empty
    range, the partials stay within their share of the operands' bytes,
    the ring and the TMA boxes within the card's limits;
  * the plan's constants and shared-memory formula against csrc;
  * the arguments the wrapper hands either route, with the library
    patched, and the passes' one dW launch over their cotangent rows;
  * both passes' dW and db against the JAX package's `_proj_bwd_pass1` /
    `_proj_bwd_pass2` in interpret mode, at a width of one launch a pass
    and at two of several (HD past 256, more than 8 heads): their weight
    gradients come from the one product over all columns.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import test_torch_bwd_streamed as streamed
from test_torch_bwd_f32_route import _card, _Lib
from test_torch_bwd_streamed import passes_match_pallas
from test_torch_gat_backward import _close

from qagnn_tpu_torch.ops import _build
from qagnn_tpu_torch.ops import gat_kernels as gk

CSRC = (Path(__file__).resolve().parents[1] / "qagnn_tpu_torch" / "csrc"
        / "gat_dw.cu").read_text()
BF16, F32 = torch.bfloat16, torch.float32
SMEM = 227 * 1024 + 1024            # 232,448 bytes: an H100 block's most
SWIZZLE_SPAN = 128
N_SM = 132
# a batch's slots (G = 64 graphs of E = 4096, and E - 3) and a rank's of
# the grid's 1 x 2 and 1 x 4 (E / 2, E / 4)
SLOTS = (64 * 4096, 64 * 4093, 64 * 2048, 64 * 1024)


def _kernel_widths(heads):
    """Every (D, HD) `kernel_widths` gives at gnn_dim 4-1100 with `heads`
    heads (the op's D and HD both gnn_dim, heads dividing it)."""
    return sorted({gk.kernel_widths(dim, dim, heads)
                   for dim in range(4, 1101) if dim % heads == 0})


def _box_ok(box, es):
    inner, rows, swizzled = box
    return (0 < inner <= 256 and 0 < rows <= 256 and inner * es % 16 == 0
            and (not swizzled or inner * es <= SWIZZLE_SPAN))


def _check_plan(p, D, HD, R, cdt):
    es = torch.finfo(cdt).bits // 8
    where = f"D={D} HD={HD} R={R} {p}"
    assert (p.bm, p.bn) in gk.DW_TILES[cdt], where
    assert p.bn % 8 == 0 and 0 < p.bn <= 256 and p.bm % 128 == 0, where
    # the tiles cover D and HD; a tile past them computes what is dropped
    rows, cols = -(-D // p.bm), -(-HD // p.bn)
    assert p.n_tiles == rows * cols, where
    assert (rows - 1) * p.bm < D <= rows * p.bm, where
    assert (cols - 1) * p.bn < HD <= cols * p.bn, where
    # the ranges cover the slots once, none empty, whole slices each
    assert p.bk == gk.DW_SLICE[cdt] and p.chunk % p.bk == 0, where
    assert (p.n_ranges - 1) * p.chunk < max(R, 1) <= p.n_ranges * p.chunk \
        or R == 0, where
    covered = np.zeros(max(R, 1), dtype=int)
    for r in range(p.n_ranges):
        covered[r * p.chunk:min((r + 1) * p.chunk, R)] += 1
    assert (covered[:R] == 1).all(), where
    # the partials: one range's at least, else within their share
    share = gk.DW_PARTIAL_SHARE * R * (D + HD) * es
    assert p.partial_bytes == 4 * p.n_ranges * D * HD, where
    assert p.n_ranges == 1 or p.partial_bytes <= share, where
    assert 1 <= p.blocks <= min(N_SM, p.n_tiles * p.n_ranges), where
    # the ring within the shared memory; the boxes within TMA's limits
    assert 2 <= p.stages <= gk.DW_MAX_STAGES, where
    assert p.smem == gk.dw_smem_bytes(cdt, p.bm, p.bn, p.stages) <= SMEM, \
        where
    if p.stages < gk.DW_MAX_STAGES:
        assert gk.dw_smem_bytes(cdt, p.bm, p.bn, p.stages + 1) > SMEM, where
    assert p.box == (gk.DW_BLOCK // es, p.bk, True) and _box_ok(p.box, es), \
        where
    assert p.bm % p.box[0] == 0 and p.bn % p.box[0] == 0, where


@pytest.mark.parametrize("heads", range(1, 33))
@pytest.mark.parametrize("cdt", [BF16, F32], ids=["bf16", "f32"])
def test_plan_fits_every_kernel_width(cdt, heads):
    for D, HD in _kernel_widths(heads):
        for R in SLOTS:
            _check_plan(gk.dw_plan(D, HD, R, cdt, N_SM), D, HD, R, cdt)


@pytest.mark.parametrize("cdt", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("R", [0, 1, 26, 63, 64, 65, 4093 * 2])
def test_plan_covers_few_slots(cdt, R):
    """A test's batch of a few slots: one range where the partials would
    outweigh the operands, and zero slots (the launch only clears dW)."""
    for D, HD in ((8, 8), (40, 24), (264, 520)):
        p = gk.dw_plan(D, HD, R, cdt, N_SM)
        _check_plan(p, D, HD, R, cdt)
        if R < 64:
            assert p.n_ranges == 1


def test_plan_takes_named_tiles_and_ranges():
    p = gk.dw_plan(1040, 1056, 64 * 4096, BF16, N_SM, bm=128, bn=192,
                   n_ranges=7)
    assert (p.bm, p.bn, p.n_tiles, p.n_ranges) == (128, 192, 9 * 6, 7)
    assert p.chunk == -(-(64 * 4096 // 7 + 1) // 64) * 64
    assert p.blocks == N_SM
    with pytest.raises(ValueError):
        gk.dw_plan(1040, 1056, 64 * 4096, F32, N_SM, bm=256)
    with pytest.raises(ValueError):
        gk.dw_plan(1036, 1056, 64 * 4096, BF16, N_SM)
    for cdt in (BF16, F32):
        for bm, bn in gk.DW_TILES[cdt]:
            _check_plan(gk.dw_plan(200, 200, 64 * 4096, cdt, N_SM, bm=bm,
                                   bn=bn), 200, 200, 64 * 4096, cdt)


def test_ranges_hold_whole_slices():
    for R in (0, 1, 63, 64, 65, 262_144, 261_952):
        for n in (1, 2, 7, 66, 132, 5000):
            chunk, ranges = gk.dw_ranges(R, 64, n)
            assert chunk % 64 == 0 and chunk >= 64
            assert ranges == max(1, -(-R // chunk))
            assert (ranges - 1) * chunk < max(R, 1)


def _pairs(name):
    body = re.search(rf"constexpr int {name}\[\]\[2\] = \{{(.*?)\}};",
                     CSRC, re.S).group(1)
    return tuple((int(a), int(b))
                 for a, b in re.findall(r"\{(\d+), (\d+)\}", body))


def _cases(kind):
    return tuple((128 * int(m), int(n)) for m, n in re.findall(
        rf"DW_CASE\({kind}, (\d+), (\d+)\)", CSRC))


def _int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", CSRC).group(1))


def test_plan_constants_match_the_kernel():
    assert _pairs("DW_TILES_BF16") == gk.DW_TILES[BF16] == _cases("bf16")
    assert _pairs("DW_TILES_F32") == gk.DW_TILES[F32] == _cases("float")
    for name, value in (("DW_SMEM_LIMIT", gk.TC_SMEM_LIMIT),
                        ("DW_ALIGN", gk.DW_ALIGN),
                        ("DW_MAX_STAGES", gk.DW_MAX_STAGES),
                        ("DW_BLOCK", gk.DW_BLOCK)):
        assert _int(name) == value, name
    body = re.search(r"constexpr int dw_bk\(\) \{\s*return (.*?);", CSRC,
                     re.S).group(1)
    assert body == "sizeof(T) == 2 ? %d : %d" % (gk.DW_SLICE[BF16],
                                                  gk.DW_SLICE[F32])
    # the shared memory the kernel asks for, term by term
    stage = re.search(r"constexpr int dw_stage_bytes\(int bm, int bn\) "
                      r"\{(.*?)\n\}", CSRC, re.S).group(1)
    assert re.sub(r"\s+", " ", stage).strip() == (
        "return (bm + bn) * dw_bk<T>() * (int)sizeof(T) + "
        "(sizeof(T) == 4 ? 2 * bn * DW_BLOCK : 0);")
    smem = re.search(r"constexpr int dw_smem_bytes\(int bm, int bn, int "
                     r"stages\) \{(.*?)\n\}", CSRC, re.S).group(1)
    assert re.sub(r"\s+", " ", smem).strip() == (
        "return DW_ALIGN + stages * dw_stage_bytes<T>(bm, bn) + "
        "3 * stages * 8;")
    # bf16 sums in place over groups of 1024 slots, whole slices (C16)
    assert _int("DW_FLUSH_SLOTS") == 1024
    assert _int("DW_FLUSH_SLOTS") % gk.DW_SLICE[BF16] == 0
    assert "constexpr int FLUSH = DW_FLUSH_SLOTS / BK;" in CSRC
    # every tile's two sums (the range's and a group's fresh one) fit a
    # consumer thread (232 registers in bf16, 208 in f32 beside A's split
    # fragments): bm / 128 row blocks of bn / 2 each
    for bm, bn in gk.DW_TILES[BF16]:
        assert 2 * (bm // 128) * bn // 2 <= 192
    for bm, bn in gk.DW_TILES[F32]:
        assert bm == 128 and 2 * bn // 2 <= 128


@pytest.mark.parametrize("cdt", [BF16, F32], ids=["bf16", "f32"])
def test_route_1_hands_the_kernel_its_plan(monkeypatch, cdt):
    G, E, D, HD = 2, 13, 520, 160
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    emb, cot = _card(r(G, E, D).to(cdt)), _card(r(G, E, HD).to(cdt))
    lib = _Lib()
    monkeypatch.setattr(gk, "_dw_lib", lambda: lib)
    monkeypatch.setattr(gk, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(gk, "_stream", lambda: 0)
    try:
        dw = gk.bwd_dw(emb, cot)
        counts = dict(_build.ROUTES)
    finally:
        _build.reset_launch_counts()
    assert counts == {("gat_bwd_dw", 1): 1}
    (name, args), = lib.calls
    p = gk.dw_plan(D, HD, G * E, cdt, 132)
    assert name == "gat_dw_tc" and p.n_ranges == 1
    assert args[:2] == (emb.data_ptr(), cot.data_ptr())
    assert args[2] is not None and args[3] == dw.data_ptr()
    assert dw.shape == (D, HD) and dw.dtype == F32
    assert args[4:] == (G * E, D, HD, p.bm, p.bn, p.chunk, p.n_ranges,
                        p.stages, p.blocks,
                        0 if cdt == F32 else 1, 0)
    # a plan of several ranges hands the kernel as many partials
    lib.calls.clear()
    E = 200
    emb, cot = _card(r(G, E, D).to(cdt)), _card(r(G, E, HD).to(cdt))
    many = gk.dw_plan(D, HD, G * E, cdt, 132, n_ranges=3)
    try:
        gk.bwd_dw(emb, cot, _plan=many)
    finally:
        _build.reset_launch_counts()
    (_, args), = lib.calls
    assert args[2] is not None and args[10] == many.n_ranges == 3


def test_route_0_hands_the_mma_sync_kernel_all_columns(monkeypatch):
    G, E, D, HD = 3, 100, 520, 264
    emb, cot = _card(torch.ones(G, E, D, dtype=BF16)), \
        _card(torch.ones(G, E, HD, dtype=BF16))
    lib = _Lib()
    monkeypatch.setattr(gk, "_bwd_lib", lambda: lib)
    monkeypatch.setattr(gk, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(gk, "_stream", lambda: 0)
    try:
        gk.bwd_dw(emb, cot, _route=0)
        counts = dict(_build.ROUTES)
    finally:
        _build.reset_launch_counts()
    assert counts == {("gat_bwd_dw", 0): 1}
    (name, args), = lib.calls
    assert name == "gat_bwd_dw"
    assert args[:2] == (emb.data_ptr(), cot.data_ptr())
    assert args[4:] == (G, E, D, HD, gk.d_slices(D)[1],
                        gk._dw_splits(G, E, 132), 1, 0)


def test_wrappers_make_dw_once_a_pass_from_its_cotangent_rows(monkeypatch):
    """Route 1: a pass of one launch hands `bwd_dw` the d_msg / dekb rows
    its edge launch wrote, and its edge launch no dW partial; a pass of
    several hands it the one (G, E, HD) array of every launch's rows."""
    lib = _Lib()
    monkeypatch.setattr(gk, "_bwd_lib", lambda: lib)
    monkeypatch.setattr(gk, "_dw_lib", lambda: lib)
    monkeypatch.setattr(gk, "_demb_lib", lambda: lib)
    monkeypatch.setattr(gk, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(gk, "_stream", lambda: 0)
    monkeypatch.setattr(gk, "_cot_rows", lambda src, HD, like: _card(
        torch.empty((*src.shape, HD), dtype=like.dtype)))
    gen = torch.Generator().manual_seed(1)
    r = lambda *s: _card(torch.randn(s, generator=gen))  # noqa: E731
    for HD, heads in ((64, 4), (320, 4)):
        G, N, E, D = 2, 8, 13, 40
        n = len(gk.launches(HD, heads))
        nodes = [_card(r(G, N, HD).to(BF16)) for _ in range(4)]
        emb = _card(r(G, E, D).to(BF16))
        idx = _card(torch.randint(0, N, (G, E), generator=gen,
                                  dtype=torch.int32))
        mask = _card(torch.rand((G, E), generator=gen) > 0.25)
        lib.calls.clear()
        try:
            gk.bwd_pass1(nodes[0], nodes[1], emb, r(D, HD), r(HD),
                         r(G, heads, E), r(G, heads), r(G, N, heads), idx,
                         idx, mask, None, r(G, N, HD), r(G, N, heads), heads)
            counts = dict(_build.LAUNCHES)
        finally:
            _build.reset_launch_counts()
        names = [name for name, _ in lib.calls]
        assert names == ["gat_bwd_pass1"] * n \
            + (["gat_demb_tc"] if n > 1 else []) + ["gat_dw_tc"]
        assert counts["gat_bwd_dw"] == 1
        dw_args = lib.calls[-1][1]
        # the pass's edge launches: no dW partial, no dW (pointers 18, 20)
        for _, args in lib.calls[:n]:
            assert args[18] is None and args[20] is None
        assert dw_args[0] == emb.data_ptr()
        if n == 1:
            assert dw_args[1] == lib.calls[0][1][13]       # its dmsg
        else:
            assert dw_args[1] == lib.calls[n][1][0]        # demb's cot
        assert dw_args[4:7] == (G * E, D, HD)


# (seed, G, N, E, HD, D, mask kind), heads: one launch a pass (HD 32, 4
# heads); several: two head groups of 160 columns (HD 320, 4 heads of 80)
# and of 5 heads (HD 160, 10 heads of 16)
PALLAS_CASES = {
    "one_launch": ((21, 2, 8, 13, 32, 40, "masked25"), 4),
    "hd320": ((22, 2, 8, 13, 320, 48, "one_graph_empty"), 4),
    "ten_heads": ((23, 2, 8, 13, 160, 24, "masked25"), 10),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(PALLAS_CASES))
def test_passes_dw_match_pallas(monkeypatch, case, dtype):
    """Both passes (dW and db among their outputs, at the tolerance of the
    backward tests) against the JAX passes; a pass of several launches
    takes dW from one `bwd_dw` over all of its columns."""
    shape, heads = PALLAS_CASES[case]
    HD = shape[4]
    n = len(gk.launches(HD, heads))
    assert (n > 1) == (case != "one_launch")
    calls, checked = [], []
    bwd_dw = gk.bwd_dw

    def spy(emb, cot, *a, **k):
        calls.append(tuple(cot.shape))
        return bwd_dw(emb, cot, *a, **k)

    def close(got, want, tol, what):
        # the weight gradients; the other outputs are the passes' tests'
        if what.split()[-1] in ("dW_me", "db_me", "dW_ke", "db_ke"):
            checked.append(what)
            _close(got, want, tol, what)
    monkeypatch.setattr(gk, "bwd_dw", spy)
    monkeypatch.setattr(streamed, "_close", close)
    passes_match_pallas(shape, heads, dtype)
    assert checked == ["pass 1 dW_me", "pass 1 db_me", "pass 2 dW_ke",
                       "pass 2 db_ke"]
    G, E = shape[1], shape[3]
    assert calls == ([] if n == 1 else [(G, E, HD)] * 2)


_NVCC = """#!/bin/sh
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
printf '%s\\n' "$MESSAGE"
: > "$out"
"""


@pytest.mark.parametrize("message, refused", [
    ("ptxas warning : (C7508) Potential Performance Loss: setmaxnreg "
     "ignored; unable to determine register count at entry", True),
    ("ptxas info    : Used 168 registers, used 1 barriers", False),
])
def test_build_refuses_an_ignored_setmaxnreg(monkeypatch, tmp_path, message,
                                             refused):
    """gat_dw.cu and gat_demb.cu hand registers between warpgroups with
    setmaxnreg; where ptxas drops one, the kernel would wait forever at its
    first launch, so the build fails instead and leaves no library."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("MESSAGE", message)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    if refused:
        with pytest.raises(RuntimeError, match="setmaxnreg"):
            _build.build_all(["gat_dw"])
    else:
        _build.build_all(["gat_dw"])
    assert _build._target("gat_dw").exists() != refused
    assert not list((tmp_path / "kernels").glob("*.tmp"))
