"""The tile plan of rows 8 and 9's demb product on Hopper (CPU).

`bwd_demb`'s route 1 runs `demb_tc_kernel` (csrc/gat_demb.cu): tiles of
BM slots x BN of demb's columns, wgmma fed by TMA from a ring of 128-byte
slices. BN is chosen on the host (`gat_kernels.demb_plan`) from the widths
the kernel is built at. The kernel runs only on the card; here, for every
(D, HD) that `kernel_widths` gives at gnn_dim 4-1100 and 1-32 heads, in
both dtypes:

  * the column tiles cover D exactly once, BN a multiple of 8 and at most
    256 (wgmma's widths), one the kernel is built at;
  * the ring (at least two slots) and the epilogue's staging fit in the
    227 KB a block may ask for;
  * every TMA box has at most 256 elements a dimension and an inner extent
    of a multiple of 16 bytes, no more than the swizzle's 128 bytes where
    it is swizzled;
  * the plan's constants against those the kernel is compiled with, parsed
    from csrc, and the f32 split of W against csrc's `split_tf32`.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_bwd_f32_route import _card, _Lib

from qagnn_tpu_torch.ops import _build
from qagnn_tpu_torch.ops import gat_kernels as gk

CSRC = (Path(__file__).resolve().parents[1] / "qagnn_tpu_torch" / "csrc"
        / "gat_demb.cu").read_text()
BF16, F32 = torch.bfloat16, torch.float32
SMEM = 227 * 1024 + 1024            # 232,448 bytes: an H100 block's most
SWIZZLE_SPAN = 128


def _kernel_widths(heads):
    """Every (D, HD) `kernel_widths` gives at gnn_dim 4-1100 with `heads`
    heads (the op's D and HD both gnn_dim, heads dividing it)."""
    return sorted({gk.kernel_widths(dim, dim, heads)
                   for dim in range(4, 1101) if dim % heads == 0})


def _box_ok(box, es):
    inner, rows, swizzled = box
    return (0 < inner <= 256 and 0 < rows <= 256 and inner * es % 16 == 0
            and (not swizzled or inner * es <= SWIZZLE_SPAN))


@pytest.mark.parametrize("heads", range(1, 33))
@pytest.mark.parametrize("cdt", [BF16, F32], ids=["bf16", "f32"])
def test_plan_fits_every_kernel_width(cdt, heads):
    es = torch.finfo(cdt).bits // 8
    for D, HD in _kernel_widths(heads):
        p = gk.demb_plan(D, HD, cdt)
        where = f"D={D} HD={HD} {p}"
        assert p.bn % 8 == 0 and 0 < p.bn <= 256, where
        assert p.bn in gk.DEMB_WIDTHS[cdt], where
        # the column tiles [i bn, min((i + 1) bn, D)) cover D once: the last
        # starts inside D, and the stores cut it at D
        starts = [i * p.bn for i in range(p.n_tiles)]
        assert starts[-1] < D <= starts[-1] + p.bn, where
        covered = np.zeros(D, dtype=int)
        for c0 in starts:
            covered[c0:min(c0 + p.bn, D)] += 1
        assert (covered == 1).all(), where
        assert p.k_tiles * p.bk >= HD > (p.k_tiles - 1) * p.bk, where
        assert p.bk * es == gk.DEMB_SLICE == SWIZZLE_SPAN, where
        assert 2 <= p.stages <= gk.DEMB_MAX_STAGES, where
        assert p.smem == gk.demb_smem_bytes(cdt, p.bn, p.stages) <= SMEM, \
            where
        ring = p.stages * (p.bm + gk.DEMB_B_TILES[cdt] * p.bn) * p.bk * es
        staging = 2 * 64 * p.bn * es
        assert ring + staging <= SMEM, where
        # cot's slices (bm rows) and W's (bn rows), swizzled; add's and
        # demb's 64-row blocks, one a consumer warpgroup at a time, not
        assert p.operand_box == (p.bk, p.bn, True), where
        assert _box_ok(p.operand_box, es), where
        assert _box_ok((p.bk, p.bm, True), es), where
        assert p.out_box == (p.bn, 64, False), where
        assert _box_ok(p.out_box, es), where


@pytest.mark.parametrize("cdt,D,bn,n", [
    (BF16, 1040, 176, 6), (BF16, 512, 176, 3), (BF16, 200, 200, 1),
    (BF16, 104, 104, 1), (BF16, 8, 40, 1), (F32, 1040, 104, 10),
    (F32, 512, 104, 5), (F32, 200, 104, 2), (F32, 104, 104, 1),
    (F32, 768, 136, 6)])
def test_plan_picks_the_widths_with_least_waste(cdt, D, bn, n):
    p = gk.demb_plan(D, 1056, cdt)
    assert (p.bn, p.n_tiles) == (bn, n)


def test_plan_takes_a_named_width():
    p = gk.demb_plan(1040, 1056, BF16, bn=104)
    assert (p.bn, p.n_tiles, p.stages) == (104, 10, 4)
    assert p.smem == gk.demb_smem_bytes(BF16, 104, 4) <= SMEM
    assert gk.demb_smem_bytes(BF16, 104, 5) > SMEM
    with pytest.raises(ValueError):
        gk.demb_plan(1036, 1056, BF16)


def _ints(name):
    return tuple(int(v) for v in re.search(
        rf"constexpr int {name}\[\] = \{{([^}}]*)\}};", CSRC)
        .group(1).split(","))


def _shape(cdt):
    body = re.search(r"struct DembShape<%s> \{(.*?)\n\};" % cdt, CSRC,
                     re.S).group(1)
    return {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", body)}


def _cases(kind):
    body = re.search(r"launch_demb<%s, N>.*?#undef DEMB_CASE" % kind, CSRC,
                     re.S).group(0)
    return tuple(int(v) for v in re.findall(r"DEMB_CASE\((\d+)\)", body))


def test_plan_constants_match_the_kernel():
    assert _ints("DEMB_WIDTHS_BF16") == gk.DEMB_WIDTHS[BF16] \
        == _cases("bf16")
    assert _ints("DEMB_WIDTHS_F32") == gk.DEMB_WIDTHS[F32] == _cases("float")
    for cdt, name in ((BF16, "bf16"), (F32, "float")):
        shape = _shape(name)
        assert 2 * 64 * shape["MI"] == gk.DEMB_ROWS[cdt]
        assert shape["B_TILES"] == gk.DEMB_B_TILES[cdt]
    for name, value in (("DEMB_SMEM_LIMIT", gk.TC_SMEM_LIMIT),
                        ("DEMB_SLICE", gk.DEMB_SLICE),
                        ("DEMB_ALIGN", gk.DEMB_ALIGN),
                        ("DEMB_MAX_STAGES", gk.DEMB_MAX_STAGES)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", CSRC)
                   .group(1)) == value
    # the shared memory the kernel asks for, term by term
    body = re.search(r"constexpr int demb_smem_bytes\(int bn, int stages\) "
                     r"\{(.*?)\n\}", CSRC, re.S).group(1)
    assert re.sub(r"\s+", " ", body).strip() == (
        "return DEMB_ALIGN + stages * demb_stage_bytes<T>(bn) + "
        "2 * 64 * bn * (int)sizeof(T) + (2 * stages + 4) * 8;")


def _split_numpy(x):
    bits = x.astype(np.float32).view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)
    return hi, (x.astype(np.float32) - hi).astype(np.float32)


def test_w_split_is_split_tf32_bit_for_bit():
    rng = np.random.default_rng(0)
    ties = (np.uint32(0x3f800000) + (np.arange(64, dtype=np.uint32) << 13)
            + np.uint32(0x1000))
    x = np.concatenate([
        rng.standard_normal(4088).astype(np.float32) * 0.05,
        # halfway between two tf32 values, both signs; zeros, a subnormal
        # and values near the largest
        ties.view(np.float32), (ties | np.uint32(1 << 31)).view(np.float32),
        np.array([0.0, -0.0, 1e-40, -3e38, 3e38, 1.0, -2.5, 7.0],
                 dtype=np.float32)])
    hi, lo = gk._tf32_split(torch.from_numpy(x.copy()).reshape(-1, 8))
    want_hi, want_lo = _split_numpy(x)
    assert np.array_equal(hi.numpy().ravel().view(np.uint32),
                          want_hi.view(np.uint32))
    assert np.array_equal(lo.numpy().ravel().view(np.uint32),
                          want_lo.view(np.uint32))
    assert (hi.numpy().view(np.uint32) & 0x1fff == 0).all()
    assert np.array_equal((hi + lo).numpy().ravel(), x)


@pytest.mark.parametrize("cdt", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("with_add", [False, True])
def test_route_1_hands_the_kernel_its_plan(monkeypatch, cdt, with_add):
    G, E, D, HD = 2, 13, 520, 160
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(s, generator=gen)  # noqa: E731
    cot, w = _card(r(G, E, HD).to(cdt)), _card(r(D, HD))
    add = _card(r(G, E, D).to(cdt)) if with_add else None
    lib = _Lib()
    monkeypatch.setattr(gk, "_demb_lib", lambda: lib)
    monkeypatch.setattr(gk, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(gk, "_stream", lambda: 0)
    try:
        out = gk.bwd_demb(cot, w, add)
        counts = dict(_build.ROUTES)
    finally:
        _build.reset_launch_counts()
    assert counts == {("gat_bwd_demb", 1): 1}
    (name, args), = lib.calls
    p = gk.demb_plan(D, HD, cdt)
    assert name == "gat_demb_tc"
    assert args[0] == cot.data_ptr() and args[4] == out.data_ptr()
    assert args[3] == (None if add is None else add.data_ptr())
    assert args[5:] == (G * E, D, HD, p.bn, p.stages, 132,
                        0 if cdt == F32 else 1, 0)
    # bf16: W rounded once, no lo; f32: W's hi and lo, never W itself
    assert (args[2] is None) == (cdt == BF16)
    assert args[1] != w.data_ptr()
