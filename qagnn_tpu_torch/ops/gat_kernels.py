"""The projected relational GAT op on hand-written CUDA kernels.

Counterpart of `pallas_relational_gat_projected[_chained]`
(qagnn_tpu/ops/pallas_gat.py: forward `_proj_fwd_impl` :1019-1050, backward
`_proj_bwd_impl` :1172-1199). The forward runs

  * pass A, scores (csrc/gat_fwd.cu `gat_pass_a_scores`): per edge the key
    bias ekb = emb W_ke + b_ke, the per-head logit
    s = <nq[src], nk[dst] + ekb> (0 at masked slots, which nothing reads)
    and the max over masked edges per (graph, head);
  * torch glue: the self-loop scores, gmax over masked edges AND all N
    self scores, e_self;
  * pass A, denominators (`gat_pass_a_denoms`): per-source sums of
    exp(min(s - gmax, 0)) and out-degrees over masked edges;
  * torch glue: scale = (deg + 1) / max(denom_edges + e_self, 1e-16) and the
    self-loop term (nm + smb) * e_self * scale that seeds the output;
  * pass C (`gat_pass_c`): out[dst] += alpha * (nm[src] + emb W_me + b_me)
    over masked edges, alpha = exp(min(s - gmax, 0)) * scale[src].

Pass A's scores and pass C have two routes behind one entry point each,
chosen by widths alone (`_fwd_route`): heads of at least 4 features run the
projection on tensor cores at any D in either dtype (csrc/gat_fwd_tc.cuh),
anything else stays on CUDA cores (route 0, also when named). bfloat16:
persistent blocks with W resident in shared memory at D <= 256; past that
W, rounded to bf16 here (`_streamed_w`), streams through shared memory in
chunks of its rows. float32: the same streaming kernel at every D, handed W
itself in f32, the product as split-TF32 products as in the backward
below.

The backward (`gat_projected`, `gat_projected_chained`: autograd Functions)
recomputes e = exp(min(s - gmax, 0)) from the saved scores and runs

  * torch glue: the self-loop cotangents d_msg_self, d_alpha_self;
  * pass 1 (csrc/gat_bwd.cu `gat_bwd_pass1`): d_msg = alpha * g[dst] ->
    demb = d_msg W_me^T (+ the downstream layers' carry), dW_me, db_me,
    d_alpha per head, dnm[src] += d_msg, dscale[src] += d_alpha * e;
  * torch glue: d_denom from dscale, the self-loop score cotangents;
  * pass 2 (`gat_bwd_pass2`): d_s = (d_alpha * scale[src] + d_denom[src]) * e
    -> dekb = d_s * nq[src], demb += dekb W_ke^T, dW_ke, db_ke,
    dnq[src] += d_s * key, dnk[dst] += dekb.

Both backward passes run the three products of a pass on tensor cores in
either dtype (csrc/gat_bwd_tc.cuh, `_bwd_route`; route 0, the CUDA-core
kernels, only when named). bfloat16: persistent blocks with W resident in
shared memory at D <= 256; past that one launch streams W, rounded to bf16
here (`_streamed_w`), through shared memory in chunks of its rows, twice a
round. float32: the same streaming kernel at every D, handed W itself in
f32, each product as three tf32 products of split operands (hi = tf32(x),
lo = x - hi; a_lo b_hi + a_hi b_lo + a_hi b_hi in f32, summed 16 of depth
at a time in a fresh accumulator), about 2^-20 relative a product at
worst against the 1e-4 the f32 passes are held to on the card.

No gradient flows through gmax. The chained form also returns the edge
embedding: threaded through the k layers, each layer's backward receives the
later layers' accumulated d_edge_emb as its carry and adds it inside pass 1,
so the sum over layers is never a separate (G, E, D) add.

Every kernel has a plain torch version here with the same arithmetic: node
and edge inputs in the compute dtype, the projection weights rounded to it,
everything after in f32 except where the TPU kernels round to the compute
dtype too (pass C's scale, alpha and weighted message; backward pass 1's
scale, alpha and d_alpha * e term, pass 2's scale, d_denom and d_s, each
before its broadcast or scatter; d_msg, dekb and the dnq term before products
and scatters; demb when stored). A wrapper takes
the plain version for CPU tensors only; for CUDA tensors it launches its
kernel or raises.

Unlike the TPU op the edge embedding is (G, E, D), not transposed, and no
edge padding is needed: any E works. A launch takes D and HD that are
multiples of 8, HD <= 256 and at most 8 heads (the backward also heads of at
least 4 features); the plain versions take any width, and the launches'
partial mode. The backward kernels take any such D: beyond 256 the
CUDA-core kernels' demb and dW launches run W's rows in slices
(`d_slices`), each slice writing its own columns of d_edge_emb or its own
rows of dW. On the tensor cores every backward pass makes its dW in one
more launch over all of its columns (`bwd_dw`, csrc/gat_dw.cu
`dw_wgmma_kernel`: wgmma fed by TMA, any D and HD). The op (`gat_projected`,
`gat_projected_chained`) pads other widths with zeros to ones the kernels
take (`kernel_widths`: D to a multiple of 8, each head's features to at
least 4 and to a multiple of 8 over the heads; to a multiple of 8 a head
where the heads take more than one launch), on every device, and cuts the
results back; a zero feature adds nothing to a score, a message or a
product, so the padding changes no value. Each pass wrapper runs more than 8
heads, or more than 256 columns, as groups of whole heads (`head_groups`),
one launch a group, on every device: every quantity of the op is per head,
and in a backward pass of more than one launch each launch writes its edge
cotangent rows into its columns of one (G, E, HD) array, of which one more
launch (`bwd_demb`, csrc/gat_demb.cu `demb_tc_kernel`) takes d_edge_emb
= cot W^T + carry (pass 1) or + pass 1's result (pass 2) over all HD
columns, rounded once a pass as the TPU's one launch rounds it (ROADMAP
C17). A single head of more than 256 features
is a group of its own, run as column slices of at most 256 (`col_slices`,
`launches`), one launch a slice, in order: pass C and backward pass 2 work
per column given the head's scores, scale and d_alpha, while pass A's
scores and backward pass 1's d_alpha sum over the head's columns, so each
slice's launch adds its f32 sums to those the slices before it left
(`partial`, the kernels' PART_ADD), and only the last takes the per-graph
max or adds d_alpha * e into dscale (PART_OPEN on the others): the one
non-linear step sees the whole sum, and no bf16 rounding is added.

The unprojected op (`pallas_relational_gat`: precomputed per-edge biases, no
projection in the kernels) is the sibling module `gat_unproj_kernels`, which
shares this module's helpers (`head_sum`, `heads_to_hd`, the node gathers
and scatters, the width and dtype checks).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from qagnn_tpu_torch.ops import _build

DENOM_EPS = 1e-16
NEG = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int


_SIGNATURES = {
    "gat_pass_a_scores": [_P] * 11 + [_I] * 11 + [_P],
    "gat_pass_a_denoms": [_P] * 6 + [_I] * 4 + [_P],
    "gat_pass_c": [_P] * 12 + [_I] * 10 + [_P],
}


_BWD_SIGNATURES = {
    "gat_bwd_pass1": [_P] * 23 + [_I] * 14 + [_P],
    "gat_bwd_pass2": [_P] * 23 + [_I] * 13 + [_P],
    "gat_bwd_demb": [_P] * 4 + [_I] * 6 + [_P],
    "gat_bwd_dw": [_P] * 4 + [_I] * 7 + [_P],
}
_DEMB_SIGNATURES = {
    "gat_demb_tc": [_P] * 5 + [ctypes.c_longlong] + [_I] * 6 + [_P],
}
_DW_SIGNATURES = {
    "gat_dw_tc": [_P] * 4 + [ctypes.c_longlong] + [_I] * 9 + [_P],
}
DW_SPLITS = 128      # edge ranges (rows of partials) of the dW products
# the tensor-core routes (csrc/gat_fwd_tc.cuh, csrc/gat_bwd_tc.cuh)
TC_UNIT = 16                 # edges a warp works on at a time
TC_MAX_WARPS = 8
TC_SMEM_LIMIT = 232_448      # dynamic shared memory a block may ask for
# the forward past D = 256 (csrc/gat_tc_common.cuh `TcStreamShape`): W's
# rows a chunk, chunks in the ring, and the tile's widths in columns with
# the warps a block of each may run (`tc_stream_pairs`, `tc_stream_warps`;
# tests/test_torch_gat_ops.py holds the two copies together)
TC_KC, TC_STAGES = 64, 2
STREAM_TILES = ((64, 12), (128, 12), (144, 12), (208, 8), (256, 8))
# the backward past D = 256 on the same ring: its tiles' widths, never
# under 128, and warps (csrc/gat_bwd_tc.cuh `tc_bwd_stream_pairs`,
# `tc_bwd_stream_warps`; tests/test_torch_bwd_streamed.py holds the two
# copies together)
BWD_STREAM_TILES = ((128, 12), (144, 12), (208, 8), (256, 8))
# the f32 route of both directions, streamed at every D (`TcStream32Shape`):
# W's f32 rows a chunk, and the tiles (the bf16 forward's widths) with their
# warps (tests/test_torch_bwd_f32_route.py and
# tests/test_torch_fwd_f32_route.py hold them to csrc)
TC_KC32 = 32
STREAM32_TILES = ((64, 8), (128, 8), (144, 8), (208, 8), (256, 8))
# rows 8 and 9's demb product on Hopper (csrc/gat_demb.cu `demb_tc_kernel`):
# the column tile widths each dtype's kernel is built at, a tile's slots
# (two consumer warpgroups of 2 x 64 rows in bf16, 64 in f32), W's tiles a
# slice (f32: hi and lo), the slices' depth in bytes (the 128-byte
# swizzle), the ring's most slots and the shared memory a block may ask for
# (tests/test_torch_demb_plan.py holds them to csrc)
DEMB_WIDTHS = {torch.bfloat16: (40, 72, 104, 136, 176, 200),
               torch.float32: (40, 72, 104, 136)}
DEMB_ROWS = {torch.bfloat16: 256, torch.float32: 128}
DEMB_B_TILES = {torch.bfloat16: 1, torch.float32: 2}
DEMB_SLICE = 128
DEMB_ALIGN = 1024
DEMB_MAX_STAGES = 8
# a plan's cost: its columns computed times the larger of 1 and this weight
# times the tile's operand elements a product, (BM + B_TILES BN) / (BM BN),
# which the L2 must bring the tile: in bf16 about the tensor cores' rate
# over the L2's (989 TFLOP/s against roughly 6 TB/s), so that wider tiles
# win where they waste few columns; in f32 less, the split-TF32 products
# bounding it (PERF.md: on an H100 the bf16 kernel ran fastest at 176 of
# 1040 and 512 columns, the f32 one at 104)
DEMB_L2_WEIGHT = {torch.bfloat16: 165.0, torch.float32: 40.0}
# rows 8 and 9's dW product on Hopper (csrc/gat_dw.cu `dw_wgmma_kernel`):
# the tiles (rows of dW, columns) each dtype's kernel is built at (bf16:
# two consumer warpgroups of 64 or 128 rows; f32: of 64), the slots a
# slice (BK), a column block's bytes (a TMA box's row, the 128-byte
# swizzle), the ring's most slots (tests/test_torch_dw_plan.py holds them
# to csrc)
DW_TILES = {torch.bfloat16: ((256, 64), (128, 128), (128, 192)),
            torch.float32: ((128, 64), (128, 96), (128, 128))}
DW_SLICE = {torch.bfloat16: 64, torch.float32: 32}
DW_BLOCK = 128
DW_ALIGN = 1024
DW_MAX_STAGES = 8
# the slot ranges' f32 partials at most this share of the operands' bytes
DW_PARTIAL_SHARE = 0.1
# the plan's model of a launch (an H100: the tensor cores' peak in the
# dtype, split TF32 at a third of tf32's, and what the L2 hands the SMs,
# 5.0 TB/s as the bf16 kernel drew it at gnn_dim 1040)
DW_PEAK = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
DW_L2_BYTES_PER_S = 5.0e12
DW_HBM_BYTES_PER_S = 3.35e12
# whether an item's L2 bytes add to its products' time: in bf16 they did
# on the H100 (the preset ran faster at 128 x 128 than at 128 x 192, which
# computes 50% more padded columns, for the same bytes); in f32 the split
# products hid them (at gnn_dim 1040 128 x 96 over 4 ranges ran 5.7-6.0
# ms, 128 x 128 over 13 6.3-6.5)
DW_L2_COSTS = {torch.bfloat16: True, torch.float32: False}


def _lib():
    return _build.load("gat_fwd", _SIGNATURES)


def _bwd_lib():
    return _build.load("gat_bwd", _BWD_SIGNATURES)


def _demb_lib():
    return _build.load("gat_demb", _DEMB_SIGNATURES)


def _dw_lib():
    return _build.load("gat_dw", _DW_SIGNATURES)


def _dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"GAT kernels take float32 or bfloat16, got {t.dtype}")


_require = _build.require


MAX_COLS, MAX_HEADS = 256, 8     # the columns and heads of one launch


def _check_widths(D: int, HD: int, heads: int) -> None:
    if D % 8 or HD % 8 or HD > MAX_COLS or heads > MAX_HEADS or HD % heads:
        raise ValueError(f"GAT kernels take D, HD multiples of 8, HD <= 256 "
                         f"and <= 8 heads dividing HD; got D={D}, HD={HD}, "
                         f"heads={heads}")


def _check_bwd_widths(D: int, HD: int, heads: int) -> None:
    _check_widths(D, HD, heads)
    if HD // heads < 4:
        raise ValueError(f"GAT backward kernels take heads of at least 4 "
                         f"features; got D={D}, HD={HD}, heads={heads}")


def d_slices(D: int) -> tuple[int, int]:
    """(slices, width) of W's rows in the backward's demb (route 0) and dW
    launches: D in equal slices of at most 256 rows, each a multiple of 8
    (the fewest such; one slice up to D = 256). D must be a multiple of
    8."""
    n = next(n for n in range(-(-D // MAX_COLS), D // 8 + 1)
             if D % n == 0 and (D // n) % 8 == 0)
    return n, D // n


def head_groups(HD: int, heads: int) -> list[tuple[int, int]]:
    """[(first head, end head)] of the launches that run `heads` heads of
    HD / heads features: one group where a launch takes them all, else as
    few groups of whole heads as hold at most 8 heads and 256 columns each,
    their sizes differing by one at most; a head of more than 256 features
    a group of its own, run in column slices (`col_slices`). Every quantity
    of the op is per head, so running the groups apart changes no value."""
    dph = HD // heads
    if heads <= MAX_HEADS and HD <= MAX_COLS:
        return [(0, heads)]
    per = max(1, min(MAX_HEADS, MAX_COLS // dph))
    n = -(-heads // per)
    bounds = [heads * i // n for i in range(n + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def col_slices(dph: int) -> list[tuple[int, int]]:
    """[(first column, end column)] of the launches that run one head of
    dph features: [(0, dph)] up to 256, else the fewest slices of at most
    256 columns, each a multiple of 8 (dph must be one), their widths
    differing by 8 at most."""
    if dph <= MAX_COLS:
        return [(0, dph)]
    if dph % 8:
        raise ValueError(f"a head of {dph} features runs in column slices "
                         "only at a multiple of 8 (`kernel_widths` pads it)")
    n, units = -(-dph // MAX_COLS), dph // 8
    bounds = [8 * (units * i // n) for i in range(n + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def group_cols(HD: int, heads: int, h0: int, h1: int) -> list[tuple[int, int]]:
    """[(c0, c1)] of the launches of head group [h0, h1) in a (..., HD)
    head-major row: the group's columns in one launch, or a head of more
    than 256 features (a group of its own) in column slices. The slices of
    one head run in order: rows 1, 4, 6 and 8 sum over a head's columns,
    each slice adding to the sums of the slices before it (`partial`)."""
    dph = HD // heads
    return [(h0 * dph + a, h0 * dph + b) for a, b in col_slices(dph)] \
        if dph > MAX_COLS else [(h0 * dph, h1 * dph)]


def launches(HD: int, heads: int) -> list[tuple[int, int, int, int]]:
    """[(h0, h1, c0, c1)]: every launch of a pass over HD head-major
    columns, its heads and its columns (`head_groups`, `group_cols`)."""
    return [(h0, h1, c0, c1) for h0, h1 in head_groups(HD, heads)
            for c0, c1 in group_cols(HD, heads, h0, h1)]


def cols(t: torch.Tensor, c0: int, c1: int) -> torch.Tensor:
    """Columns [c0, c1) of a (..., HD) tensor, contiguous."""
    return t[..., c0:c1].contiguous()


def col_view(t: torch.Tensor, c0: int, c1: int) -> torch.Tensor:
    """Columns [c0, c1) of a (..., HD) tensor as a view, read and written
    in place by the entry points that take row strides (rows 1, 3, 4 and
    5): c0 is a multiple of 8 (`col_slices`, whole heads of a padded
    width), so each view's rows stay 16-byte aligned."""
    return t[..., c0:c1]


def heads_of(t: torch.Tensor, h0: int, h1: int) -> torch.Tensor:
    """Heads [h0, h1) of a (..., H) per-head tensor, contiguous."""
    return t[..., h0:h1].contiguous()


# rows 1, 4, 6 and 8 over a column slice of a head wider than a launch
# (csrc/gat_common.cuh): add the slice's sums to those already in the
# output; more slices follow, so leave out what needs the whole sum (the
# max over the scores, the dscale term)
PART_ADD, PART_OPEN = 1, 2


def partial(acc, i: int, n: int) -> dict:
    """The keywords of launch i of the n that run one head group: none for
    a group in one launch; else the head sums of the slices before it
    (`acc`, None for the first slice) and whether it is the last."""
    return {} if n == 1 else {"acc": acc, "last": i == n - 1}


def _part(acc, last: bool) -> int:
    return (0 if acc is None else PART_ADD) | (0 if last else PART_OPEN)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def head_sum(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., HD) -> (..., H) per-head sum, head-major features."""
    return x.reshape(*x.shape[:-1], heads, x.shape[-1] // heads).sum(-1)


def heads_to_hd(x: torch.Tensor, hd: int) -> torch.Tensor:
    """(..., H) -> (..., HD) per-head broadcast."""
    h = x.shape[-1]
    return x.repeat_interleave(hd // h, dim=-1)


def _gather_nodes(nodes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(G, N, F) rows at (G, E) local indices -> (G, E, F)."""
    G, E = idx.shape
    return torch.gather(
        nodes, 1, idx.long()[..., None].expand(G, E, nodes.shape[-1]))


def _edge_projection_plain(edge_emb, w, b, cdt):
    """emb W + b per edge with emb and W rounded to cdt, in f32."""
    return edge_emb.to(cdt).float() @ w.to(cdt).float() + b.float()


# --------------------------------------------------------------------------
# pass A, scores
# --------------------------------------------------------------------------

def scores_and_max(scores, mask, acc=None, last=True):
    """Masked scores (G, H, E) f32 and their max over masked edges (G, H):
    with `acc` (the sums of a split head's slices before), the scores added
    to it in place; with `last` false the max left at NEG, as a launch of
    rows 1 and 6 leaves it before a split head's last slice."""
    live = mask[:, None, :]
    scores = torch.where(live, scores, 0.0)
    if acc is not None:
        scores = acc.add_(scores)
    m_edge = torch.where(live, scores, NEG).amax(-1)
    if not last:
        m_edge = torch.full_like(m_edge, NEG)
    return scores.contiguous(), torch.clamp_min(m_edge, NEG)


def pass_a_scores_plain(nq, nk, edge_emb, w_ke, b_ke, src, dst, mask, heads,
                        acc=None, last=True):
    ekb = _edge_projection_plain(edge_emb, w_ke, b_ke, nq.dtype)
    eq = _gather_nodes(nq, src).float()
    ek = _gather_nodes(nk, dst).float() + ekb
    return scores_and_max(head_sum(eq * ek, heads).transpose(1, 2), mask,
                          acc, last)


def by_head_groups(HD, heads, run, cat_dims):
    """run(h0, h1) for each of `head_groups(HD, heads)`; with more than one
    group, the results' parts concatenated along `cat_dims` (None: the last
    group's part, for a result every group gives alike)."""
    outs = [run(h0, h1) for h0, h1 in head_groups(HD, heads)]
    if len(outs) == 1:
        return outs[0]
    return tuple(parts[-1] if d is None else torch.cat(parts, d)
                 for parts, d in zip(zip(*outs), cat_dims))


def split_scores(launch, HD, heads, row_args, take=cols):
    """The scores (G, H, E) and their max (G, H) of rows 1 and 6 over every
    launch: launch(h0, h1, [column slices of row_args], **partial) for each
    head group and each of its column slices in order, a split head's
    slices summing into one scores array. `take` cuts a slice: a
    contiguous copy (`cols`, row 6) or a view (`col_view`, row 1)."""
    def run(h0, h1):
        spans, acc = group_cols(HD, heads, h0, h1), None
        for i, (c0, c1) in enumerate(spans):
            acc, m_edge = launch(h0, h1, [take(t, c0, c1) for t in row_args],
                                 **partial(acc, i, len(spans)))
        return acc, m_edge
    return by_head_groups(HD, heads, run, (1, 1))


def pass_a_scores(nq, nk, edge_emb, w_ke, b_ke, src, dst, mask, heads,
                  _route=None):
    """Scores (G, H, E) f32, 0 at masked slots, and the max over masked
    edges (G, H) f32 (NEG for a graph with no masked edge); a launch a head
    group, or a column slice of a head wider than 256 features. `_route`
    names a route (`_fwd_route`) to time it beside the other."""
    def launch(h0, h1, t, **part):
        q, k, w, b = t
        return _pass_a_scores(q, k, edge_emb, w, b, src, dst, mask, h1 - h0,
                              _route, **part)
    return split_scores(launch, nq.shape[-1], heads, (nq, nk, w_ke, b_ke))


def _pass_a_scores(nq, nk, edge_emb, w_ke, b_ke, src, dst, mask, heads,
                   _route, acc=None, last=True):
    if not nq.is_cuda:
        return pass_a_scores_plain(nq, nk, edge_emb, w_ke, b_ke, src, dst,
                                   mask, heads, acc, last)
    G, N, HD = nq.shape
    E, D = edge_emb.shape[1], edge_emb.shape[2]
    cdt = nq.dtype
    _check_widths(D, HD, heads)
    for name, t, shape in (("nq", nq, (G, N, HD)), ("nk", nk, (G, N, HD)),
                           ("edge_emb", edge_emb, (G, E, D))):
        _require(t, name, cdt, shape)
    _require(w_ke, "w_ke", torch.float32, (D, HD))
    _require(b_ke, "b_ke", torch.float32, (HD,))
    _require(src, "src", torch.int32, (G, E))
    _require(dst, "dst", torch.int32, (G, E))
    _require(mask, "mask", torch.bool, (G, E))
    route = _fwd_route(cdt, D, HD, heads, _route)
    warps, n_blocks = _fwd_launch_plan(route, G, E, D, HD, nq.device, cdt)
    ws = _streamed_w(route, w_ke, _fwd_streams, cdt)
    scores = _scores_out(acc, G, heads, E, nq.device)
    m_edge = torch.full((G, heads), NEG, device=nq.device,
                        dtype=torch.float32)
    err = _lib().gat_pass_a_scores(
        nq.data_ptr(), nk.data_ptr(), edge_emb.data_ptr(), w_ke.data_ptr(),
        None if ws is None else ws.data_ptr(), b_ke.data_ptr(),
        src.data_ptr(), dst.data_ptr(), mask.data_ptr(),
        scores.data_ptr(), m_edge.data_ptr(), G, N, E, D, HD, heads,
        _dtype_code(nq), route, warps, n_blocks, _part(acc, last), _stream())
    _build.check(err, "gat_pass_a_scores")
    _build.count_launch("gat_pass_a_scores", route)
    return scores, m_edge


def _scores_out(acc, G, H, E, device):
    """The (G, H, E) f32 array a launch of rows 1 and 6 writes its scores
    (or row 8 its d_alpha) into: `acc`, to which it adds, or a new one."""
    if acc is None:
        return torch.empty((G, H, E), device=device, dtype=torch.float32)
    _require(acc, "acc", torch.float32, (G, H, E))
    return acc


# --------------------------------------------------------------------------
# pass A, denominators and degrees
# --------------------------------------------------------------------------

def pass_a_denoms_plain(scores, gmax, src, mask, n_nodes):
    G, H, E = scores.shape
    e = torch.exp(torch.clamp_max(scores - gmax[:, :, None], 0.0)) \
        * mask[:, None, :]
    idx = src.long()
    denom = scores.new_zeros((G, n_nodes, H)).scatter_add_(
        1, idx[..., None].expand(G, E, H), e.transpose(1, 2))
    deg = scores.new_zeros((G, n_nodes)).scatter_add_(1, idx, mask.float())
    return denom, deg


def pass_a_denoms(scores, gmax, src, mask, n_nodes):
    """Per-source sums of exp(min(s - gmax, 0)) over masked edges (G, N, H)
    and the out-degree (G, N), both f32."""
    if not scores.is_cuda:
        return pass_a_denoms_plain(scores, gmax, src, mask, n_nodes)
    G, H, E = scores.shape
    _require(scores, "scores", torch.float32, (G, H, E))
    _require(gmax, "gmax", torch.float32, (G, H))
    _require(src, "src", torch.int32, (G, E))
    _require(mask, "mask", torch.bool, (G, E))
    denom = torch.zeros((G, n_nodes, H), device=scores.device,
                        dtype=torch.float32)
    deg = torch.zeros((G, n_nodes), device=scores.device, dtype=torch.float32)
    err = _lib().gat_pass_a_denoms(
        scores.data_ptr(), gmax.data_ptr(), src.data_ptr(), mask.data_ptr(),
        denom.data_ptr(), deg.data_ptr(), G, n_nodes, E, H, _stream())
    _build.check(err, "gat_pass_a_denoms")
    _build.count_launch("gat_pass_a_denoms")
    return denom, deg


# --------------------------------------------------------------------------
# pass C, aggregation
# --------------------------------------------------------------------------

def _round(x, cdt):
    """x rounded to the compute dtype, kept in f32 (the identity in f32)."""
    return x.to(cdt).float()


def pass_c_plain(nm, edge_emb, w_me, b_me, scores, gmax, scale, src, dst,
                 mask, out, heads):
    """Rounds where `_aggr_proj_kernel` rounds: the scale (packed into its
    compute-dtype node plane), alpha (before its per-head broadcast) and the
    weighted message (before its scatter)."""
    G, N, HD = nm.shape
    E = src.shape[1]
    cdt = nm.dtype
    msg = _gather_nodes(nm, src).float() \
        + _edge_projection_plain(edge_emb, w_me, b_me, cdt)
    e = torch.exp(torch.clamp_max(scores - gmax[:, :, None], 0.0)) \
        * mask[:, None, :]
    alpha = _round(e.transpose(1, 2)
                   * _gather_nodes(_round(scale, cdt), src), cdt)   # (G,E,H)
    w = _round(msg * heads_to_hd(alpha, HD), cdt)
    return out.scatter_add_(1, dst.long()[..., None].expand(G, E, HD), w)


def pass_c(nm, edge_emb, w_me, b_me, scores, gmax, scale, src, dst, mask,
           out, heads, _route=None):
    """Adds alpha * msg of every masked edge at its dst into `out`
    (G, N, HD) f32, IN PLACE (the caller seeds it with the self-loop term;
    no second (G, N, HD) buffer), and returns it; a launch a head group or
    a column slice of a head wider than 256 features (`launches`), each on
    its own columns of `out`. `_route` as in `pass_a_scores`."""
    plan = launches(nm.shape[-1], heads)
    if len(plan) == 1:
        return _pass_c(nm, edge_emb, w_me, b_me, scores, gmax, scale, src,
                       dst, mask, out, heads, _route)
    for h0, h1, c0, c1 in plan:
        out[..., c0:c1] = _pass_c(
            cols(nm, c0, c1), edge_emb, cols(w_me, c0, c1),
            cols(b_me, c0, c1), scores[:, h0:h1].contiguous(),
            heads_of(gmax, h0, h1), heads_of(scale, h0, h1), src, dst, mask,
            cols(out, c0, c1), h1 - h0, _route)
    return out


def _pass_c(nm, edge_emb, w_me, b_me, scores, gmax, scale, src, dst, mask,
            out, heads, _route):
    if not nm.is_cuda:
        return pass_c_plain(nm, edge_emb, w_me, b_me, scores, gmax, scale,
                            src, dst, mask, out, heads)
    G, N, HD = nm.shape
    E, D = edge_emb.shape[1], edge_emb.shape[2]
    cdt = nm.dtype
    _check_widths(D, HD, heads)
    _require(nm, "nm", cdt, (G, N, HD))
    _require(edge_emb, "edge_emb", cdt, (G, E, D))
    _require(w_me, "w_me", torch.float32, (D, HD))
    _require(b_me, "b_me", torch.float32, (HD,))
    _require(scores, "scores", torch.float32, (G, heads, E))
    _require(gmax, "gmax", torch.float32, (G, heads))
    _require(scale, "scale", torch.float32, (G, N, heads))
    _require(src, "src", torch.int32, (G, E))
    _require(dst, "dst", torch.int32, (G, E))
    _require(mask, "mask", torch.bool, (G, E))
    _require(out, "out", torch.float32, (G, N, HD))
    route = _fwd_route(cdt, D, HD, heads, _route)
    warps, n_blocks = _fwd_launch_plan(route, G, E, D, HD, nm.device, cdt)
    ws = _streamed_w(route, w_me, _fwd_streams, cdt)
    err = _lib().gat_pass_c(
        nm.data_ptr(), edge_emb.data_ptr(), w_me.data_ptr(),
        None if ws is None else ws.data_ptr(), b_me.data_ptr(),
        scores.data_ptr(), gmax.data_ptr(), scale.data_ptr(), src.data_ptr(),
        dst.data_ptr(), mask.data_ptr(), out.data_ptr(), G, N, E, D, HD,
        heads, _dtype_code(nm), route, warps, n_blocks, _stream())
    _build.check(err, "gat_pass_c")
    _build.count_launch("gat_pass_c", route)
    return out


# --------------------------------------------------------------------------
# the op, forward
# --------------------------------------------------------------------------

def gat_projected_forward(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me,
                          skb, smb, src, dst, mask, heads):
    """Fused sparse attention core with the edge projections in-kernel.

    nq/nk/nm: (G, N, HD) node projections in the compute dtype (query
    pre-scaled by 1/sqrt(dph)); edge_emb: (G, E, D) shared edge embedding in
    the compute dtype; w_ke/w_me: (D, HD) f32, b_ke/b_me: (HD,) f32;
    skb/smb: (G, N, HD) projected self-loop biases; src/dst: (G, E) int32
    local indices; mask: (G, E) bool.

    Returns (out (G, N, HD) f32, scores (G, H, E) f32, gmax (G, H) f32,
    denom_raw (G, N, H) f32, scale (G, N, H) f32, e_self (G, N, H) f32):
    the output and what the backward keeps.
    """
    G, N, HD = nq.shape
    scores, m_edge = pass_a_scores(nq, nk, edge_emb, w_ke, b_ke, src, dst,
                                   mask, heads)
    self_scores = head_sum(nq.float() * (nk + skb).float(), heads)  # (G,N,H)
    gmax = torch.maximum(m_edge, self_scores.amax(1))                 # (G,H)
    e_self = torch.exp(self_scores - gmax[:, None, :])
    denom_edges, deg = pass_a_denoms(scores, gmax, src, mask, N)
    denom_raw = denom_edges + e_self
    scale = (deg[..., None] + 1.0) / torch.clamp_min(denom_raw, DENOM_EPS)
    out = (nm.float() + smb.float()) * heads_to_hd(e_self * scale, HD)
    out = pass_c(nm, edge_emb, w_me, b_me, scores, gmax, scale, src, dst,
                 mask, out, heads)
    return out, scores, gmax, denom_raw, scale, e_self


# --------------------------------------------------------------------------
# backward pass 1 (message side)
# --------------------------------------------------------------------------

def _edge_exp(scores, gmax, mask):
    """e = exp(min(s - gmax, 0)) over masked edges, 0 elsewhere: (G, E, H)."""
    e = torch.exp(torch.clamp_max(scores - gmax[:, :, None], 0.0))
    return torch.where(mask[:, None, :], e, 0.0).transpose(1, 2)


def _scatter_nodes(acc, idx, vals):
    """acc (G, N, F) += vals (G, E, F) at (G, E) local indices, in place."""
    G, E = idx.shape
    return acc.scatter_add_(
        1, idx.long()[..., None].expand(G, E, vals.shape[-1]), vals)


def bwd_dw_plain(edge_emb, cot):
    """dW = emb^T cot over all G E slots, in f32: edge_emb (G, E, D), cot
    (G, E, HD), both in the pass's dtype."""
    D, HD = edge_emb.shape[-1], cot.shape[-1]
    return edge_emb.float().reshape(-1, D).t() @ cot.float().reshape(-1, HD)


def _weight_grads(edge_emb, cot_c, cot):
    """(emb^T cot_c over all edges (D, HD), column sums of cot (HD,))."""
    return bwd_dw_plain(edge_emb, cot_c), cot.sum((0, 1))


def bwd_pass1_plain(gout, nm, edge_emb, w_me, b_me, scores, gmax, scale, src,
                    dst, mask, carry, dnm, dscale, heads, acc=None,
                    last=True, cot=None):
    """With `cot` (a (G, E, HD) array or view), the launch of a pass of
    several (`bwd_pass1`): d_msg goes there and stands in demb's place in
    the result, and the demb and dW products are left to `bwd_demb` and
    `bwd_dw` (dW is None)."""
    cdt = nm.dtype
    HD = nm.shape[-1]
    msg = _gather_nodes(nm, src).float() \
        + _edge_projection_plain(edge_emb, w_me, b_me, cdt)
    g_dst = _gather_nodes(gout, dst).float()
    e = _edge_exp(scores, gmax, mask)                               # (G,E,H)
    alpha = _round(e * _gather_nodes(_round(scale, cdt), src), cdt)
    d_msg = heads_to_hd(alpha, HD) * g_dst
    d_msg_c = d_msg.to(cdt)
    if cot is None:
        demb = bwd_demb_plain(d_msg_c, w_me, carry, edge_emb.dtype)
    else:
        demb = cot.copy_(d_msg_c)
    dalpha = split_dalpha(head_sum(msg * g_dst, heads), mask, acc)
    dw, db = _weight_grads(edge_emb, d_msg_c, d_msg)
    if cot is not None:
        dw = None
    _scatter_nodes(dnm, src, d_msg_c.float())
    if last:
        _scatter_nodes(dscale, src,
                       _round(dalpha.transpose(1, 2) * e, cdt))
    return demb, dalpha, dnm, dscale, dw, db


def bwd_demb_plain(cot, w, add=None, dtype=None):
    """demb = cot W^T (+ add) in f32 with W rounded to cot's dtype,
    rounded once to `dtype` (cot's by default)."""
    demb = cot.float() @ w.to(cot.dtype).float().t()
    if add is not None:
        demb = demb + add.float()
    return demb.to(dtype or cot.dtype)


def split_dalpha(dalpha, mask, acc=None):
    """d_alpha (G, E, H), 0 at masked slots, as (G, H, E) f32: with `acc`
    (the sums of a split head's slices before), added to it in place."""
    dalpha = torch.where(mask[..., None], dalpha, 0.0).transpose(1, 2)
    return dalpha.contiguous() if acc is None else acc.add_(dalpha)


def _bwd_route(cdt, route):
    """0: CUDA cores, 1: tensor cores, the route in both dtypes: bf16
    products in bfloat16, split-TF32 products in float32 (hi = tf32(x), lo
    = x - hi, then lo hi + hi lo + hi hi, summed 16 of depth at a time in a
    fresh accumulator: about 2^-20 of |a| |b| a product at worst, within
    6.2e-6 of the plain versions on the card against the 1e-4 they are held
    to; bound by the tf32 rate, 495 TFLOP/s for a third as many
    f32-accurate operations). On an NVIDIA H100 80GB HBM3 (700 W) an f32
    call of pass 1 / 2 takes 2.00 / 1.93 ms at D = HD = 200 against route
    0's 3.49 / 3.31, 43.0-43.5 / 43.2-43.3 ms at gnn_dim 1040 against 88.2
    / 83.3 (PERF.md PR 21). `route` 0 names the CUDA-core kernels in either
    dtype, to time them beside the tensor-core ones."""
    if route is None:
        return 1
    if route not in (0, 1):
        raise ValueError(f"no route {route} of the GAT backward kernels for "
                         f"{cdt}")
    return route


def _fwd_route(cdt, D, HD, heads, route):
    """Route of the forward passes A (scores) and C: 0 CUDA cores, 1 tensor
    cores where their widths hold (any D, HD <= 256, heads of at least 4
    features), in either dtype: bf16 products in bfloat16, split-TF32
    products in float32 (as `_bwd_route` says; within 6.3e-7 of the plain
    versions on the card, where one tf32 product would miss the 1e-4 they
    are held to). On an NVIDIA H100 80GB HBM3 (700 W) an f32 launch of
    pass A / C takes 0.66 / 0.64 ms at D = HD = 200 against route 0's 0.92
    / 0.85, a call 3.70 / 3.74 ms at gnn_dim 512 against 4.10 / 4.01 and
    13.7 ms at 1040 against 19.3 / 19.2 (PERF.md PR 21). Widths alone
    decide; `route` names one, 0 to time the CUDA-core kernels beside the
    tensor-core ones."""
    fits = HD <= MAX_COLS and HD // heads >= 4
    if route is None:
        return 1 if fits else 0
    if route not in (0, 1) or (route == 1 and not fits):
        raise ValueError(f"no route {route} of the GAT forward kernels for "
                         f"{cdt}, D={D}, HD={HD}, heads={heads}")
    return route


def _tc_smem(D, HD, warps, small_floats):
    """Dynamic shared memory of a tensor-core edge kernel (`TcShape` in
    csrc/gat_tc_common.cuh), which is compiled for widths of 64, 128, 208
    and 256 columns: W in bf16 at the first of these that holds D and HD,
    then per warp a stage (16 f32 rows of that width) and its small tables
    of `small_floats` floats."""
    width = next(w for w in (64, 128, 208, 256) if max(D, HD) <= w)
    w_tile = width * (width + 8) * 2
    stage = TC_UNIT * (width + 4) * 4
    return w_tile + warps * (stage + small_floats * 4)


def _stream_smem(width, warps, small_floats):
    """Dynamic shared memory of a streaming edge kernel (`TcStreamShape`)
    whose tile is `width` columns: W passes through a ring of TC_STAGES
    chunks of TC_KC rows, and each warp's stage holds its ring of emb chunks
    (16 rows of TC_KC) and then its f32 rows, beside its small tables."""
    ring = TC_STAGES * TC_KC * (width + 8) * 2
    stage = max(TC_UNIT * (width + 4) * 4,
                TC_STAGES * TC_UNIT * (TC_KC + 8) * 2)
    return ring + warps * (stage + small_floats * 4)


def _bwd_streams(D, cdt=torch.bfloat16):
    """Whether route 1 of the backward passes streams W's rows through
    shared memory or holds W there whole: bf16 past D = 256, f32 at every
    D (W's f32 rows whole would leave room for three warps at D = HD =
    200). The one place that decides: the kernel streams exactly when the
    wrapper hands it W to stream (`_streamed_w`)."""
    return cdt == torch.float32 or D > MAX_COLS


def _bwd_stream_tile(HD, cdt=torch.bfloat16):
    """(columns, most warps a block) of the backward streaming kernel's
    tile for a launch of HD columns: the first of BWD_STREAM_TILES (f32:
    STREAM32_TILES) to hold HD."""
    tiles = STREAM32_TILES if cdt == torch.float32 else BWD_STREAM_TILES
    return next(t for t in tiles if HD <= t[0])


def _stream32_smem(width, warps, small_floats):
    """Dynamic shared memory of the f32 streaming edge kernel
    (`TcStream32Shape`): a ring of TC_STAGES chunks of TC_KC32 f32 rows of
    W, then per warp a stage that holds its ring of f32 emb chunks and then
    its f32 rows, beside its small tables."""
    ring = TC_STAGES * TC_KC32 * (width + 8) * 4
    stage = max(TC_UNIT * (width + 4) * 4,
                TC_STAGES * TC_UNIT * (TC_KC32 + 4) * 4)
    return ring + warps * (stage + small_floats * 4)


def _tc_smem_bytes(D, HD, warps, cdt=torch.bfloat16):
    """The backward edge kernel's (alpha or d_s, e, d_alpha and the nodes
    beside each stage; the cotangent rows go over the f32 rows)."""
    small = 3 * TC_UNIT * 8 + 2 * TC_UNIT
    if cdt == torch.float32:
        return _stream32_smem(_bwd_stream_tile(HD, cdt)[0], warps, small)
    if not _bwd_streams(D):
        return _tc_smem(D, HD, warps, small)
    return _stream_smem(_bwd_stream_tile(HD)[0], warps, small)


def _fwd_streams(D, cdt=torch.bfloat16):
    """Whether route 1 of the forward streams W's rows through shared
    memory or holds W there whole: bf16 past D = 256, f32 at every D (W's
    f32 rows whole would leave room for three warps at D = HD = 200). The
    one place that decides: the kernel streams exactly when the wrapper
    hands it W to stream (`_streamed_w`)."""
    return cdt == torch.float32 or D > MAX_COLS


def _stream_tile(HD, cdt=torch.bfloat16):
    """(columns, most warps a block) of the streaming kernel's tile for a
    launch of HD columns: the first of STREAM_TILES (f32: STREAM32_TILES)
    to hold HD."""
    tiles = STREAM32_TILES if cdt == torch.float32 else STREAM_TILES
    return next(t for t in tiles if HD <= t[0])


def _fwd_smem_bytes(D, HD, warps, cdt=torch.bfloat16):
    """The forward kernel's (scores or alpha and the nodes beside each
    stage; no cotangent tile), W whole or streamed (`_stream_smem`; f32:
    `_stream32_smem`)."""
    small = TC_UNIT * 8 + 2 * TC_UNIT
    if cdt == torch.float32:
        return _stream32_smem(_stream_tile(HD, cdt)[0], warps, small)
    if not _fwd_streams(D):
        return _tc_smem(D, HD, warps, small)
    return _stream_smem(_stream_tile(HD)[0], warps, small)


def _persistent_plan(smem_bytes, G, E, D, HD, n_sm, what,
                     max_warps=TC_MAX_WARPS):
    """(warps per block, blocks): as many warps as shared memory holds
    beside W, up to `max_warps`, one persistent block per SM, no more
    blocks than units of work for their warps."""
    warps = max((w for w in range(1, max_warps + 1)
                 if smem_bytes(D, HD, w) <= TC_SMEM_LIMIT), default=0)
    if warps == 0:
        raise ValueError(f"{what}: D={D}, HD={HD} leave no shared memory for "
                         "a warp beside W")
    units = G * -(-E // TC_UNIT)
    return warps, max(1, min(n_sm, -(-units // warps)))


def _tc_plan(G, E, D, HD, n_sm, cdt=torch.bfloat16):
    """The backward tensor-core edge kernel's plan in `cdt`, W whole or
    streamed."""
    max_warps = _bwd_stream_tile(HD, cdt)[1] if _bwd_streams(D, cdt) \
        else TC_MAX_WARPS
    return _persistent_plan(
        lambda D_, HD_, w: _tc_smem_bytes(D_, HD_, w, cdt), G, E, D, HD,
        n_sm, "GAT backward", max_warps)


def _fwd_max_warps(D, HD, cdt=torch.bfloat16):
    """Warps a block of the forward tensor-core kernel may run: the
    streaming tile's (`tc_fwd_max_warps`: by tile in bf16, TC_MAX_WARPS in
    f32), else TC_MAX_WARPS."""
    if cdt == torch.float32:
        return _stream_tile(HD, cdt)[1]
    return _stream_tile(HD)[1] if _fwd_streams(D) else TC_MAX_WARPS


def _fwd_tc_plan(G, E, D, HD, n_sm, cdt=torch.bfloat16):
    """The forward tensor-core kernel's plan in `cdt` (passes A and C
    alike), W whole or streamed."""
    return _persistent_plan(
        lambda D_, HD_, w: _fwd_smem_bytes(D_, HD_, w, cdt), G, E, D, HD,
        n_sm, "GAT forward", _fwd_max_warps(D, HD, cdt))


def _streamed_w(route, w, streams, cdt=torch.bfloat16):
    """W (D, HD) as route 1 streams its rows from device memory through
    shared memory once a round of units: in bf16 rounded to bf16 (half the
    bytes of f32 rows, no rounding in the ring) where `streams(D)` (the
    direction's decision: `_fwd_streams` or `_bwd_streams`); in f32 (the
    split-TF32 routes of both directions, which stream at every D) W
    itself, unrounded. None elsewhere: route 0 and the resident kernel
    round W as they load it."""
    if route != 1:
        return None
    if cdt == torch.float32:
        return w
    return w.to(torch.bfloat16) if streams(w.shape[0]) else None


def _fwd_launch_plan(route, G, E, D, HD, device, cdt):
    """(warps, n_blocks) for the forward kernels' C entry points: the
    tensor-core plan in `cdt` on route 1; route 0's grid follows from the
    shapes."""
    if route == 0:
        return 0, 0
    return _fwd_tc_plan(G, E, D, HD, _sm_count(device), cdt)


def _split_scratch(G, E, D, HD, device, route=0, n_sm=1,
                   cdt=torch.bfloat16):
    """(n_split, warps, n_blocks, dw_part, db_part): the partial sums of db,
    one row per block of the edge kernel, and on CUDA cores of dW over
    n_split edge ranges, dw_part (n_split, D, HD): (64-edge tile, graph)
    blocks on CUDA cores (warps and n_blocks are 0: that grid follows from
    the shapes), n_blocks persistent blocks on tensor cores (`_tc_plan` in
    `cdt`: W whole, or its rows streamed), whose pass makes no dW (n_split
    0, dw_part None: one `bwd_dw` launch a pass makes it)."""
    if route == 1:
        warps, n_blocks = _tc_plan(G, E, D, HD, n_sm, cdt)
        return (0, warps, n_blocks, None,
                torch.empty((n_blocks, HD), device=device,
                            dtype=torch.float32))
    n_split = max(1, min(DW_SPLITS, -(-G * E // 32)))
    return (n_split, 0, 0,
            torch.empty((n_split, D, HD), device=device, dtype=torch.float32),
            torch.empty((G * -(-E // 64), HD), device=device,
                        dtype=torch.float32))


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _sliced_transpose(w, width):
    """W (D, HD) as its transpose in slices of `width` of W's rows, slice
    major: (D / width, HD, width), what route 0's demb launch reads a
    slice at a time (W^T itself where one slice holds D)."""
    D, HD = w.shape
    return w.t().reshape(HD, D // width, width).transpose(0, 1).contiguous()


def bwd_pass1(gout, nm, edge_emb, w_me, b_me, scores, gmax, scale, src, dst,
              mask, carry, dnm, dscale, heads, _route=None):
    """Backward pass 1. gout: (G, N, HD) output cotangent in the compute
    dtype; carry: (G, E, D) in the embedding's dtype or None; dnm (G, N, HD)
    and dscale (G, N, H) f32 arrive seeded with the self-loop cotangents and
    are added to IN PLACE.

    Returns (demb (G, E, D) in the embedding's dtype, d_alpha (G, H, E) f32
    (0 at masked slots), dnm, dscale, dW_me (D, HD) f32, db_me (HD,) f32).
    A launch a head group, or a column slice of a head wider than 256
    features: a split head's slices sum its d_alpha in order, the last
    adding d_alpha * e into dscale. A pass of more than one launch leaves
    demb to one product over all HD columns: each launch writes its
    cotangent rows into its columns of one (G, E, HD) array, and
    `bwd_demb` sums d_msg W_me^T + carry in f32 and rounds it once, as the
    TPU's one launch over all columns does.
    """
    HD = nm.shape[-1]
    if len(launches(HD, heads)) == 1:
        return _bwd_pass1(gout, nm, edge_emb, w_me, b_me, scores, gmax,
                          scale, src, dst, mask, carry, dnm, dscale, heads,
                          _route)
    cot = _cot_rows(src, HD, nm)
    dalphas, dws, dbs = [], [], []
    for h0, h1 in head_groups(HD, heads):
        spans, dalpha = group_cols(HD, heads, h0, h1), None
        node = (scores[:, h0:h1].contiguous(), heads_of(gmax, h0, h1),
                heads_of(scale, h0, h1), src, dst, mask)
        ds = heads_of(dscale, h0, h1)
        for i, (c0, c1) in enumerate(spans):
            _, dalpha, dnm[..., c0:c1], ds, dw, db = _bwd_pass1(
                cols(gout, c0, c1), cols(nm, c0, c1), edge_emb,
                cols(w_me, c0, c1), cols(b_me, c0, c1), *node, None,
                cols(dnm, c0, c1), ds, h1 - h0, _route,
                cot=col_view(cot, c0, c1), **partial(dalpha, i, len(spans)))
            dws.append(dw)
            dbs.append(db)
        dscale[..., h0:h1] = ds
        dalphas.append(dalpha)
    demb = bwd_demb(cot, w_me, carry, None, _route)
    return (demb, torch.cat(dalphas, 1), dnm, dscale,
            _pass_dw(edge_emb, cot, dws), torch.cat(dbs, 0))


def _pass_dw(edge_emb, cot, dws):
    """dW of a pass of several launches: route 0's launches each make their
    columns' (the CUDA-core kernels); route 1's and the plain versions
    leave it (None) to one `bwd_dw` product over all columns of the pass's
    cotangent rows."""
    return bwd_dw(edge_emb, cot) if dws[0] is None else torch.cat(dws, 1)


def _cot_rows(src, HD, like):
    """The (G, E, HD) array, in `like`'s dtype and on its device, into whose
    columns the launches of a pass of several write their cotangent rows
    for `bwd_demb`."""
    return torch.empty((*src.shape, HD), device=like.device, dtype=like.dtype)


def _bwd_pass1(gout, nm, edge_emb, w_me, b_me, scores, gmax, scale, src, dst,
               mask, carry, dnm, dscale, heads, _route, acc=None, last=True,
               cot=None):
    """One launch of pass 1. With `cot` (the launch's columns of a pass's
    cotangent rows, `_cot_rows`; carry None) it writes d_msg there, makes no
    demb product, and returns `cot` in demb's place. On route 1 the edge
    launch makes no dW: one `bwd_dw` launch takes it from d_msg, or, with
    `cot`, is left to the caller (dW None)."""
    if not nm.is_cuda:
        return bwd_pass1_plain(gout, nm, edge_emb, w_me, b_me, scores, gmax,
                               scale, src, dst, mask, carry, dnm, dscale,
                               heads, acc, last, cot)
    G, N, HD = nm.shape
    E, D = edge_emb.shape[1], edge_emb.shape[2]
    cdt = nm.dtype
    _check_bwd_widths(D, HD, heads)
    _require(gout, "gout", cdt, (G, N, HD))
    _require(nm, "nm", cdt, (G, N, HD))
    _require(edge_emb, "edge_emb", cdt, (G, E, D))
    _require(w_me, "w_me", torch.float32, (D, HD))
    _require(b_me, "b_me", torch.float32, (HD,))
    _require(scores, "scores", torch.float32, (G, heads, E))
    _require(gmax, "gmax", torch.float32, (G, heads))
    _require(scale, "scale", torch.float32, (G, N, heads))
    _require(src, "src", torch.int32, (G, E))
    _require(dst, "dst", torch.int32, (G, E))
    _require(mask, "mask", torch.bool, (G, E))
    if carry is not None:
        _require(carry, "carry", cdt, (G, E, D))
    _require(dnm, "dnm", torch.float32, (G, N, HD))
    _require(dscale, "dscale", torch.float32, (G, N, heads))
    dev = nm.device
    if cot is None:
        dmsg, ld = nm.new_empty((G, E, HD)), HD
        demb = torch.empty((G, E, D), device=dev, dtype=cdt)
    elif carry is not None:
        raise ValueError("a launch that leaves demb to bwd_demb takes no "
                         "carry")
    else:
        dmsg, demb = cot, None
        ld = _build.require_rows(cot, "cot", cdt, (G, E, HD))
    route = _bwd_route(cdt, _route)
    width = d_slices(D)[1]
    # the tensor-core kernels read W_me both ways from one shared tile or
    # ring of its rows
    w_t = None if route == 1 else _sliced_transpose(w_me, width)
    ws = _streamed_w(route, w_me, _bwd_streams, cdt)
    dalpha = _scores_out(acc, G, heads, E, dev)
    dw = None if route == 1 else \
        torch.empty((D, HD), device=dev, dtype=torch.float32)
    db = torch.empty((HD,), device=dev, dtype=torch.float32)
    n_split, warps, n_blocks, dw_part, db_part = _split_scratch(
        G, E, D, HD, dev, route, _sm_count(dev), cdt)
    err = _bwd_lib().gat_bwd_pass1(
        gout.data_ptr(), nm.data_ptr(), edge_emb.data_ptr(), w_me.data_ptr(),
        None if w_t is None else w_t.data_ptr(), b_me.data_ptr(),
        scores.data_ptr(), gmax.data_ptr(),
        scale.data_ptr(), src.data_ptr(), dst.data_ptr(), mask.data_ptr(),
        None if carry is None else carry.data_ptr(), dmsg.data_ptr(),
        None if demb is None else demb.data_ptr(), dalpha.data_ptr(),
        dnm.data_ptr(), dscale.data_ptr(),
        None if dw_part is None else dw_part.data_ptr(), db_part.data_ptr(),
        None if dw is None else dw.data_ptr(), db.data_ptr(),
        None if ws is None else ws.data_ptr(), G, N, E, D, HD, heads,
        n_split, width, _dtype_code(nm), route, warps, n_blocks,
        _part(acc, last), ld, _stream())
    _build.check(err, "gat_bwd_pass1")
    _build.count_launch("gat_bwd_pass1", route)
    if route == 1 and cot is None:
        dw = bwd_dw(edge_emb, dmsg)
    return dmsg if demb is None else demb, dalpha, dnm, dscale, dw, db


# --------------------------------------------------------------------------
# backward pass 2 (score side)
# --------------------------------------------------------------------------

def bwd_pass2_plain(nq, nk, edge_emb, w_ke, b_ke, scores, gmax, dalpha, scale,
                    d_denom, src, dst, mask, demb, dnq, dnk, heads, cot=None):
    """With `cot`, as in `bwd_pass1_plain`: dekb goes there and stands in
    demb's place in the result, demb (which may be None) is left to
    `bwd_demb` and dW to `bwd_dw` (None)."""
    cdt = nq.dtype
    HD = nq.shape[-1]
    key = _gather_nodes(nk, dst).float() \
        + _edge_projection_plain(edge_emb, w_ke, b_ke, cdt)
    q_src = _gather_nodes(nq, src).float()
    scale_src = _gather_nodes(_round(scale, cdt), src)
    d_s = _round((dalpha.transpose(1, 2) * scale_src
                  + _gather_nodes(_round(d_denom, cdt), src))
                 * _edge_exp(scores, gmax, mask), cdt)
    ds_hd = heads_to_hd(d_s, HD)
    dekb = ds_hd * q_src
    dekb_c = dekb.to(cdt)
    if cot is None:
        demb = bwd_demb_plain(dekb_c, w_ke, demb, demb.dtype)
    else:
        demb = cot.copy_(dekb_c)
    dw, db = _weight_grads(edge_emb, dekb_c, dekb)
    if cot is not None:
        dw = None
    _scatter_nodes(dnq, src, (ds_hd * key).to(cdt).float())
    _scatter_nodes(dnk, dst, dekb_c.float())
    return demb, dnq, dnk, dw, db


def bwd_pass2(nq, nk, edge_emb, w_ke, b_ke, scores, gmax, dalpha, scale,
              d_denom, src, dst, mask, demb, dnq, dnk, heads, _route=None):
    """Backward pass 2. demb (G, E, D) is pass 1's result and is added to IN
    PLACE on the kernel path, as are dnq and dnk (G, N, HD) f32, which
    arrive seeded with the self-loop cotangents.

    Returns (demb, dnq, dnk, dW_ke (D, HD) f32, db_ke (HD,) f32). A launch
    a head group or a column slice of a head wider than 256 features
    (`launches`); a pass of more than one leaves demb += dekb W_ke^T to one
    product over all HD columns (`bwd_demb`, rounded once, as in
    `bwd_pass1`)."""
    plan = launches(nq.shape[-1], heads)
    if len(plan) == 1:
        return _bwd_pass2(nq, nk, edge_emb, w_ke, b_ke, scores, gmax, dalpha,
                          scale, d_denom, src, dst, mask, demb, dnq, dnk,
                          heads, _route)
    cot = _cot_rows(src, nq.shape[-1], nq)
    dws, dbs = [], []
    for h0, h1, c0, c1 in plan:
        _, dnq[..., c0:c1], dnk[..., c0:c1], dw, db = _bwd_pass2(
            cols(nq, c0, c1), cols(nk, c0, c1), edge_emb, cols(w_ke, c0, c1),
            cols(b_ke, c0, c1), scores[:, h0:h1].contiguous(),
            heads_of(gmax, h0, h1), dalpha[:, h0:h1].contiguous(),
            heads_of(scale, h0, h1), heads_of(d_denom, h0, h1), src, dst,
            mask, None, cols(dnq, c0, c1), cols(dnk, c0, c1), h1 - h0, _route,
            cot=col_view(cot, c0, c1))
        dws.append(dw)
        dbs.append(db)
    demb = bwd_demb(cot, w_ke, demb, demb, _route)
    return demb, dnq, dnk, _pass_dw(edge_emb, cot, dws), torch.cat(dbs, 0)


def _bwd_pass2(nq, nk, edge_emb, w_ke, b_ke, scores, gmax, dalpha, scale,
               d_denom, src, dst, mask, demb, dnq, dnk, heads, _route,
               cot=None):
    """One launch of pass 2; with `cot` as `_bwd_pass1` (demb not read),
    and dW as there."""
    if not nq.is_cuda:
        return bwd_pass2_plain(nq, nk, edge_emb, w_ke, b_ke, scores, gmax,
                               dalpha, scale, d_denom, src, dst, mask, demb,
                               dnq, dnk, heads, cot)
    G, N, HD = nq.shape
    E, D = edge_emb.shape[1], edge_emb.shape[2]
    cdt = nq.dtype
    _check_bwd_widths(D, HD, heads)
    _require(nq, "nq", cdt, (G, N, HD))
    _require(nk, "nk", cdt, (G, N, HD))
    _require(edge_emb, "edge_emb", cdt, (G, E, D))
    _require(w_ke, "w_ke", torch.float32, (D, HD))
    _require(b_ke, "b_ke", torch.float32, (HD,))
    _require(scores, "scores", torch.float32, (G, heads, E))
    _require(gmax, "gmax", torch.float32, (G, heads))
    _require(dalpha, "dalpha", torch.float32, (G, heads, E))
    _require(scale, "scale", torch.float32, (G, N, heads))
    _require(d_denom, "d_denom", torch.float32, (G, N, heads))
    _require(src, "src", torch.int32, (G, E))
    _require(dst, "dst", torch.int32, (G, E))
    _require(mask, "mask", torch.bool, (G, E))
    if cot is None:
        _require(demb, "demb", cdt, (G, E, D))
    _require(dnq, "dnq", torch.float32, (G, N, HD))
    _require(dnk, "dnk", torch.float32, (G, N, HD))
    dev = nq.device
    if cot is None:
        dekb, ld = nq.new_empty((G, E, HD)), HD
    else:
        dekb, demb = cot, None
        ld = _build.require_rows(cot, "cot", cdt, (G, E, HD))
    route = _bwd_route(cdt, _route)
    width = d_slices(D)[1]
    w_t = None if route == 1 else _sliced_transpose(w_ke, width)
    ws = _streamed_w(route, w_ke, _bwd_streams, cdt)
    dw = None if route == 1 else \
        torch.empty((D, HD), device=dev, dtype=torch.float32)
    db = torch.empty((HD,), device=dev, dtype=torch.float32)
    n_split, warps, n_blocks, dw_part, db_part = _split_scratch(
        G, E, D, HD, dev, route, _sm_count(dev), cdt)
    err = _bwd_lib().gat_bwd_pass2(
        nq.data_ptr(), nk.data_ptr(), edge_emb.data_ptr(), w_ke.data_ptr(),
        None if w_t is None else w_t.data_ptr(), b_ke.data_ptr(),
        scores.data_ptr(), gmax.data_ptr(),
        dalpha.data_ptr(), scale.data_ptr(), d_denom.data_ptr(),
        src.data_ptr(), dst.data_ptr(), mask.data_ptr(), dekb.data_ptr(),
        None if demb is None else demb.data_ptr(), dnq.data_ptr(),
        dnk.data_ptr(), None if dw_part is None else dw_part.data_ptr(),
        db_part.data_ptr(), None if dw is None else dw.data_ptr(),
        db.data_ptr(), None if ws is None else ws.data_ptr(), G, N, E, D,
        HD, heads, n_split, width, _dtype_code(nq), route, warps, n_blocks,
        ld, _stream())
    _build.check(err, "gat_bwd_pass2")
    _build.count_launch("gat_bwd_pass2", route)
    if route == 1 and cot is None:
        dw = bwd_dw(edge_emb, dekb)
    return dekb if demb is None else demb, dnq, dnk, dw, db


class DembPlan(NamedTuple):
    """How `demb_tc_kernel` runs demb = cot W^T (+ add) at (D, HD): tiles of
    `bm` slots x `bn` of demb's columns, `n_tiles` of them over D (the last
    cut at D by the stores), the depth HD in `k_tiles` slices of `bk`
    through a ring of `stages` slots, `smem` bytes of shared memory. Its
    TMA boxes, (inner elements, rows, in the 128-byte swizzle): `operand_box`
    cot's (bm rows) and W's (bn rows) slices, `out_box` add's and demb's,
    a 64-row block of a consumer warpgroup's rows at a time."""
    bn: int
    n_tiles: int
    bm: int
    bk: int
    k_tiles: int
    stages: int
    smem: int
    operand_box: tuple
    out_box: tuple


def demb_smem_bytes(cdt, bn: int, stages: int) -> int:
    """csrc/gat_demb.cu `demb_smem_bytes`: the alignment slack, the ring
    (each slot a slice of cot's bm rows and of W's bn rows, hi and lo in
    f32), both consumers' staging of a 64-row block in cdt, the
    barriers."""
    bm, es = DEMB_ROWS[cdt], torch.finfo(cdt).bits // 8
    stage = (bm + DEMB_B_TILES[cdt] * bn) * DEMB_SLICE
    return DEMB_ALIGN + stages * stage + 2 * 64 * bn * es \
        + (2 * stages + 4) * 8


def demb_plan(D: int, HD: int, cdt, bn: int | None = None) -> DembPlan:
    """The tile plan of `bwd_demb`'s route 1 at (D, HD) in cdt: of the
    widths the kernel is built at (DEMB_WIDTHS), the one whose column tiles
    cover D at the least cost, the columns they compute (a ragged last tile
    computes columns it drops) weighed by their L2 traffic
    (DEMB_L2_WEIGHT), a larger width on a tie; then the most ring slots
    that fit beside the staging, at most DEMB_MAX_STAGES. bf16: 1040 -> 6
    tiles of 176, 512 -> 3 of 176, 200 -> 200, 104 -> 104; f32 at 1040
    10 of 104. `bn` names a width instead, to time it (the C entry refuses
    a width the kernel is not built at)."""
    if D <= 0 or D % 8 or HD <= 0 or HD % 8:
        raise ValueError(f"demb takes D and HD multiples of 8, got {D}, {HD}")
    bm, nb = DEMB_ROWS[cdt], DEMB_B_TILES[cdt]

    def cost(w):
        n = -(-D // w)
        return n * w * max(1.0, DEMB_L2_WEIGHT[cdt] * (bm + nb * w)
                            / (bm * w)), -w

    if bn is None:
        bn = min(DEMB_WIDTHS[cdt], key=cost)
    stages = max((s for s in range(2, DEMB_MAX_STAGES + 1)
                  if demb_smem_bytes(cdt, bn, s) <= TC_SMEM_LIMIT), default=2)
    bk = DEMB_SLICE // (torch.finfo(cdt).bits // 8)
    return DembPlan(bn, -(-D // bn), bm, bk, -(-HD // bk), stages,
                    demb_smem_bytes(cdt, bn, stages), (bk, bn, True),
                    (bn, 64, False))


def _tf32_split(w):
    """W's tf32 hi (x rounded to tf32 to nearest, ties away: bits + 0x1000,
    the low 13 cleared) and lo = W - hi, exact: csrc/mma_tile.cuh
    `split_tf32` bit for bit, once a call, what `demb_tc_kernel` reads as
    its two B operands in f32."""
    hi = ((w.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return hi, w - hi


def bwd_demb(cot, w, add, out=None, _route=None, _plan=None):
    """The demb product of a backward pass of more than one launch (rows 8
    and 9, C17): demb = cot W^T (+ add) over all HD columns, summed in f32
    and rounded to cot's dtype once, as `_bwd1_proj_kernel` and
    `_bwd2_proj_kernel` round demb once a pass. cot (G, E, HD): every
    launch's cotangent rows (`_cot_rows`; zeros at masked slots, so demb
    there is add, or 0); w (D, HD) f32, rounded to cot's dtype as the
    kernels round it; add (G, E, D) in cot's dtype or None: pass 1's carry
    or pass 2's demb. `out`: where the kernel writes demb (add itself for
    pass 2's in-place add; a new array if None). One launch: route 1,
    csrc/gat_demb.cu `gat_demb_tc` (`demb_tc_kernel`: wgmma from a TMA-fed
    ring, bf16 products in bf16, split-TF32 ones in f32, W split once a
    call by `_tf32_split`; its tiles `demb_plan`, or `_plan`), route 0 on
    CUDA cores, csrc/gat_bwd.cu `gat_bwd_demb` (`demb_kernel`), when named,
    as the passes' `_route`."""
    if not cot.is_cuda:
        return bwd_demb_plain(cot, w, add)
    G, E, HD = cot.shape
    D = w.shape[0]
    cdt = cot.dtype
    _require(cot, "cot", cdt, (G, E, HD))
    _require(w, "w", torch.float32, (D, HD))
    if add is not None:
        _require(add, "add", cdt, (G, E, D))
    if out is None:
        out = cot.new_empty((G, E, D))
    else:
        _require(out, "out", cdt, (G, E, D))
    route = _bwd_route(cdt, _route)
    add_ptr = None if add is None else add.data_ptr()
    if route == 1:
        plan = _plan or demb_plan(D, HD, cdt)
        if cdt == torch.float32:
            wb, w_lo = _tf32_split(w)
        else:
            wb, w_lo = w.to(torch.bfloat16), None
        err = _demb_lib().gat_demb_tc(
            cot.data_ptr(), wb.data_ptr(),
            None if w_lo is None else w_lo.data_ptr(), add_ptr,
            out.data_ptr(), G * E, D, HD, plan.bn, plan.stages,
            _sm_count(cot.device), _dtype_code(cot), _stream())
    else:
        width = d_slices(D)[1]
        w_t = _sliced_transpose(w, width)
        err = _bwd_lib().gat_bwd_demb(
            cot.data_ptr(), w_t.data_ptr(), add_ptr, out.data_ptr(), G, E,
            D, HD, width, _dtype_code(cot), _stream())
    _build.check(err, "gat_bwd_demb")
    _build.count_launch("gat_bwd_demb", route)
    return out


class DwPlan(NamedTuple):
    """How `dw_wgmma_kernel` runs dW = emb^T cot at (D, HD) over R slots:
    tiles of `bm` rows of dW x `bn` columns, `n_tiles` of them; the slots in
    `n_ranges` ranges of `chunk` (slices of `bk` slots), each range's f32
    partial, `partial_bytes` in all; a ring of `stages` slots in `smem` bytes of shared memory; `blocks`
    persistent blocks walking the n_tiles x n_ranges items. `box`: emb's
    and cot's TMA boxes (inner elements, slots, in the 128-byte swizzle),
    a column block of a slice."""
    bm: int
    bn: int
    n_tiles: int
    bk: int
    chunk: int
    n_ranges: int
    stages: int
    smem: int
    blocks: int
    partial_bytes: int
    box: tuple


def dw_smem_bytes(cdt, bm: int, bn: int, stages: int) -> int:
    """csrc/gat_dw.cu `dw_smem_bytes`: the alignment slack, the ring (each
    slot a slice of bk slots of emb's bm columns and of cot's bn, and in
    f32 cot's slice transposed as its tf32 hi and lo tiles, bn rows of
    128 bytes each), three barriers a slot."""
    es = torch.finfo(cdt).bits // 8
    stage = (bm + bn) * DW_SLICE[cdt] * es \
        + (2 * bn * DW_BLOCK if cdt == torch.float32 else 0)
    return DW_ALIGN + stages * stage + 3 * stages * 8


def dw_ranges(R: int, bk: int, n: int) -> tuple[int, int]:
    """(chunk, ranges): R slots in about n ranges of `chunk` slots, a
    multiple of bk, every range holding a slot (one range for R = 0)."""
    chunk = -(-max(1, -(-R // n)) // bk) * bk
    return chunk, max(1, -(-R // chunk))


@functools.lru_cache(maxsize=256)
def dw_plan(D: int, HD: int, R: int, cdt, n_sm: int, bm: int | None = None,
            bn: int | None = None, n_ranges: int | None = None) -> DwPlan:
    """The plan of `bwd_dw`'s route 1 at (D, HD) over R slots in cdt on
    n_sm SMs: of the tiles the kernel is built at (DW_TILES; `bm`, `bn`
    name one) and the slot ranges (`n_ranges` names a count; else up to
    as many as keep the partials within DW_PARTIAL_SHARE of the operands'
    bytes, and a slice a range), the one with the least modelled time: the
    waves of (tile, range) items over n_sm persistent blocks, an item's
    time its products at DW_PEAK (padded tiles included) plus, where they
    cost (DW_L2_COSTS), its operands' bytes (those inside D and HD) at
    DW_L2_BYTES_PER_S a card; plus the partials written and read back at
    DW_HBM_BYTES_PER_S;
    on a tie the fewer ranges, then the larger tile. The most ring slots
    that fit."""
    if D <= 0 or D % 8 or HD <= 0 or HD % 8 or R < 0 or n_sm < 1:
        raise ValueError(f"dW takes D and HD multiples of 8, R >= 0 slots "
                         f"and n_sm >= 1; got {D}, {HD}, {R}, {n_sm}")
    es, bk = torch.finfo(cdt).bits // 8, DW_SLICE[cdt]
    tiles = [(m, n) for m, n in DW_TILES[cdt]
             if bm in (None, m) and bn in (None, n)]
    if not tiles:
        raise ValueError(f"dW is built at no tile {bm} x {bn} in {cdt}")
    cap = max(1, int(DW_PARTIAL_SHARE * R * (D + HD) * es) // (4 * D * HD))
    most = max(1, -(-R // bk))
    counts = range(1, min(cap, most) + 1) if n_ranges is None \
        else (n_ranges,)
    best = None
    for tbm, tbn in tiles:
        rows, cols = -(-D // tbm), -(-HD // tbn)
        # operand elements a slot over all tiles, inside D and HD
        loaded = cols * D + rows * HD
        for r in counts:
            chunk, nr = dw_ranges(R, bk, r)
            items = rows * cols * nr
            t_ops = chunk * tbm * tbn * 2.0 * n_sm / DW_PEAK[cdt]
            t_l2 = chunk * loaded / (rows * cols) * es * n_sm \
                / DW_L2_BYTES_PER_S
            part = 4 * nr * D * HD
            t_item = t_ops + (t_l2 if DW_L2_COSTS[cdt] else 0.0)
            t = -(-items // n_sm) * t_item + 2 * part / DW_HBM_BYTES_PER_S
            key = (t, nr, -tbm * tbn)
            if best is None or key < best[0]:
                best = (key, tbm, tbn, rows * cols, chunk, nr, part)
    _, tbm, tbn, n_tiles, chunk, nr, part = best
    stages = max((s for s in range(2, DW_MAX_STAGES + 1)
                  if dw_smem_bytes(cdt, tbm, tbn, s) <= TC_SMEM_LIMIT),
                 default=2)
    return DwPlan(tbm, tbn, n_tiles, bk, chunk, nr, stages,
                  dw_smem_bytes(cdt, tbm, tbn, stages),
                  min(n_sm, n_tiles * nr), part,
                  (DW_BLOCK // es, bk, True))


def _dw_splits(G: int, E: int, n_sm: int) -> int:
    """The slot ranges of route 0 of `bwd_dw` (`dw_tc_kernel`): one an SM,
    at least 32 slots each, as the passes' own dW launch split them."""
    return max(1, min(n_sm, -(-G * E // 32)))


def bwd_dw(edge_emb, cot, _route=None, _plan=None):
    """Rows 8 and 9's weight gradient, one launch a backward pass: dW =
    emb^T cot over all G E slots, in f32, as `_bwd1_proj_kernel` and
    `_bwd2_proj_kernel` sum dwme / dwke over their grid. edge_emb (G, E, D)
    and cot (G, E, HD) in the pass's dtype: the pass's cotangent rows (its
    d_msg or dekb, or every launch's, `_cot_rows`; zeros at masked slots,
    which add nothing). Returns dW (D, HD) f32. One launch: route 1,
    csrc/gat_dw.cu `gat_dw_tc` (`dw_wgmma_kernel`: wgmma from a TMA-fed
    ring, bf16 products in bf16, split-TF32 ones in f32; its plan
    `dw_plan`, or `_plan`), then the sum of its ranges' partials; route 0,
    csrc/gat_bwd.cu `gat_bwd_dw` (`dw_tc_kernel`, the mma.sync kernel the
    passes launched before, over all HD columns), when named, to time route
    1 against."""
    if not cot.is_cuda:
        return bwd_dw_plain(edge_emb, cot)
    G, E, HD = cot.shape
    D = edge_emb.shape[-1]
    cdt = cot.dtype
    _require(edge_emb, "edge_emb", cdt, (G, E, D))
    _require(cot, "cot", cdt, (G, E, HD))
    if D % 8 or HD % 8:
        raise ValueError(f"dW takes D and HD multiples of 8, got {D}, {HD}")
    route = _bwd_route(cdt, _route)
    dev = cot.device
    dw = torch.empty((D, HD), device=dev, dtype=torch.float32)
    if route == 1:
        plan = _plan or dw_plan(D, HD, G * E, cdt, _sm_count(dev))
        part = torch.empty((plan.n_ranges, D, HD), device=dev,
                           dtype=torch.float32)
        err = _dw_lib().gat_dw_tc(
            edge_emb.data_ptr(), cot.data_ptr(), part.data_ptr(),
            dw.data_ptr(), G * E, D, HD, plan.bm, plan.bn, plan.chunk,
            plan.n_ranges, plan.stages, plan.blocks,
            _dtype_code(cot), _stream())
    else:
        n_split = _dw_splits(G, E, _sm_count(dev))
        part = torch.empty((n_split, D, HD), device=dev, dtype=torch.float32)
        err = _bwd_lib().gat_bwd_dw(
            edge_emb.data_ptr(), cot.data_ptr(), part.data_ptr(),
            dw.data_ptr(), G, E, D, HD, d_slices(D)[1], n_split,
            _dtype_code(cot), _stream())
    _build.check(err, "gat_bwd_dw")
    _build.count_launch("gat_bwd_dw", route)
    return dw


# --------------------------------------------------------------------------
# the op, differentiable
# --------------------------------------------------------------------------

def gat_projected_backward(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb,
                           smb, src, dst, mask, scores, gmax, denom_raw,
                           scale, e_self, g, carry, heads):
    """The ten gradients (dnq, dnk, dnm, d_edge_emb, dW_ke, db_ke, dW_me,
    db_me, dskb, dsmb) from the output cotangent g (G, N, HD) and the
    later layers' d_edge_emb `carry` (or None)."""
    HD = nq.shape[-1]
    g = g.float().contiguous()
    # self-loop cotangents; they seed pass 1's node accumulators
    d_msg_self = heads_to_hd(e_self * scale, HD) * g
    d_alpha_self = head_sum((nm + smb).float() * g, heads)
    demb, dalpha, dnm, dscale, dw_me, db_me = bwd_pass1(
        g.to(nq.dtype), nm, edge_emb, w_me, b_me, scores, gmax, scale, src,
        dst, mask,
        None if carry is None else carry.to(edge_emb.dtype).contiguous(),
        d_msg_self.clone(), d_alpha_self * e_self, heads)
    # close the softmax chain: d_denom and the self-loop score cotangents
    gate = (denom_raw > DENOM_EPS).float()
    d_denom = -(scale / torch.clamp_min(denom_raw, DENOM_EPS)) * dscale * gate
    ds_self = heads_to_hd((d_alpha_self * scale + d_denom) * e_self, HD)
    nqf = nq.float()
    dnq_self = ds_self * (nk.float() + skb.float())
    dnk_self = ds_self * nqf
    demb, dnq, dnk, dw_ke, db_ke = bwd_pass2(
        nq, nk, edge_emb, w_ke, b_ke, scores, gmax, dalpha, scale,
        d_denom.contiguous(), src, dst, mask, demb, dnq_self, dnk_self.clone(),
        heads)
    return (dnq.to(nq.dtype), dnk.to(nk.dtype), dnm.to(nm.dtype), demb,
            dw_ke.to(w_ke.dtype), db_ke.to(b_ke.dtype), dw_me.to(w_me.dtype),
            db_me.to(b_me.dtype), dnk_self.to(skb.dtype),
            d_msg_self.to(smb.dtype))


class _GatProjected(torch.autograd.Function):
    """(out, edge_emb passthrough); the passthrough's cotangent is the
    carry. With materialize_grads off a passthrough that nothing consumed
    arrives as None, not as a (G, E, D) array of zeros."""

    @staticmethod
    def forward(ctx, nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb, smb,
                src, dst, mask, heads):
        out, scores, gmax, denom_raw, scale, e_self = gat_projected_forward(
            nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb, smb, src, dst,
            mask, heads)
        ctx.save_for_backward(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me,
                              skb, smb, src, dst, mask, scores, gmax,
                              denom_raw, scale, e_self)
        ctx.heads = heads
        ctx.set_materialize_grads(False)
        return out, edge_emb

    @staticmethod
    def backward(ctx, g, carry):
        saved = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(saved[0], dtype=torch.float32)
        grads = gat_projected_backward(*saved, g, carry, ctx.heads)
        return grads + (None, None, None, None)


def _contiguous(*ts):
    return tuple(t.contiguous() for t in ts)


def kernel_d(D: int) -> int:
    """The edge embedding's width at the kernels, `kernel_widths`' D: D
    rounded up to a multiple of 8 (above 256, of 8 times the fewest slices
    of at most 256 rows, so that `d_slices` cuts it evenly into that
    many)."""
    unit = 8 * max(1, -(-D // MAX_COLS))
    return -(-D // unit) * unit


def kernel_widths(D: int, HD: int, heads: int) -> tuple[int, int]:
    """(D, HD) the op runs its kernels at: D rounded up to a multiple of 8
    (above 256, of 8 times the fewest slices of at most 256 rows, so that
    `d_slices` cuts it evenly into that many; `kernel_d`), each head's HD /
    heads features to at least 4 and so that the heads together make a
    multiple of 8; where that is more than 8 heads or 256
    columns, which run in head groups (`head_groups`), each head's features
    to a multiple of 8, so that any group of whole heads is, and a head of
    more than 256 features runs in column slices (`col_slices`)."""
    step = 8 // math.gcd(8, heads)
    dph = -(-max(HD // heads, 4) // step) * step
    if heads > MAX_HEADS or heads * dph > MAX_COLS:
        dph = -(-(HD // heads) // 8) * 8
    return kernel_d(D), heads * dph


def pad_heads(t: torch.Tensor, heads: int, HDk: int) -> torch.Tensor:
    """(..., HD) head-major -> (..., HDk): zero features at the end of each
    head's columns."""
    HD = t.shape[-1]
    if HDk == HD:
        return t
    t = t.reshape(*t.shape[:-1], heads, HD // heads)
    return F.pad(t, (0, (HDk - HD) // heads)).reshape(*t.shape[:-2], HDk)


def emb_width(edge_emb, w_ke) -> tuple[int, int]:
    """(D, Dk): the op's D, the weights' rows, and the width the kernels
    take (`kernel_d`). The edge embedding comes at either: at D it is
    padded, at Dk (the fused GNN's, `EdgeEncoder` emitting zeros past D)
    it is taken as it is."""
    D = w_ke.shape[0]
    Dk = kernel_d(D)
    if edge_emb.shape[-1] not in (D, Dk):
        raise ValueError(f"edge_emb has {edge_emb.shape[-1]} features; the "
                         f"weights take D={D} (or the kernels' {Dk})")
    return D, Dk


def pad_widths(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb, smb,
               heads):
    """The op's ten differentiable inputs with zero features appended up to
    `kernel_widths`: D at the end of the weights' rows and of edge_emb
    (unless it comes at that width, `emb_width`), each head's features at
    the end of that head's columns."""
    D, Dk = emb_width(edge_emb, w_ke)
    HDk = kernel_widths(D, nq.shape[-1], heads)[1]

    def cols(t):
        return pad_heads(t, heads, HDk)

    def rows(w):
        return w if Dk == D else F.pad(w, (0, 0, 0, Dk - D))

    emb = edge_emb if edge_emb.shape[-1] == Dk \
        else F.pad(edge_emb, (0, Dk - D))
    return (cols(nq), cols(nk), cols(nm), emb, cols(rows(w_ke)), cols(b_ke),
            cols(rows(w_me)), cols(b_me), cols(skb), cols(smb))


def cut_heads(out: torch.Tensor, HD: int, heads: int) -> torch.Tensor:
    """(..., HDk) padded per head -> (..., HD): `pad_widths` undone."""
    t = out.reshape(*out.shape[:-1], heads, out.shape[-1] // heads)
    return t[..., :HD // heads].reshape(*out.shape[:-1], HD)


def gat_projected_chained(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb,
                          smb, src, dst, mask, heads):
    """The op, differentiable in its first ten arguments (arguments as
    `gat_projected_forward`). Returns (out (G, N, HD) f32, edge_emb): hand
    the returned embedding to the next layer, so that the edge embedding's
    cotangent accumulates through the layers' backward kernels. Widths the
    kernels do not take are padded (`pad_widths`) and the results cut back.
    An embedding that comes at the kernels' width (`emb_width`) is taken
    and returned as it is, so k layers chain it with no copy; one at D is
    padded, and the returned embedding is then a slice of the padded one."""
    args = (nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb, smb)
    D, Dk = emb_width(edge_emb, w_ke)
    HD = nq.shape[-1]
    if kernel_widths(D, HD, heads) == (D, HD):
        return _GatProjected.apply(*_contiguous(*args), src, dst, mask,
                                   heads)
    out, emb = _GatProjected.apply(
        *_contiguous(*pad_widths(*args, heads)), src, dst, mask, heads)
    return cut_heads(out, HD, heads), \
        emb if edge_emb.shape[-1] == Dk else emb[..., :D]


def gat_projected(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb, smb,
                  src, dst, mask, heads):
    """The op without the passthrough: (G, N, HD) f32."""
    return gat_projected_chained(nq, nk, nm, edge_emb, w_ke, b_ke, w_me,
                                 b_me, skb, smb, src, dst, mask, heads)[0]
