"""The unprojected relational GAT op on hand-written CUDA kernels.

Counterpart of `pallas_relational_gat` (qagnn_tpu/ops/pallas_gat.py
:1301-1335; forward `_fwd_impl` :394-474, backward `_bwd_impl` :546-632): the
op that takes node projections and PRECOMPUTED per-edge key and message
biases ekb, emb (G, E, HD), where `gat_kernels` projects the edge embedding
inside its kernels. Five kernels (csrc/gat_unproj.cu), none with a matrix
product. The forward runs

  * `edge_scores` (`gat_unproj_scores`): s = <nq[src], nk[dst] + ekb> per
    head, (G, H, E) f32, 0 at masked slots, and the max over masked edges
    per (graph, head), folded into the kernel by an atomic max (-1e30 for
    a graph with no masked edge). Two routes (`_scores_route`): route 1,
    where heads have at least 8 features, runs a block per range of a
    graph's slots that lists the live ones and loads their rows into
    registers ahead of their use; route 0 a block per 32 slots and a warp
    per edge;
  * torch glue: self-loop scores, gmax over masked edges AND all N self
    scores, e_self;
  * `edge_denoms` (`gat_unproj_denoms`): e_edge = exp(min(s - gmax, 0))
    over masked edges, 0 elsewhere, written (G, H, E); per-source sums of
    it and out-degrees. Two routes (`_denoms_route`): route 1, where a
    graph's exponentials fit a block's shared memory, runs a block per
    graph that sorts them by source there, sums each source's run in
    registers and writes the sums and degrees whole; route 0 a thread per
    slot with global atomics into zero-filled arrays;
  * torch glue: scale = (deg + 1) / max(denom_edges + e_self, 1e-16) and the
    self-loop term (nm + smb) * e_self * scale that seeds the output;
  * `aggregate` (`gat_unproj_aggr`): out[dst] += round(e_edge * scale[src]
    * (nm[src] + emb)) over masked edges, rounded to the compute dtype
    before the f32 sum. Two routes (`_aggr_route`): route 1, where heads
    have at least 8 features and the graph's slot tables fit a block,
    runs blocks over each graph's live slots sorted by destination, a warp
    a run of whole nodes, each node's sum in registers added once onto its
    seeded row; route 0 a warp per edge with global atomics.

The backward keeps e_edge as a residual (the projected op recomputes it from
its scores) and runs

  * torch glue: the self-loop cotangents d_msg_self, d_alpha_self;
  * `bwd1` (`gat_unproj_bwd1`): d_msg = alpha * g[dst] -> demb (every slot,
    zeros where masked), dnm[src] += round(d_msg), d_alpha per head,
    dscale[src] += d_alpha * e_edge; one launch, no scratch. Two routes
    (`_bwd1_route`: the rule of `_aggr_route`, for bfloat16 only): route 1
    sorts each graph's live slots by source and sums dnm and dscale per
    node as aggregate's route 1 sums out, writing demb and d_alpha a whole
    row or a head's value at a time; route 0 a warp per edge with global
    atomics;
  * torch glue: d_denom from dscale under the denom_raw > 1e-16 gate, the
    self-loop score cotangents;
  * `bwd2` (`gat_unproj_bwd2`): d_s = (d_alpha * scale[src] + d_denom[src])
    * e_edge -> dekb = d_s * nq[src] (every slot), dnq[src] += round(d_s *
    key), dnk[dst] += round(dekb); one launch. Two routes (`_bwd2_route`):
    route 1, where heads have at least 8 features and the block fits, runs
    a block per (graph, column slice) that sorts the graph's live slots by
    source and by destination in shared memory, sums each node's terms in
    registers before adding them onto its seeded row, and writes dekb in
    slot order, with no atomics on floats; route 0 a warp per edge with
    global atomics.

No gradient flows through gmax. Every kernel has a plain torch version here
with the same arithmetic and the same rounding points. A wrapper takes the
plain version for CPU tensors only; for CUDA tensors it launches its kernel
or raises. Any E works (the TPU op's edge padding is a tile matter of that
machine). A launch takes HD a multiple of 8 up to 256 and at most 8 heads
dividing HD; the wrappers take any width the JAX op takes, on every device:
each head's features are padded with zeros as the projected op pads them
(`gat_kernels.kernel_widths`; a zero feature adds nothing to a score, a
message or a gradient) and the results cut back, and more than 8 heads or
256 columns run as groups of whole heads (`gat_kernels.head_groups`), one
launch a group, every quantity being per head. A single head of more than
256 features runs as column slices (`gat_kernels.launches`), one launch a
slice: `aggregate` and `bwd2` work per column, and `edge_scores` and
`bwd1`, which sum over the head's columns, add each slice's f32 sums to the
slices' before it, the last alone taking the max or adding d_alpha * e into
dscale (`gat_kernels.partial`). The C entry points of these four take a row
stride for each (G, E, .) and (G, N, .) array, so the launches of a head
group or a split head read and write column views of the call's (padded)
arrays in place (`gat_kernels.col_view`, `_build.require_rows`): nothing
is copied or concatenated between them.
"""

from __future__ import annotations

import torch

from qagnn_tpu_torch.ops import _build
from qagnn_tpu_torch.ops.gat_kernels import (
    _I,
    _P,
    DENOM_EPS,
    NEG,
    _check_widths,
    _contiguous,
    _dtype_code,
    _gather_nodes,
    _part,
    _require,
    _scatter_nodes,
    _scores_out,
    _stream,
    by_head_groups,
    col_view,
    cut_heads,
    group_cols,
    head_groups,
    head_sum,
    heads_of,
    heads_to_hd,
    kernel_widths,
    launches,
    pad_heads,
    partial,
    scores_and_max,
    split_dalpha,
    split_scores,
)

_SIGNATURES = {
    "gat_unproj_scores": [_P] * 8 + [_I] * 11 + [_P],
    "gat_unproj_denoms": [_P] * 7 + [_I] * 5 + [_P],
    "gat_unproj_aggr": [_P] * 8 + [_I] * 10 + [_P],
    "gat_unproj_bwd1": [_P] * 12 + [_I] * 13 + [_P],
    "gat_unproj_bwd2": [_P] * 13 + [_I] * 14 + [_P],
}
# route 1 of bwd2 (csrc/gat_unproj.cu, bwd2_graph_kernel): the shared memory
# a block may have so that two fit on an SM, and the most it may opt into
# (at least 8 bytes a slot and 32 a node, so E and N stay below the limit of
# its uint16 indices)
BWD2_PAIR_SMEM, BWD2_MAX_SMEM = 113 * 1024, 227 * 1024
# route 1 of aggregate and bwd1 (aggr_graph_kernel, bwd1_graph_kernel): the
# most shared memory a block may opt into, and the most nodes and slots its
# uint16 indices hold; its warps, and the rows a slot stages in a warp's ring
SORTED_MAX_SMEM, SORTED_MAX_INDEX = 227 * 1024, 65536
SORTED_WARPS, AGGR_ROWS, BWD1_ROWS = 8, 2, 3


def _lib():
    return _build.load("gat_unproj", _SIGNATURES)


_rows = _build.require_rows


def _require_graph(src, dst, mask, G, E) -> None:
    _require(src, "src", torch.int32, (G, E))
    _require(dst, "dst", torch.int32, (G, E))
    _require(mask, "mask", torch.bool, (G, E))


def _padded(HD: int, heads: int) -> int:
    """The columns the launches take for HD: each head padded as the
    projected op pads it."""
    return kernel_widths(HD, HD, heads)[1]


def _cut_into(acc, padded, heads):
    """`acc` (G, N, HD), added to in place as `padded` (G, N, HDk): the
    padded accumulator's columns cut back into it (nothing where the two
    are one tensor)."""
    if padded is not acc:
        acc.copy_(cut_heads(padded, acc.shape[-1], heads))
    return acc


def _pick_route(kernel, fits, route, prefer=True, **shapes):
    """1 where route 1 takes the shapes (`fits`) and is the one to prefer,
    else 0; or `route`, where the caller names one that takes them."""
    if route is None:
        return 1 if fits and prefer else 0
    if route not in (0, 1) or (route == 1 and not fits):
        said = ", ".join(f"{k}={v}" for k, v in shapes.items())
        raise ValueError(f"no route {route} of {kernel} for {said}")
    return route


def _sorted_smem(N, E, HD, elem, rows):
    """Dynamic shared memory of a route-1 block of aggregate (rows = 2) or
    bwd1 (rows = 3) (`sorted_smem` in csrc/gat_unproj.cu) for N nodes, E
    slots and HD columns of elem bytes: each warp's ring of slots in flight
    (8 in bf16, 4 in f32), a stage holding `rows` rows and two floats for
    each of up to 8 heads; each slot's packed (src, dst) (uint32); the node
    offsets and cursors (int32); the permutation (uint16)."""
    depth = 8 if elem == 2 else 4
    ring = SORTED_WARPS * depth * (rows * HD * elem + 2 * 8 * 4)
    return ring + 4 * E + 4 * (2 * N + 1) + 2 * E


def _sorted_fits(dtype, N, E, HD, heads, rows):
    """Whether route 1 of aggregate (rows = 2) or bwd1 (rows = 3) takes
    these shapes: float32 or bfloat16, heads of at least 8 features, N and
    E within its uint16 indices and its block within a block's shared
    memory."""
    return dtype in (torch.float32, torch.bfloat16) and HD % 8 == 0 \
        and HD // heads >= 8 and 0 < N <= SORTED_MAX_INDEX \
        and E <= SORTED_MAX_INDEX \
        and _sorted_smem(N, E, HD, dtype.itemsize, rows) <= SORTED_MAX_SMEM


def _aggr_route(dtype, N, E, HD, heads, route=None):
    """Route of `aggregate`: 1 (blocks over each graph's slots sorted by
    destination, a warp a run of whole nodes) where `_sorted_fits`; else
    0, the warp-per-edge kernel. `route` names one, 0 to time the
    warp-per-edge kernel beside route 1."""
    fits = _sorted_fits(dtype, N, E, HD, heads, AGGR_ROWS)
    return _pick_route("gat_unproj_aggr", fits, route, dtype=dtype, N=N, E=E,
                       HD=HD, heads=heads)


def _bwd1_route(dtype, N, E, HD, heads, route=None):
    """Route of `bwd1`: 1 (blocks over each graph's slots sorted by source,
    a warp a run of whole nodes) for bfloat16 where `_sorted_fits`; else 0,
    the warp-per-edge kernel. Route 1 takes float32 as well, but is slower
    than route 0 there (its f32 demb rows, stored in source order, cost
    more than route 0's atomics; PERF.md), so float32 goes to route 0
    unless `route` names 1. `route` names one, as for `_aggr_route`."""
    fits = _sorted_fits(dtype, N, E, HD, heads, BWD1_ROWS)
    return _pick_route("gat_unproj_bwd1", fits, route,
                       prefer=dtype == torch.bfloat16, dtype=dtype, N=N, E=E,
                       HD=HD, heads=heads)


# --------------------------------------------------------------------------
# scores
# --------------------------------------------------------------------------

def _scores_route(dtype, N, E, HD, heads, route=None):
    """Route of `edge_scores`: 1 (a block per range of 512 slots of a
    graph, its live slots listed and their rows loaded into registers ahead
    of their use; 21 KB of shared memory at most) for float32 and bfloat16
    with heads of at least 8 features; else 0, a block per 32 slots and a
    warp per edge. `route` names one, 0 to time route 0 beside route 1."""
    fits = dtype in (torch.float32, torch.bfloat16) and HD % 8 == 0 \
        and HD <= 256 and 0 < heads <= 8 and HD % heads == 0 \
        and HD // heads >= 8
    return _pick_route("gat_unproj_scores", fits, route, dtype=dtype, N=N,
                       E=E, HD=HD, heads=heads)


def edge_scores_plain(nq, nk, ekb, src, dst, mask, heads, acc=None,
                      last=True):
    eq = _gather_nodes(nq, src).float()
    ek = _gather_nodes(nk, dst).float() + ekb.float()
    return scores_and_max(head_sum(eq * ek, heads).transpose(1, 2), mask,
                          acc, last)


def edge_scores(nq, nk, ekb, src, dst, mask, heads, _route=None):
    """Scores (G, H, E) f32, 0 at masked slots, and the max over masked
    edges (G, H) f32 (NEG for a graph with no masked edge); a launch a head
    group or a column slice of a head wider than 256 features, each head
    padded to `_padded`. `_route` names a route (`_scores_route`), to time
    it beside the other."""
    HDk = _padded(nq.shape[-1], heads)

    def launch(h0, h1, t, **part):
        return _edge_scores(*t, src, dst, mask, h1 - h0, _route, **part)
    return split_scores(launch, HDk, heads,
                        [pad_heads(t, heads, HDk) for t in (nq, nk, ekb)],
                        col_view)


def _edge_scores(nq, nk, ekb, src, dst, mask, heads, _route, acc=None,
                 last=True):
    if not nq.is_cuda:
        return edge_scores_plain(nq, nk, ekb, src, dst, mask, heads, acc,
                                 last)
    G, N, HD = nq.shape
    E = ekb.shape[1]
    cdt = nq.dtype
    _check_widths(HD, HD, heads)
    lds = (_rows(nq, "nq", cdt, (G, N, HD)), _rows(nk, "nk", cdt, (G, N, HD)),
           _rows(ekb, "ekb", cdt, (G, E, HD)))
    _require_graph(src, dst, mask, G, E)
    route = _scores_route(cdt, N, E, HD, heads, _route)
    out = _scores_out(acc, G, heads, E, nq.device)
    m_edge = torch.full((G, heads), NEG, device=nq.device,
                        dtype=torch.float32)
    err = _lib().gat_unproj_scores(
        nq.data_ptr(), nk.data_ptr(), ekb.data_ptr(), src.data_ptr(),
        dst.data_ptr(), mask.data_ptr(), out.data_ptr(), m_edge.data_ptr(),
        G, N, E, HD, heads, *lds, _dtype_code(nq), route, _part(acc, last),
        _stream())
    _build.check(err, "gat_unproj_scores")
    _build.count_launch("gat_unproj_scores", route)
    return out, m_edge


# --------------------------------------------------------------------------
# exponentials, denominators and degrees
# --------------------------------------------------------------------------

def _denoms_smem(N, E, heads):
    """Dynamic shared memory of a route-1 denoms block (`denoms_smem` in
    csrc/gat_unproj.cu): the graph's exponentials grouped by source (f32,
    heads x E); the offsets (N + 1) and the counts, later the next places
    (N), int32."""
    return 4 * heads * E + 4 * (2 * N + 1)


def _denoms_route(N, E, heads, route=None):
    """Route of `edge_denoms`: 1 (a block per graph that sorts its slots by
    source in shared memory, sums each source's run and writes the sums and
    degrees whole) where that fits a block's shared memory
    (`_denoms_smem`); else 0, a thread per slot with global atomics into
    zero-filled arrays. The scores are f32 whatever the op's dtype, so no
    dtype enters. `route` names one, 0 to time route 0 beside route 1."""
    fits = 0 < heads <= 8 and _denoms_smem(N, E, heads) <= SORTED_MAX_SMEM
    return _pick_route("gat_unproj_denoms", fits, route, N=N, E=E,
                       heads=heads)


def edge_denoms_plain(scores, gmax, src, mask, n_nodes):
    G, H, E = scores.shape
    e = torch.exp(torch.clamp_max(scores - gmax[:, :, None], 0.0))
    e = torch.where(mask[:, None, :], e, 0.0)
    denom = _scatter_nodes(scores.new_zeros((G, n_nodes, H)), src,
                           e.transpose(1, 2))
    deg = scores.new_zeros((G, n_nodes)).scatter_add_(1, src.long(),
                                                      mask.float())
    return e, denom, deg


def edge_denoms(scores, gmax, src, mask, n_nodes, _route=None):
    """e_edge = exp(min(s - gmax, 0)) over masked edges and 0 elsewhere
    (G, H, E), its per-source sums (G, N, H) and the out-degree (G, N), all
    f32; a launch a group of at most 8 heads (the degree is the same in
    every group). `_route` names a route (`_denoms_route`), to time it
    beside the other."""
    H = scores.shape[1]

    def run(h0, h1):
        return _edge_denoms(scores[:, h0:h1].contiguous(),
                            gmax[:, h0:h1].contiguous(), src, mask, n_nodes,
                            _route)
    # one column a head: groups of at most 8 heads
    return by_head_groups(H, H, run, (1, 2, None))


def _edge_denoms(scores, gmax, src, mask, n_nodes, _route):
    if not scores.is_cuda:
        return edge_denoms_plain(scores, gmax, src, mask, n_nodes)
    G, H, E = scores.shape
    _require(scores, "scores", torch.float32, (G, H, E))
    _require(gmax, "gmax", torch.float32, (G, H))
    _require(src, "src", torch.int32, (G, E))
    _require(mask, "mask", torch.bool, (G, E))
    route = _denoms_route(n_nodes, E, H, _route)
    # route 1 writes denom and deg whole; route 0 adds into them
    new = torch.empty if route == 1 else torch.zeros
    e_edge = torch.empty_like(scores)
    denom = new((G, n_nodes, H), device=scores.device, dtype=torch.float32)
    deg = new((G, n_nodes), device=scores.device, dtype=torch.float32)
    err = _lib().gat_unproj_denoms(
        scores.data_ptr(), gmax.data_ptr(), src.data_ptr(), mask.data_ptr(),
        e_edge.data_ptr(), denom.data_ptr(), deg.data_ptr(), G, n_nodes, E,
        H, route, _stream())
    _build.check(err, "gat_unproj_denoms")
    _build.count_launch("gat_unproj_denoms", route)
    return e_edge, denom, deg


# --------------------------------------------------------------------------
# aggregation
# --------------------------------------------------------------------------

def aggregate_plain(nm, emb, e_edge, scale, src, dst, mask, out, heads):
    HD = nm.shape[-1]
    msg = _gather_nodes(nm, src).float() + emb.float()
    alpha = e_edge.transpose(1, 2) * _gather_nodes(scale, src)      # (G,E,H)
    w = (msg * heads_to_hd(alpha, HD)).to(nm.dtype).float()
    return _scatter_nodes(out, dst, torch.where(mask[..., None], w, 0.0))


def aggregate(nm, emb, e_edge, scale, src, dst, mask, out, heads,
              _route=None):
    """Adds alpha * msg of every masked edge, rounded to the compute dtype,
    at its dst into `out` (G, N, HD) f32, IN PLACE (the caller seeds it with
    the self-loop term), and returns it; a launch a head group or a column
    slice of a head wider than 256 features, each head padded to `_padded`.
    `_route` names a route (`_aggr_route`), to time it beside the other."""
    HD = nm.shape[-1]
    HDk = _padded(HD, heads)
    plan = launches(HDk, heads)
    if HDk == HD and len(plan) == 1:
        return _aggregate(nm, emb, e_edge, scale, src, dst, mask, out, heads,
                          _route)
    nm, emb, acc = (pad_heads(t, heads, HDk) for t in (nm, emb, out))
    for h0, h1 in head_groups(HDk, heads):
        node = (e_edge[:, h0:h1].contiguous(), heads_of(scale, h0, h1), src,
                dst, mask)
        for c0, c1 in group_cols(HDk, heads, h0, h1):
            _aggregate(col_view(nm, c0, c1), col_view(emb, c0, c1), *node,
                       col_view(acc, c0, c1), h1 - h0, _route)
    return _cut_into(out, acc, heads)


def _aggregate(nm, emb, e_edge, scale, src, dst, mask, out, heads, _route):
    if not nm.is_cuda:
        return aggregate_plain(nm, emb, e_edge, scale, src, dst, mask, out,
                               heads)
    G, N, HD = nm.shape
    E = emb.shape[1]
    cdt = nm.dtype
    _check_widths(HD, HD, heads)
    lds = (_rows(nm, "nm", cdt, (G, N, HD)),
           _rows(emb, "emb", cdt, (G, E, HD)),
           _rows(out, "out", torch.float32, (G, N, HD)))
    _require(e_edge, "e_edge", torch.float32, (G, heads, E))
    _require(scale, "scale", torch.float32, (G, N, heads))
    _require_graph(src, dst, mask, G, E)
    route = _aggr_route(cdt, N, E, HD, heads, _route)
    err = _lib().gat_unproj_aggr(
        nm.data_ptr(), emb.data_ptr(), e_edge.data_ptr(), scale.data_ptr(),
        src.data_ptr(), dst.data_ptr(), mask.data_ptr(), out.data_ptr(), G,
        N, E, HD, heads, *lds, _dtype_code(nm), route, _stream())
    _build.check(err, "gat_unproj_aggr")
    _build.count_launch("gat_unproj_aggr", route)
    return out


# --------------------------------------------------------------------------
# the op, forward
# --------------------------------------------------------------------------

def gat_unprojected_forward(nq, nk, nm, ekb, emb, skb, smb, src, dst, mask,
                            heads):
    """Fused sparse attention core over precomputed edge biases.

    nq/nk/nm: (G, N, HD) node projections in the compute dtype (query
    pre-scaled by 1/sqrt(dph)); ekb/emb: (G, E, HD) edge key and message
    biases; skb/smb: (G, N, HD) self-loop biases; src/dst: (G, E) int32
    local indices; mask: (G, E) bool.

    Returns (out (G, N, HD) f32, e_edge (G, H, E) f32, denom_raw (G, N, H)
    f32, scale (G, N, H) f32, e_self (G, N, H) f32): the output and what the
    backward keeps.
    """
    G, N, HD = nq.shape
    s, m_edge = edge_scores(nq, nk, ekb, src, dst, mask, heads)
    self_scores = head_sum(nq.float() * (nk + skb).float(), heads)  # (G,N,H)
    gmax = torch.maximum(m_edge, self_scores.amax(1))                 # (G,H)
    e_self = torch.exp(self_scores - gmax[:, None, :])
    e_edge, denom_edges, deg = edge_denoms(s, gmax, src, mask, N)
    denom_raw = denom_edges + e_self
    scale = (deg[..., None] + 1.0) / torch.clamp_min(denom_raw, DENOM_EPS)
    out = (nm + smb).float() * heads_to_hd(e_self * scale, HD)
    out = aggregate(nm, emb, e_edge, scale, src, dst, mask, out, heads)
    return out, e_edge, denom_raw, scale, e_self


# --------------------------------------------------------------------------
# backward pass 1 (message side)
# --------------------------------------------------------------------------

def bwd1_plain(gout, nm, emb, e_edge, scale, src, dst, mask, dnm, dscale,
               heads, acc=None, last=True, demb=None):
    cdt, HD = nm.dtype, nm.shape[-1]
    live = mask[..., None]
    msg = _gather_nodes(nm, src).float() + emb.float()
    g_dst = _gather_nodes(gout, dst).float()
    e = torch.where(live, e_edge.transpose(1, 2), 0.0)              # (G,E,H)
    alpha = e * _gather_nodes(scale, src)
    d_msg = torch.where(live, heads_to_hd(alpha, HD) * g_dst, 0.0).to(cdt)
    dalpha = split_dalpha(head_sum(msg * g_dst, heads), mask, acc)
    _scatter_nodes(dnm, src, d_msg.float())
    if last:
        _scatter_nodes(dscale, src, dalpha.transpose(1, 2) * e)
    return _written(demb, d_msg.to(emb.dtype)), dalpha, dnm, dscale


def _written(out, value):
    """`value`, or written into `out` (a column view of the call's output,
    `demb=` / `dekb=` of a launch) where one is given."""
    return value if out is None else out.copy_(value)


def bwd1(gout, nm, emb, e_edge, scale, src, dst, mask, dnm, dscale, heads,
         _route=None):
    """Backward pass 1. gout: (G, N, HD) output cotangent in the compute
    dtype; dnm (G, N, HD) and dscale (G, N, H) f32 arrive seeded with the
    self-loop cotangents and are added to IN PLACE.

    Returns (demb (G, E, HD) in emb's dtype, zeros at masked slots, d_alpha
    (G, H, E) f32, 0 at masked slots, dnm, dscale); a launch a head group or
    a column slice of a head wider than 256 features, each head padded to
    `_padded`, each launch reading its columns of the (padded) inputs and
    writing its columns of one demb in place (`col_view`); a split head's
    slices sum its d_alpha in order, the last adding d_alpha * e into
    dscale. `_route` names a route (`_bwd1_route`), to time it beside the
    other."""
    HD = nm.shape[-1]
    HDk = _padded(HD, heads)
    if HDk == HD and len(launches(HDk, heads)) == 1:
        return _bwd1(gout, nm, emb, e_edge, scale, src, dst, mask, dnm,
                     dscale, heads, _route)
    gout, nm, emb, acc = (pad_heads(t, heads, HDk)
                          for t in (gout, nm, emb, dnm))
    demb = torch.empty_like(emb)
    dalphas = []
    for h0, h1 in head_groups(HDk, heads):
        spans, dalpha = group_cols(HDk, heads, h0, h1), None
        node = (e_edge[:, h0:h1].contiguous(), heads_of(scale, h0, h1), src,
                dst, mask)
        ds = heads_of(dscale, h0, h1)
        for i, (c0, c1) in enumerate(spans):
            _, dalpha, _, ds = _bwd1(
                *(col_view(t, c0, c1) for t in (gout, nm, emb)), *node,
                col_view(acc, c0, c1), ds, h1 - h0, _route,
                **partial(dalpha, i, len(spans)),
                demb=col_view(demb, c0, c1))
        dscale[..., h0:h1] = ds
        dalphas.append(dalpha)
    if HDk != HD:
        demb = cut_heads(demb, HD, heads).contiguous()
    return (demb, torch.cat(dalphas, 1), _cut_into(dnm, acc, heads),
            dscale)


def _bwd1(gout, nm, emb, e_edge, scale, src, dst, mask, dnm, dscale, heads,
          _route, acc=None, last=True, demb=None):
    """One launch; `demb` (G, E, HD), where given, the view of the call's
    output that it writes, else a new array."""
    if not nm.is_cuda:
        return bwd1_plain(gout, nm, emb, e_edge, scale, src, dst, mask, dnm,
                          dscale, heads, acc, last, demb)
    G, N, HD = nm.shape
    E = emb.shape[1]
    cdt = nm.dtype
    _check_widths(HD, HD, heads)
    if demb is None:
        demb = torch.empty((G, E, HD), device=nm.device, dtype=cdt)
    lds = (_rows(gout, "gout", cdt, (G, N, HD)),
           _rows(nm, "nm", cdt, (G, N, HD)),
           _rows(emb, "emb", cdt, (G, E, HD)),
           _rows(demb, "demb", cdt, (G, E, HD)),
           _rows(dnm, "dnm", torch.float32, (G, N, HD)))
    _require(e_edge, "e_edge", torch.float32, (G, heads, E))
    _require(scale, "scale", torch.float32, (G, N, heads))
    _require_graph(src, dst, mask, G, E)
    _require(dscale, "dscale", torch.float32, (G, N, heads))
    route = _bwd1_route(cdt, N, E, HD, heads, _route)
    dalpha = _scores_out(acc, G, heads, E, nm.device)
    err = _lib().gat_unproj_bwd1(
        gout.data_ptr(), nm.data_ptr(), emb.data_ptr(), e_edge.data_ptr(),
        scale.data_ptr(), src.data_ptr(), dst.data_ptr(), mask.data_ptr(),
        demb.data_ptr(), dalpha.data_ptr(), dscale.data_ptr(),
        dnm.data_ptr(), G, N, E, HD, heads, *lds, _dtype_code(nm), route,
        _part(acc, last), _stream())
    _build.check(err, "gat_unproj_bwd1")
    _build.count_launch("gat_unproj_bwd1", route)
    return demb, dalpha, dnm, dscale


# --------------------------------------------------------------------------
# backward pass 2 (score side)
# --------------------------------------------------------------------------

def bwd2_plain(nq, nk, ekb, e_edge, dalpha, scale, d_denom, src, dst, mask,
               dnq, dnk, heads, dekb=None):
    cdt, HD = nq.dtype, nq.shape[-1]
    live = mask[..., None]
    q_src = _gather_nodes(nq, src).float()
    key = _gather_nodes(nk, dst).float() + ekb.float()
    d_s = (dalpha.transpose(1, 2) * _gather_nodes(scale, src)
           + _gather_nodes(d_denom, src)) * e_edge.transpose(1, 2)
    ds_hd = heads_to_hd(torch.where(live, d_s, 0.0), HD)
    d_key = (ds_hd * q_src).to(cdt)
    _scatter_nodes(dnq, src, (ds_hd * key).to(cdt).float())
    _scatter_nodes(dnk, dst, d_key.float())
    return _written(dekb, d_key.to(ekb.dtype)), dnq, dnk


def _bwd2_smem(N, E, HD, heads, cw, elem):
    """Dynamic shared memory of a route-1 block (`bwd2_smem` in
    csrc/gat_unproj.cu) for N nodes, E slots and cw columns: the nq and nk
    slices (elem bytes a value); room for (scale, d_denom) per node, which
    the sorts' two uint16 permutations take over later; d_s per slot for
    the most heads a slice touches; each slot's packed (src, dst); the
    sorts' offsets and cursors (int32)."""
    dph = HD // heads
    hs = max((c0 + min(cw, HD - c0) - 1) // dph - c0 // dph + 1
             for c0 in range(0, HD, cw))
    room = -(-max(8 * N * hs, 4 * E) // 16) * 16
    return 2 * N * cw * elem + room + 4 * E * hs + 4 * E + 4 * (4 * N + 2)


def _bwd2_width(dtype, N, E, HD, heads):
    """Columns of a route-1 slice: the widest (the fewest slices, each a
    multiple of 8 columns) whose block leaves room for two an SM; else the
    widest that fits at all; None where 8 columns do not fit."""
    elem = 2 if dtype == torch.bfloat16 else 4
    n8 = HD // 8
    widths = sorted({8 * -(-n8 // n) for n in range(1, n8 + 1)},
                    reverse=True)
    for limit in (BWD2_PAIR_SMEM, BWD2_MAX_SMEM):
        for cw in widths:
            if _bwd2_smem(N, E, HD, heads, cw, elem) <= limit:
                return cw
    return None


def _bwd2_route(dtype, N, E, HD, heads, route=None):
    """Route of `bwd2`: 1 (a block per graph and column slice over the
    graph's slots sorted by node) for float32 and bfloat16 with heads of at
    least 8 features and a slice's block that fits (`_bwd2_width`); else
    0, the warp-per-edge kernel. `route` names one, 0 to time the
    warp-per-edge kernel beside route 1."""
    fits = dtype in (torch.float32, torch.bfloat16) and HD % 8 == 0 \
        and HD // heads >= 8 \
        and _bwd2_width(dtype, N, E, HD, heads) is not None
    return _pick_route("gat_unproj_bwd2", fits, route, dtype=dtype, N=N, E=E,
                       HD=HD, heads=heads)


def bwd2(nq, nk, ekb, e_edge, dalpha, scale, d_denom, src, dst, mask, dnq,
         dnk, heads, _route=None):
    """Backward pass 2. dnq and dnk (G, N, HD) f32 arrive seeded with the
    self-loop cotangents and are added to IN PLACE.

    Returns (dekb (G, E, HD) in ekb's dtype, zeros at masked slots, dnq,
    dnk); a launch a head group or a column slice of a head wider than 256
    features, each head padded to `_padded`, each launch reading and
    writing its columns in place as `bwd1`'s do. `_route` names a route
    (`_bwd2_route`), to time it beside the other."""
    HD = nq.shape[-1]
    HDk = _padded(HD, heads)
    if HDk == HD and len(launches(HDk, heads)) == 1:
        return _bwd2(nq, nk, ekb, e_edge, dalpha, scale, d_denom, src, dst,
                     mask, dnq, dnk, heads, _route)
    nq, nk, ekb, acc_q, acc_k = (pad_heads(t, heads, HDk)
                                 for t in (nq, nk, ekb, dnq, dnk))
    dekb = torch.empty_like(ekb)
    for h0, h1 in head_groups(HDk, heads):
        node = (e_edge[:, h0:h1].contiguous(), dalpha[:, h0:h1].contiguous(),
                heads_of(scale, h0, h1), heads_of(d_denom, h0, h1), src, dst,
                mask)
        for c0, c1 in group_cols(HDk, heads, h0, h1):
            _bwd2(*(col_view(t, c0, c1) for t in (nq, nk, ekb)), *node,
                  col_view(acc_q, c0, c1), col_view(acc_k, c0, c1), h1 - h0,
                  _route, dekb=col_view(dekb, c0, c1))
    if HDk != HD:
        dekb = cut_heads(dekb, HD, heads).contiguous()
    return (dekb, _cut_into(dnq, acc_q, heads),
            _cut_into(dnk, acc_k, heads))


def _bwd2(nq, nk, ekb, e_edge, dalpha, scale, d_denom, src, dst, mask, dnq,
          dnk, heads, _route, dekb=None):
    """One launch; `dekb` (G, E, HD), where given, the view of the call's
    output that it writes, else a new array."""
    if not nq.is_cuda:
        return bwd2_plain(nq, nk, ekb, e_edge, dalpha, scale, d_denom, src,
                          dst, mask, dnq, dnk, heads, dekb)
    G, N, HD = nq.shape
    E = ekb.shape[1]
    cdt = nq.dtype
    _check_widths(HD, HD, heads)
    if dekb is None:
        dekb = torch.empty((G, E, HD), device=nq.device, dtype=cdt)
    lds = (_rows(nq, "nq", cdt, (G, N, HD)), _rows(nk, "nk", cdt, (G, N, HD)),
           _rows(ekb, "ekb", cdt, (G, E, HD)),
           _rows(dekb, "dekb", cdt, (G, E, HD)),
           _rows(dnq, "dnq", torch.float32, (G, N, HD)),
           _rows(dnk, "dnk", torch.float32, (G, N, HD)))
    _require(e_edge, "e_edge", torch.float32, (G, heads, E))
    _require(dalpha, "dalpha", torch.float32, (G, heads, E))
    _require(scale, "scale", torch.float32, (G, N, heads))
    _require(d_denom, "d_denom", torch.float32, (G, N, heads))
    _require_graph(src, dst, mask, G, E)
    route = _bwd2_route(cdt, N, E, HD, heads, _route)
    cw = _bwd2_width(cdt, N, E, HD, heads) if route == 1 else 0
    err = _lib().gat_unproj_bwd2(
        nq.data_ptr(), nk.data_ptr(), ekb.data_ptr(), e_edge.data_ptr(),
        dalpha.data_ptr(), scale.data_ptr(), d_denom.data_ptr(),
        src.data_ptr(), dst.data_ptr(), mask.data_ptr(), dekb.data_ptr(),
        dnq.data_ptr(), dnk.data_ptr(), G, N, E, HD, heads, *lds,
        _dtype_code(nq), route, cw, _stream())
    _build.check(err, "gat_unproj_bwd2")
    _build.count_launch("gat_unproj_bwd2", route)
    return dekb, dnq, dnk


# --------------------------------------------------------------------------
# the op, differentiable
# --------------------------------------------------------------------------

def gat_unprojected_backward(nq, nk, nm, ekb, emb, skb, smb, src, dst, mask,
                             e_edge, denom_raw, scale, e_self, g, heads):
    """The seven gradients (dnq, dnk, dnm, dekb, demb, dskb, dsmb) from the
    output cotangent g (G, N, HD)."""
    HD = nq.shape[-1]
    g = g.float().contiguous()
    # self-loop cotangents; they seed pass 1's node accumulators
    d_msg_self = heads_to_hd(e_self * scale, HD) * g
    d_alpha_self = head_sum((nm + smb).float() * g, heads)
    demb, dalpha, dnm, dscale = bwd1(
        g.to(nq.dtype), nm, emb, e_edge, scale, src, dst, mask,
        d_msg_self.clone(), d_alpha_self * e_self, heads)
    # close the softmax chain: d_denom and the self-loop score cotangents
    gate = (denom_raw > DENOM_EPS).float()
    d_denom = -(scale / torch.clamp_min(denom_raw, DENOM_EPS)) * dscale * gate
    ds_self = heads_to_hd((d_alpha_self * scale + d_denom) * e_self, HD)
    dnk_self = ds_self * nq.float()          # also the gradient of skb
    dnq_self = ds_self * (nk.float() + skb.float())
    dekb, dnq, dnk = bwd2(nq, nk, ekb, e_edge, dalpha, scale,
                          d_denom.contiguous(), src, dst, mask, dnq_self,
                          dnk_self.clone(), heads)
    return (dnq.to(nq.dtype), dnk.to(nk.dtype), dnm.to(nm.dtype), dekb, demb,
            dnk_self.to(skb.dtype), d_msg_self.to(smb.dtype))


class _GatUnprojected(torch.autograd.Function):

    @staticmethod
    def forward(ctx, nq, nk, nm, ekb, emb, skb, smb, src, dst, mask, heads):
        out, e_edge, denom_raw, scale, e_self = gat_unprojected_forward(
            nq, nk, nm, ekb, emb, skb, smb, src, dst, mask, heads)
        ctx.save_for_backward(nq, nk, nm, ekb, emb, skb, smb, src, dst, mask,
                              e_edge, denom_raw, scale, e_self)
        ctx.heads = heads
        return out

    @staticmethod
    def backward(ctx, g):
        grads = gat_unprojected_backward(*ctx.saved_tensors, g, ctx.heads)
        return grads + (None, None, None, None)


def gat_unprojected(nq, nk, nm, ekb, emb, skb, smb, src, dst, mask, heads):
    """The op, differentiable in its first seven arguments (arguments as
    `gat_unprojected_forward`): (G, N, HD) f32."""
    return _GatUnprojected.apply(
        *_contiguous(nq, nk, nm, ekb, emb, skb, smb), src, dst, mask, heads)
