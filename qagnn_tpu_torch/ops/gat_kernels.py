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
chosen by dtype and widths alone (`_fwd_route`): bfloat16 at D, HD <= 256
with heads of at least 4 features runs the projection on tensor cores
(csrc/gat_fwd_tc.cuh: persistent blocks with W resident in shared memory),
anything else stays on CUDA cores, float32 in full f32.

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

Both backward passes have two routes behind one entry point, chosen by the
dtype alone: bfloat16 runs the three products of a pass on tensor cores
(csrc/gat_bwd_tc.cuh: persistent blocks with W resident in shared memory),
float32 stays on CUDA cores in full f32.

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
edge padding is needed: any E works. The kernels take D and HD that are
multiples of 8, HD <= 256 (the backward also D <= 256 and heads of at least
4 features) and at most 8 heads; the plain versions take any.

The unprojected op (`pallas_relational_gat`: precomputed per-edge biases, no
projection in the kernels) is the sibling module `gat_unproj_kernels`, which
shares this module's helpers (`head_sum`, `heads_to_hd`, the node gathers
and scatters, the width and dtype checks).
"""

from __future__ import annotations

import ctypes

import torch

from qagnn_tpu_torch.ops import _build

DENOM_EPS = 1e-16
NEG = -1e30

_P = ctypes.c_void_p
_I = ctypes.c_int


_SIGNATURES = {
    "gat_pass_a_scores": [_P] * 10 + [_I] * 10 + [_P],
    "gat_pass_a_denoms": [_P] * 6 + [_I] * 4 + [_P],
    "gat_pass_c": [_P] * 11 + [_I] * 10 + [_P],
}


_BWD_SIGNATURES = {
    "gat_bwd_pass1": [_P] * 22 + [_I] * 11 + [_P],
    "gat_bwd_pass2": [_P] * 22 + [_I] * 11 + [_P],
}
DW_SPLITS = 128      # edge ranges (rows of partials) of the dW products
# the tensor-core routes (csrc/gat_fwd_tc.cuh, csrc/gat_bwd_tc.cuh)
TC_UNIT = 16                 # edges a warp works on at a time
TC_MAX_WARPS = 8
TC_SMEM_LIMIT = 232_448      # dynamic shared memory a block may ask for


def _lib():
    return _build.load("gat_fwd", _SIGNATURES)


def _bwd_lib():
    return _build.load("gat_bwd", _BWD_SIGNATURES)


def _dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"GAT kernels take float32 or bfloat16, got {t.dtype}")


_require = _build.require


def _check_widths(D: int, HD: int, heads: int) -> None:
    if D % 8 or HD % 8 or HD > 256 or heads > 8 or HD % heads:
        raise ValueError(f"GAT kernels take D, HD multiples of 8, HD <= 256 "
                         f"and <= 8 heads dividing HD; got D={D}, HD={HD}, "
                         f"heads={heads}")


def _check_bwd_widths(D: int, HD: int, heads: int) -> None:
    _check_widths(D, HD, heads)
    if D > 256 or HD // heads < 4:
        raise ValueError(f"GAT backward kernels take D <= 256 and heads of "
                         f"at least 4 features; got D={D}, HD={HD}, "
                         f"heads={heads}")


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

def pass_a_scores_plain(nq, nk, edge_emb, w_ke, b_ke, src, dst, mask, heads):
    ekb = _edge_projection_plain(edge_emb, w_ke, b_ke, nq.dtype)
    eq = _gather_nodes(nq, src).float()
    ek = _gather_nodes(nk, dst).float() + ekb
    live = mask[:, None, :]
    scores = torch.where(live, head_sum(eq * ek, heads).transpose(1, 2),
                         0.0).contiguous()                           # (G,H,E)
    m_edge = torch.where(live, scores, NEG).amax(-1)                  # (G,H)
    return scores, torch.clamp_min(m_edge, NEG)


def pass_a_scores(nq, nk, edge_emb, w_ke, b_ke, src, dst, mask, heads,
                  _route=None):
    """Scores (G, H, E) f32, 0 at masked slots, and the max over masked
    edges (G, H) f32 (NEG for a graph with no masked edge). `_route` names
    a route (`_fwd_route`) to time it beside the other."""
    if not nq.is_cuda:
        return pass_a_scores_plain(nq, nk, edge_emb, w_ke, b_ke, src, dst,
                                   mask, heads)
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
    warps, n_blocks = _fwd_launch_plan(route, G, E, D, HD, nq.device)
    scores = torch.empty((G, heads, E), device=nq.device, dtype=torch.float32)
    m_edge = torch.full((G, heads), NEG, device=nq.device,
                        dtype=torch.float32)
    err = _lib().gat_pass_a_scores(
        nq.data_ptr(), nk.data_ptr(), edge_emb.data_ptr(), w_ke.data_ptr(),
        b_ke.data_ptr(), src.data_ptr(), dst.data_ptr(), mask.data_ptr(),
        scores.data_ptr(), m_edge.data_ptr(), G, N, E, D, HD, heads,
        _dtype_code(nq), route, warps, n_blocks, _stream())
    _build.check(err, "gat_pass_a_scores")
    _build.count_launch("gat_pass_a_scores", route)
    return scores, m_edge


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
    no second (G, N, HD) buffer), and returns it. `_route` as in
    `pass_a_scores`."""
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
    warps, n_blocks = _fwd_launch_plan(route, G, E, D, HD, nm.device)
    err = _lib().gat_pass_c(
        nm.data_ptr(), edge_emb.data_ptr(), w_me.data_ptr(), b_me.data_ptr(),
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


def _weight_grads(edge_emb, cot_c, cot):
    """(emb^T cot_c over all edges (D, HD), column sums of cot (HD,))."""
    D, HD = edge_emb.shape[-1], cot.shape[-1]
    dw = edge_emb.float().reshape(-1, D).t() @ cot_c.float().reshape(-1, HD)
    return dw, cot.sum((0, 1))


def bwd_pass1_plain(gout, nm, edge_emb, w_me, b_me, scores, gmax, scale, src,
                    dst, mask, carry, dnm, dscale, heads):
    cdt = nm.dtype
    HD = nm.shape[-1]
    msg = _gather_nodes(nm, src).float() \
        + _edge_projection_plain(edge_emb, w_me, b_me, cdt)
    g_dst = _gather_nodes(gout, dst).float()
    e = _edge_exp(scores, gmax, mask)                               # (G,E,H)
    alpha = _round(e * _gather_nodes(_round(scale, cdt), src), cdt)
    d_msg = heads_to_hd(alpha, HD) * g_dst
    d_msg_c = d_msg.to(cdt)
    demb = d_msg_c.float() @ w_me.to(cdt).float().t()
    if carry is not None:
        demb = demb + carry.float()
    dalpha = torch.where(mask[..., None], head_sum(msg * g_dst, heads), 0.0)
    dw, db = _weight_grads(edge_emb, d_msg_c, d_msg)
    _scatter_nodes(dnm, src, d_msg_c.float())
    _scatter_nodes(dscale, src, _round(dalpha * e, cdt))
    return (demb.to(edge_emb.dtype), dalpha.transpose(1, 2).contiguous(),
            dnm, dscale, dw, db)


def _bwd_route(cdt, route):
    """0: CUDA cores, 1: tensor cores. The dtype alone decides; `route`
    names the CUDA-core kernels for bfloat16 (to time them beside the
    tensor-core ones)."""
    if route is None:
        return 1 if cdt == torch.bfloat16 else 0
    if route not in (0, 1) or (route == 1 and cdt != torch.bfloat16):
        raise ValueError(f"no route {route} of the GAT backward kernels for "
                         f"{cdt}")
    return route


def _fwd_route(cdt, D, HD, heads, route):
    """Route of the forward passes A (scores) and C: 0 CUDA cores, 1 tensor
    cores, for bfloat16 where their widths hold (D and HD <= 256, heads of at
    least 4 features). Dtype and widths alone decide; `route` names one, 0
    for bfloat16 to time the CUDA-core kernels beside the tensor-core ones."""
    fits = cdt == torch.bfloat16 and D <= 256 and HD <= 256 \
        and HD // heads >= 4
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


def _tc_smem_bytes(D, HD, warps):
    """The backward edge kernel's (alpha or d_s, e, d_alpha and the nodes
    beside each stage)."""
    return _tc_smem(D, HD, warps, 3 * TC_UNIT * 8 + 2 * TC_UNIT)


def _fwd_smem_bytes(D, HD, warps):
    """The forward kernel's (scores or alpha and the nodes beside each
    stage; no cotangent tile)."""
    return _tc_smem(D, HD, warps, TC_UNIT * 8 + 2 * TC_UNIT)


def _persistent_plan(smem_bytes, G, E, D, HD, n_sm, what):
    """(warps per block, blocks): as many warps as shared memory holds
    beside W, one persistent block per SM, no more blocks than units
    of work for their warps."""
    warps = max((w for w in range(1, TC_MAX_WARPS + 1)
                 if smem_bytes(D, HD, w) <= TC_SMEM_LIMIT), default=0)
    if warps == 0:
        raise ValueError(f"{what}: D={D}, HD={HD} leave no shared memory for "
                         "a warp beside W")
    units = G * -(-E // TC_UNIT)
    return warps, max(1, min(n_sm, -(-units // warps)))


def _tc_plan(G, E, D, HD, n_sm):
    """The backward tensor-core edge kernel's plan."""
    return _persistent_plan(_tc_smem_bytes, G, E, D, HD, n_sm,
                            "GAT backward")


def _fwd_tc_plan(G, E, D, HD, n_sm):
    """The forward tensor-core kernel's plan (passes A and C alike)."""
    return _persistent_plan(_fwd_smem_bytes, G, E, D, HD, n_sm,
                            "GAT forward")


def _fwd_launch_plan(route, G, E, D, HD, device):
    """(warps, n_blocks) for the forward kernels' C entry points: the
    tensor-core plan on route 1; route 0's grid follows from the shapes."""
    if route == 0:
        return 0, 0
    return _fwd_tc_plan(G, E, D, HD, _sm_count(device))


def _split_scratch(G, E, D, HD, device, route=0, n_sm=1):
    """(n_split, warps, n_blocks, dw_part (n_split, D, HD), db_part): the
    partial sums of dW over n_split edge ranges and of db, one row per block
    of the edge kernel: (64-edge tile, graph) blocks on CUDA cores (warps
    and n_blocks are 0: that grid follows from the shapes), n_blocks
    persistent blocks on tensor cores, where dW is split once per SM."""
    if route == 1:
        warps, n_blocks = _tc_plan(G, E, D, HD, n_sm)
        n_split, db_rows = max(1, min(n_sm, -(-G * E // 32))), n_blocks
    else:
        warps = n_blocks = 0
        n_split = max(1, min(DW_SPLITS, -(-G * E // 32)))
        db_rows = G * -(-E // 64)
    return (n_split, warps, n_blocks,
            torch.empty((n_split, D, HD), device=device, dtype=torch.float32),
            torch.empty((db_rows, HD), device=device, dtype=torch.float32))


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def bwd_pass1(gout, nm, edge_emb, w_me, b_me, scores, gmax, scale, src, dst,
              mask, carry, dnm, dscale, heads, _route=None):
    """Backward pass 1. gout: (G, N, HD) output cotangent in the compute
    dtype; carry: (G, E, D) in the embedding's dtype or None; dnm (G, N, HD)
    and dscale (G, N, H) f32 arrive seeded with the self-loop cotangents and
    are added to IN PLACE.

    Returns (demb (G, E, D) in the embedding's dtype, d_alpha (G, H, E) f32
    (0 at masked slots), dnm, dscale, dW_me (D, HD) f32, db_me (HD,) f32).
    """
    if not nm.is_cuda:
        return bwd_pass1_plain(gout, nm, edge_emb, w_me, b_me, scores, gmax,
                               scale, src, dst, mask, carry, dnm, dscale,
                               heads)
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
    route = _bwd_route(cdt, _route)
    # the tensor-core kernels read W_me both ways from one shared tile
    w_t = None if route == 1 else w_me.t().contiguous()
    dmsg = torch.empty((G, E, HD), device=dev, dtype=cdt)
    demb = torch.empty((G, E, D), device=dev, dtype=cdt)
    dalpha = torch.empty((G, heads, E), device=dev, dtype=torch.float32)
    dw = torch.empty((D, HD), device=dev, dtype=torch.float32)
    db = torch.empty((HD,), device=dev, dtype=torch.float32)
    n_split, warps, n_blocks, dw_part, db_part = _split_scratch(
        G, E, D, HD, dev, route, _sm_count(dev))
    err = _bwd_lib().gat_bwd_pass1(
        gout.data_ptr(), nm.data_ptr(), edge_emb.data_ptr(), w_me.data_ptr(),
        None if w_t is None else w_t.data_ptr(), b_me.data_ptr(),
        scores.data_ptr(), gmax.data_ptr(),
        scale.data_ptr(), src.data_ptr(), dst.data_ptr(), mask.data_ptr(),
        None if carry is None else carry.data_ptr(), dmsg.data_ptr(),
        demb.data_ptr(), dalpha.data_ptr(), dnm.data_ptr(),
        dscale.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(),
        dw.data_ptr(), db.data_ptr(), G, N, E, D, HD, heads, n_split,
        _dtype_code(nm), route, warps, n_blocks, _stream())
    _build.check(err, "gat_bwd_pass1")
    _build.count_launch("gat_bwd_pass1", route)
    return demb, dalpha, dnm, dscale, dw, db


# --------------------------------------------------------------------------
# backward pass 2 (score side)
# --------------------------------------------------------------------------

def bwd_pass2_plain(nq, nk, edge_emb, w_ke, b_ke, scores, gmax, dalpha, scale,
                    d_denom, src, dst, mask, demb, dnq, dnk, heads):
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
    demb = (demb.float() + dekb_c.float() @ w_ke.to(cdt).float().t()) \
        .to(demb.dtype)
    dw, db = _weight_grads(edge_emb, dekb_c, dekb)
    _scatter_nodes(dnq, src, (ds_hd * key).to(cdt).float())
    _scatter_nodes(dnk, dst, dekb_c.float())
    return demb, dnq, dnk, dw, db


def bwd_pass2(nq, nk, edge_emb, w_ke, b_ke, scores, gmax, dalpha, scale,
              d_denom, src, dst, mask, demb, dnq, dnk, heads, _route=None):
    """Backward pass 2. demb (G, E, D) is pass 1's result and is added to IN
    PLACE on the kernel path, as are dnq and dnk (G, N, HD) f32, which
    arrive seeded with the self-loop cotangents.

    Returns (demb, dnq, dnk, dW_ke (D, HD) f32, db_ke (HD,) f32)."""
    if not nq.is_cuda:
        return bwd_pass2_plain(nq, nk, edge_emb, w_ke, b_ke, scores, gmax,
                               dalpha, scale, d_denom, src, dst, mask, demb,
                               dnq, dnk, heads)
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
    _require(demb, "demb", cdt, (G, E, D))
    _require(dnq, "dnq", torch.float32, (G, N, HD))
    _require(dnk, "dnk", torch.float32, (G, N, HD))
    dev = nq.device
    route = _bwd_route(cdt, _route)
    w_t = None if route == 1 else w_ke.t().contiguous()
    dekb = torch.empty((G, E, HD), device=dev, dtype=cdt)
    dw = torch.empty((D, HD), device=dev, dtype=torch.float32)
    db = torch.empty((HD,), device=dev, dtype=torch.float32)
    n_split, warps, n_blocks, dw_part, db_part = _split_scratch(
        G, E, D, HD, dev, route, _sm_count(dev))
    err = _bwd_lib().gat_bwd_pass2(
        nq.data_ptr(), nk.data_ptr(), edge_emb.data_ptr(), w_ke.data_ptr(),
        None if w_t is None else w_t.data_ptr(), b_ke.data_ptr(),
        scores.data_ptr(), gmax.data_ptr(),
        dalpha.data_ptr(), scale.data_ptr(), d_denom.data_ptr(),
        src.data_ptr(), dst.data_ptr(), mask.data_ptr(), dekb.data_ptr(),
        demb.data_ptr(), dnq.data_ptr(), dnk.data_ptr(), dw_part.data_ptr(),
        db_part.data_ptr(), dw.data_ptr(), db.data_ptr(), G, N, E, D, HD,
        heads, n_split, _dtype_code(nq), route, warps, n_blocks, _stream())
    _build.check(err, "gat_bwd_pass2")
    _build.count_launch("gat_bwd_pass2", route)
    return demb, dnq, dnk, dw, db


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


def gat_projected_chained(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb,
                          smb, src, dst, mask, heads):
    """The op, differentiable in its first ten arguments (arguments as
    `gat_projected_forward`). Returns (out (G, N, HD) f32, edge_emb): hand
    the returned embedding to the next layer, so that the edge embedding's
    cotangent accumulates through the layers' backward kernels."""
    return _GatProjected.apply(
        *_contiguous(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb, smb),
        src, dst, mask, heads)


def gat_projected(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb, smb,
                  src, dst, mask, heads):
    """The op without the passthrough: (G, N, HD) f32."""
    return gat_projected_chained(nq, nk, nm, edge_emb, w_ke, b_ke, w_me,
                                 b_me, skb, smb, src, dst, mask, heads)[0]
