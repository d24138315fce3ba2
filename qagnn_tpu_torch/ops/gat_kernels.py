"""Forward of the projected relational GAT op on hand-written CUDA kernels.

Counterpart of the forward of `pallas_relational_gat_projected[_chained]`
(qagnn_tpu/ops/pallas_gat.py:1019-1050 `_proj_fwd_impl`). The op runs

  * pass A, scores (csrc/gat_fwd.cu `gat_pass_a_scores`): per edge the key
    bias ekb = emb W_ke + b_ke, the per-head logit
    s = <nq[src], nk[dst] + ekb> and the max over masked edges per
    (graph, head);
  * torch glue: the self-loop scores, gmax over masked edges AND all N
    self scores, e_self;
  * pass A, denominators (`gat_pass_a_denoms`): per-source sums of
    exp(min(s - gmax, 0)) and out-degrees over masked edges;
  * torch glue: scale = (deg + 1) / max(denom_edges + e_self, 1e-16) and the
    self-loop term (nm + smb) * e_self * scale that seeds the output;
  * pass C (`gat_pass_c`): out[dst] += exp(min(s - gmax, 0)) * scale[src]
    * (nm[src] + emb W_me + b_me) over masked edges.

Every kernel has a plain torch version here with the same arithmetic: node
and edge inputs in the compute dtype, the projection weights rounded to it,
everything after in f32. A wrapper takes the plain version for CPU tensors
only; for CUDA tensors it launches its kernel or raises.

Unlike the TPU op the edge embedding is (G, E, D), not transposed, and no
edge padding is needed: any E works. The kernels take D and HD that are
multiples of 8, HD <= 256 and at most 8 heads; the plain versions take any.
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
    "gat_pass_a_scores": [_P] * 10 + [_I] * 7 + [_P],
    "gat_pass_a_denoms": [_P] * 6 + [_I] * 4 + [_P],
    "gat_pass_c": [_P] * 11 + [_I] * 7 + [_P],
}


def _lib():
    return _build.load("gat_fwd", _SIGNATURES)


def _dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"GAT kernels take float32 or bfloat16, got {t.dtype}")


def _require(t: torch.Tensor, name: str, dtype, shape) -> None:
    if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous CUDA {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def _check_widths(D: int, HD: int, heads: int) -> None:
    if D % 8 or HD % 8 or HD > 256 or heads > 8 or HD % heads:
        raise ValueError(f"GAT kernels take D, HD multiples of 8, HD <= 256 "
                         f"and <= 8 heads dividing HD; got D={D}, HD={HD}, "
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
    scores = head_sum(eq * ek, heads).transpose(1, 2).contiguous()  # (G,H,E)
    m_edge = torch.where(mask[:, None, :], scores, NEG).amax(-1)      # (G,H)
    return scores, torch.clamp_min(m_edge, NEG)


def pass_a_scores(nq, nk, edge_emb, w_ke, b_ke, src, dst, mask, heads):
    """Scores (G, H, E) f32 and the max over masked edges (G, H) f32
    (NEG for a graph with no masked edge)."""
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
    scores = torch.empty((G, heads, E), device=nq.device, dtype=torch.float32)
    m_edge = torch.full((G, heads), NEG, device=nq.device,
                        dtype=torch.float32)
    err = _lib().gat_pass_a_scores(
        nq.data_ptr(), nk.data_ptr(), edge_emb.data_ptr(), w_ke.data_ptr(),
        b_ke.data_ptr(), src.data_ptr(), dst.data_ptr(), mask.data_ptr(),
        scores.data_ptr(), m_edge.data_ptr(), G, N, E, D, HD, heads,
        _dtype_code(nq), _stream())
    _build.check(err, "gat_pass_a_scores")
    _build.count_launch("gat_pass_a_scores")
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

def pass_c_plain(nm, edge_emb, w_me, b_me, scores, gmax, scale, src, dst,
                 mask, out, heads):
    G, N, HD = nm.shape
    E = src.shape[1]
    msg = _gather_nodes(nm, src).float() \
        + _edge_projection_plain(edge_emb, w_me, b_me, nm.dtype)
    e = torch.exp(torch.clamp_max(scores - gmax[:, :, None], 0.0)) \
        * mask[:, None, :]
    alpha = e.transpose(1, 2) * _gather_nodes(scale, src)           # (G,E,H)
    w = msg * heads_to_hd(alpha, HD)
    return out.scatter_add_(1, dst.long()[..., None].expand(G, E, HD), w)


def pass_c(nm, edge_emb, w_me, b_me, scores, gmax, scale, src, dst, mask,
           out, heads):
    """Adds alpha * msg of every masked edge at its dst into `out`
    (G, N, HD) f32, IN PLACE (the caller seeds it with the self-loop term;
    no second (G, N, HD) buffer), and returns it."""
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
    err = _lib().gat_pass_c(
        nm.data_ptr(), edge_emb.data_ptr(), w_me.data_ptr(), b_me.data_ptr(),
        scores.data_ptr(), gmax.data_ptr(), scale.data_ptr(), src.data_ptr(),
        dst.data_ptr(), mask.data_ptr(), out.data_ptr(), G, N, E, D, HD,
        heads, _dtype_code(nm), _stream())
    _build.check(err, "gat_pass_c")
    _build.count_launch("gat_pass_c")
    return out


# --------------------------------------------------------------------------
# the op
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
    scale (G, N, H) f32).
    """
    G, N, HD = nq.shape
    scores, m_edge = pass_a_scores(nq, nk, edge_emb, w_ke, b_ke, src, dst,
                                   mask, heads)
    self_scores = head_sum(nq.float() * (nk + skb).float(), heads)  # (G,N,H)
    gmax = torch.maximum(m_edge, self_scores.amax(1))                 # (G,H)
    e_self = torch.exp(self_scores - gmax[:, None, :])
    denom_edges, deg = pass_a_denoms(scores, gmax, src, mask, N)
    scale = (deg[..., None] + 1.0) \
        / torch.clamp_min(denom_edges + e_self, DENOM_EPS)
    out = (nm.float() + smb.float()) * heads_to_hd(e_self * scale, HD)
    out = pass_c(nm, edge_emb, w_me, b_me, scores, gmax, scale, src, dst,
                 mask, out, heads)
    return out, scores, gmax, scale
