"""The fused kernels of the GNN, each rank on its edge slice, joined by
collectives over the `model` group.

Counterpart of qagnn_tpu/parallel/edge_shard_pallas.py. Each rank of a
model group runs the projected GAT kernels (qagnn_tpu_torch.ops.gat_kernels,
rows 6-9) and the edge encoder's kernels (ops.edge_encoder_kernels, rows
10-12) on its E / n_model edge slots of the data slice's graphs; node
arrays and parameters are the same on every rank of the group. The shards
meet in exactly the collectives the math needs:

  forward  1. all_reduce MAX of the per-head max over masked edges  (G, H)
           2. all_reduce SUM of denominators and degrees     (G, N, H + 1)
           3. all_reduce SUM of the aggregated messages       (G, N, HD)
  backward 4. all_reduce SUM of the per-source d_scale          (G, N, H)
           5. all_reduce SUM of dnq | dnk | dnm and of the four
              projection parameters' gradients, packed in one buffer

The self-loop terms are the same on every rank: they join after the sums,
so they count once. No gradient flows through the max, as in every
backend. On CPU tensors the kernels' wrappers run their plain versions.

Gradient rule: a parameter's gradient leaves these ops summed over the
`model` group only, the same on every rank of it. The train step
(qagnn_tpu_torch.train.step) then sums every gradient once over `data`.
The JAX op sums over both axes inside its backward (:116-122, :281-282),
because nothing else does it there; doing both here would count each
gradient n_data times.

The sharded op has no passthrough output: the layers do not chain the edge
embedding on this path (qagnn_tpu/models/gnn.py:294-296, :557).
"""

from __future__ import annotations

import torch

from qagnn_tpu_torch.ops import edge_encoder_kernels as ek
from qagnn_tpu_torch.ops import gat_kernels as gk
from qagnn_tpu_torch.parallel.mesh import Mesh, all_reduce


def softmax_forward(nq, nk, skb, msg_self, heads, group, scores, denoms,
                    aggregate):
    """The forward of a GAT op on this rank's edge slots around its three
    passes, collectives 1-3 over `group`; the projected op (rows 6-7) and
    the unprojected one (rows 1-3, parallel/edge_shard_map.py) share it.

    scores() -> (per-edge scores, their per-head max m_edge (G, H));
    denoms(scores, gmax) -> (res, denominators (G, N, H), degrees (G, N));
    aggregate(res, gmax, scale, out) -> out + the slots' messages at dst.
    msg_self (G, N, HD) f32 is the self-loop message. Returns (out (G, N,
    HD) f32, res, gmax, denom_raw, scale, e_self)."""
    G, N, HD = nq.shape
    s, m_edge = scores()
    self_scores = gk.head_sum(nq.float() * (nk + skb).float(), heads)
    # 1: the max over every slice's masked edges, then over the self loops.
    # Pass A takes this max before any denominator, so no slice ever sums
    # against its own max, and the JAX op's rescale of each slice's sums by
    # exp(m_edge - gmax) (:66-68) has no counterpart here.
    m_edge = all_reduce(m_edge, group, "max")
    gmax = torch.maximum(m_edge, self_scores.amax(1))
    e_self = torch.exp(self_scores - gmax[:, None, :])
    res, denom_edges, deg = denoms(s, gmax)
    # 2: denominators and degrees of every slice, one buffer
    packed = all_reduce(torch.cat([denom_edges, deg[..., None]], dim=-1),
                        group)
    denom_raw = packed[..., :heads] + e_self
    scale = ((packed[..., heads:] + 1.0)
             / torch.clamp_min(denom_raw, gk.DENOM_EPS)).contiguous()
    out = aggregate(res, gmax, scale, torch.zeros(
        (G, N, HD), device=nq.device, dtype=torch.float32))
    # 3: every slice's messages, then the self-loop term once
    out = all_reduce(out, group) + msg_self * gk.heads_to_hd(e_self * scale,
                                                            HD)
    return out, res, gmax, denom_raw, scale, e_self


def softmax_backward(nq, nk, nm, skb, smb, denom_raw, scale, e_self, g,
                     heads, group, pass1, pass2):
    """The backward of a GAT op on this rank's edge slots around its two
    passes, collectives 4-5 over `group`: the node accumulators of the
    passes start at zero and the self-loop parts join after the sums.

    pass1(g, dnm, dscale) -> (dalpha, dnm, dscale, kept, params);
    pass2(kept, dalpha, d_denom, dnq, dnk) -> (dnq, dnk, edge_grads,
    params): each pass adds into the node accumulators it is given;
    `params` are parameter gradients, summed over `group` with the node
    cotangents in collective 5. Returns (dnq, dnk, dnm, dskb, dsmb,
    edge_grads, the summed params of pass 1 then pass 2)."""
    G, N, HD = nq.shape
    g = g.float().contiguous()
    zeros = lambda *s: torch.zeros(s, device=nq.device,  # noqa: E731
                                   dtype=torch.float32)
    d_msg_self = gk.heads_to_hd(e_self * scale, HD) * g
    d_alpha_self = gk.head_sum((nm + smb).float() * g, heads)
    dalpha, dnm_e, dscale, kept, params1 = pass1(
        g.to(nq.dtype), zeros(G, N, HD), zeros(G, N, heads))
    # 4: the per-source d_scale of every slice, then the self loops'
    dscale = all_reduce(dscale, group) + d_alpha_self * e_self
    gate = (denom_raw > gk.DENOM_EPS).float()
    d_denom = -(scale / torch.clamp_min(denom_raw, gk.DENOM_EPS)) \
        * dscale * gate
    ds_self = gk.heads_to_hd((d_alpha_self * scale + d_denom) * e_self, HD)
    dnq_self = ds_self * (nk.float() + skb.float())
    dnk_self = ds_self * nq.float()
    dnq_e, dnk_e, edge_grads, params2 = pass2(
        kept, dalpha, d_denom.contiguous(), zeros(G, N, HD),
        zeros(G, N, HD))
    # 5: the node cotangents and the parameters' gradients of every slice
    # in one buffer, then the self loops' parts
    parts = [dnq_e, dnk_e, dnm_e, *params1, *params2]
    flat = all_reduce(torch.cat([p.reshape(-1) for p in parts]), group)
    dnq, dnk, dnm, *params = (x.reshape(p.shape) for x, p in zip(
        flat.split([p.numel() for p in parts]), parts))
    return ((dnq + dnq_self).to(nq.dtype), (dnk + dnk_self).to(nk.dtype),
            (dnm + d_msg_self).to(nm.dtype), dnk_self.to(skb.dtype),
            d_msg_self.to(smb.dtype), edge_grads, params)


def sharded_forward(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb, smb,
                    src, dst, mask, heads, group):
    """`gat_projected_forward` on this rank's edge slots, collectives 1-3
    over `group`. Returns what `gat_projected_forward` returns."""
    N = nq.shape[1]
    return softmax_forward(
        nq, nk, skb, nm.float() + smb.float(), heads, group,
        lambda: gk.pass_a_scores(nq, nk, edge_emb, w_ke, b_ke, src, dst,
                                 mask, heads),
        lambda s, gmax: (s, *gk.pass_a_denoms(s, gmax, src, mask, N)),
        lambda s, gmax, scale, out: gk.pass_c(
            nm, edge_emb, w_me, b_me, s, gmax, scale, src, dst, mask, out,
            heads))


def sharded_backward(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb, smb,
                     src, dst, mask, scores, gmax, denom_raw, scale, e_self,
                     g, heads, group):
    """`gat_projected_backward` on this rank's edge slots, collectives 4-5
    over `group`."""
    def pass1(g, dnm, dscale):
        demb, dalpha, dnm, dscale, dw_me, db_me = gk.bwd_pass1(
            g, nm, edge_emb, w_me, b_me, scores, gmax, scale, src, dst,
            mask, None, dnm, dscale, heads)
        return dalpha, dnm, dscale, demb, (dw_me, db_me)

    def pass2(demb, dalpha, d_denom, dnq, dnk):
        demb, dnq, dnk, dw_ke, db_ke = gk.bwd_pass2(
            nq, nk, edge_emb, w_ke, b_ke, scores, gmax, dalpha, scale,
            d_denom, src, dst, mask, demb, dnq, dnk, heads)
        return dnq, dnk, demb, (dw_ke, db_ke)

    dnq, dnk, dnm, dskb, dsmb, demb, (dw_me, db_me, dw_ke, db_ke) = \
        softmax_backward(nq, nk, nm, skb, smb, denom_raw, scale, e_self, g,
                         heads, group, pass1, pass2)
    return (dnq, dnk, dnm, demb, dw_ke.to(w_ke.dtype), db_ke.to(b_ke.dtype),
            dw_me.to(w_me.dtype), db_me.to(b_me.dtype), dskb, dsmb)


class _GatProjectedSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb, smb,
                src, dst, mask, heads, group):
        out, *res = sharded_forward(nq, nk, nm, edge_emb, w_ke, b_ke, w_me,
                                    b_me, skb, smb, src, dst, mask, heads,
                                    group)
        ctx.save_for_backward(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me,
                              skb, smb, src, dst, mask, *res)
        ctx.heads, ctx.group = heads, group
        return out

    @staticmethod
    def backward(ctx, g):
        grads = sharded_backward(*ctx.saved_tensors, g, ctx.heads, ctx.group)
        return grads + (None,) * 5


def gat_projected_sharded(nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb,
                          smb, src, dst, mask, heads, mesh: Mesh):
    """The projected GAT op (arguments as `gat_projected`) with the edge
    arrays edge_emb (G, E_l, D), src, dst, mask (G, E_l) holding this
    rank's E_l = E / n_model slots; node arrays and parameters whole and
    the same on every rank of the model group. Returns (G, N, HD) f32, the
    same on every rank of the group. Widths the kernels do not take are
    padded as `gat_projected` pads them; an edge embedding at the kernels'
    width (`edge_hidden_sharded`'s on the fused GNN) is taken as it is."""
    args = (nq, nk, nm, edge_emb, w_ke, b_ke, w_me, b_me, skb, smb)
    D, HD = gk.emb_width(edge_emb, w_ke)[0], nq.shape[-1]
    if gk.kernel_widths(D, HD, heads) == (D, HD):
        return _GatProjectedSharded.apply(*gk._contiguous(*args), src, dst,
                                          mask, heads, mesh.model_group)
    out = _GatProjectedSharded.apply(
        *gk._contiguous(*gk.pad_widths(*args, heads)), src, dst, mask, heads,
        mesh.model_group)
    return gk.cut_heads(out, HD, heads)


# --------------------------------------------------------------------------
# the edge encoder's kernels
# --------------------------------------------------------------------------

def edge_feature_moments_sharded(edge_type, src, dst, node_type, mask, n_rel,
                                 n_ntype, mesh: Mesh):
    """Row 10 on this rank's slots, the histogram, second moment and row
    count summed over the whole world (every data and model slice): the
    BatchNorm statistic of the edge rows is that of the global batch. No
    gradient flows through these."""
    hist, M, n = ek.edge_feature_moments(edge_type, src, dst, node_type,
                                         mask, n_rel, n_ntype)
    F = hist.shape[0]
    flat = all_reduce(torch.cat([hist, M.reshape(-1), n.reshape(1)]),
                      mesh.world_group)
    return flat[:F], flat[F:F + F * F].reshape(F, F), flat[-1]


class _EdgeHiddenSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edge_type, src, dst, node_type, w0, b0, a, b, n_rel,
                n_ntype, out_dtype, group):
        ctx.save_for_backward(edge_type, src, dst, node_type, w0, b0, a, b)
        ctx.consts = (n_rel, n_ntype, out_dtype, group)
        return ek.edge_hidden_forward(edge_type, src, dst, node_type, w0, b0,
                                      a, b, n_rel, n_ntype, out_dtype)

    @staticmethod
    def backward(ctx, dh):
        n_rel, n_ntype, out_dtype, group = ctx.consts
        grads = ek.edge_hidden_backward(
            *ctx.saved_tensors, dh.to(out_dtype).contiguous(), n_rel,
            n_ntype)
        flat = all_reduce(torch.cat([x.reshape(-1) for x in grads]), group)
        dw0, db0, da, db = (x.reshape(p.shape) for x, p in zip(
            flat.split([p.numel() for p in grads]), grads))
        return (None,) * 4 + (dw0, db0, da, db) + (None,) * 4


def edge_hidden_sharded(edge_type, src, dst, node_type, w0, b0, a, b, n_rel,
                        n_ntype, out_dtype, mesh: Mesh):
    """Rows 11-12 on this rank's slots: h (G, E_l, D) of its slots (D the
    width of w0 and b0, a and b: the fused GNN hands them padded to the
    kernels' width), with no collective in the forward; the backward sums
    the four parameter gradients over the model group."""
    return _EdgeHiddenSharded.apply(edge_type, src, dst, node_type, w0, b0,
                                    a, b, n_rel, n_ntype, out_dtype,
                                    mesh.model_group)
