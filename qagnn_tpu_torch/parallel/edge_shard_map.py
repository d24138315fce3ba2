"""The unprojected relational GAT op, edge-partitioned over `model`.

Counterpart of qagnn_tpu/parallel/edge_shard_map.py:71-173
(`edge_sharded_gat_nodes`): each rank of a model group holds E / n_model
edge slots of every graph (edge arrays), node arrays whole. It runs the
unprojected op's five kernels (qagnn_tpu_torch.ops.gat_unproj_kernels,
rows 1-5) on its slots, joined by the projected op's collectives through
the glue both share (parallel/edge_shard_kernels.py `softmax_forward`,
`softmax_backward`): the MAX of the per-head max (no gradient through
it), the SUM of denominators and degrees and the SUM of the aggregated
messages in the forward; the SUM of d_scale and of the node cotangents in
the backward. On CPU tensors the wrappers run the kernels'
plain versions, the scatter arm. Its values and gradients are those of
the single-rank op up to the order of the sums.
"""

from __future__ import annotations

import torch

from qagnn_tpu_torch.ops import gat_kernels as gk
from qagnn_tpu_torch.ops import gat_unproj_kernels as uk
from qagnn_tpu_torch.parallel import edge_shard_kernels as esk
from qagnn_tpu_torch.parallel.mesh import Mesh


def _forward(nq, nk, nm, ekb, emb, skb, smb, src, dst, mask, heads, group):
    N = nq.shape[1]
    out, e_edge, _, denom_raw, scale, e_self = esk.softmax_forward(
        nq, nk, skb, (nm + smb).float(), heads, group,
        lambda: uk.edge_scores(nq, nk, ekb, src, dst, mask, heads),
        lambda s, gmax: uk.edge_denoms(s, gmax, src, mask, N),
        lambda e_edge, gmax, scale, out: uk.aggregate(
            nm, emb, e_edge, scale, src, dst, mask, out, heads))
    return out, e_edge, denom_raw, scale, e_self


def _backward(nq, nk, nm, ekb, emb, skb, smb, src, dst, mask, e_edge,
              denom_raw, scale, e_self, g, heads, group):
    def pass1(g, dnm, dscale):
        demb, dalpha, dnm, dscale = uk.bwd1(g, nm, emb, e_edge, scale, src,
                                            dst, mask, dnm, dscale, heads)
        return dalpha, dnm, dscale, demb, ()

    def pass2(demb, dalpha, d_denom, dnq, dnk):
        dekb, dnq, dnk = uk.bwd2(nq, nk, ekb, e_edge, dalpha, scale, d_denom,
                                 src, dst, mask, dnq, dnk, heads)
        return dnq, dnk, (dekb, demb), ()

    dnq, dnk, dnm, dskb, dsmb, (dekb, demb), _ = esk.softmax_backward(
        nq, nk, nm, skb, smb, denom_raw, scale, e_self, g, heads, group,
        pass1, pass2)
    return dnq, dnk, dnm, dekb, demb, dskb, dsmb


class _EdgeShardedGat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nq, nk, nm, ekb, emb, skb, smb, src, dst, mask, heads,
                group):
        out, *res = _forward(nq, nk, nm, ekb, emb, skb, smb, src, dst, mask,
                             heads, group)
        ctx.save_for_backward(nq, nk, nm, ekb, emb, skb, smb, src, dst, mask,
                              *res)
        ctx.heads, ctx.group = heads, group
        return out

    @staticmethod
    def backward(ctx, g):
        return _backward(*ctx.saved_tensors, g, ctx.heads, ctx.group) \
            + (None,) * 5


def edge_sharded_gat_nodes(node_query, node_key, node_msg, edge_key_bias,
                           edge_msg_bias, self_key_bias, self_msg_bias,
                           edge_src, edge_dst, edge_mask, *, mesh: Mesh):
    """Edge-partitioned forward of the relational GAT core, differentiable
    in its first seven arguments: node tensors (G, N, H, D) whole, edge
    tensors (G, E_l, H, D) and edge_src/edge_dst/edge_mask (G, E_l) this
    rank's slots. Returns (G, N, H*D) f32, the same on every rank of the
    model group."""
    G, N, H, D = node_query.shape

    def flat(t):
        return t.reshape(t.shape[0], t.shape[1], H * D)

    return _EdgeShardedGat.apply(
        *gk._contiguous(*(flat(t) for t in (
            node_query, node_key, node_msg, edge_key_bias, edge_msg_bias,
            self_key_bias, self_msg_bias))),
        edge_src.to(torch.int32).contiguous(),
        edge_dst.to(torch.int32).contiguous(),
        edge_mask.to(torch.bool).contiguous(), H, mesh.model_group)
