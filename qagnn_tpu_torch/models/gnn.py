"""Relation-aware GNN: EdgeEncoder, GATConvE and the k-layer message passing.

Counterpart of qagnn_tpu/models/gnn.py, eval and train mode. Two branches
compute the same function:

  * fused (backend "cuda"): the edge rows of the shared edge encoder run in
    the `edge_hidden` kernel, its linear_1 is composed into each layer's
    key_e / msg_e projections, and each layer's attention runs in the
    projected GAT kernels (qagnn_tpu_torch.ops.gat_kernels) with the node
    projections split over (X, node_extra). In train mode the edge rows'
    BatchNorm moments come from the feature-moments kernel in closed form,
    the edge embedding is chained through the layers so that its cotangent
    accumulates inside the backward kernels, and every backward of a kernel
    is a kernel;
  * reference (backend "scatter"): one-hot edge features, the full encoder
    and the scatter oracle of qagnn_tpu_torch.ops.gat_attention.

The default backend follows the device: "cuda" for CUDA tensors, "scatter"
otherwise. On CPU tensors the fused branch runs the kernels' plain versions.
Parameters and BatchNorm's running statistics stay f32; `dtype` is the
compute dtype. float64 runs the scatter branch in f64 end to end, BatchNorm's
batch moments included: a reference for the f32 paths' gradients.

With a `mesh` (qagnn_tpu_torch.parallel.mesh; qagnn_tpu/models/gnn.py
:140-151, 292-296, 353-364, 501-521) the edge arrays are this rank's edge
slice (parallel/graph_sharding.py pads E once for the split before the
encoder, so the encoder and the layers agree on it) and the fused branch
runs the kernels' edge-partitioned forms (parallel/edge_shard_kernels.py),
whatever the backend default: the feature moments summed over every rank,
the hidden pass on the slice, the attention joined by its five
collectives, with no chaining of the edge embedding; BatchNorm takes the
statistics of the whole batch. The detail path (return_alpha) is single-rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from qagnn_tpu_torch.models.layers import ProjParams, dense, dropout, gelu
from qagnn_tpu_torch.models.norm import MaskedBatchNorm, MomentPart
from qagnn_tpu_torch.ops.edge_encoder_kernels import (
    analytic_edge_moments,
    edge_feature_moments,
    edge_hidden,
)
from qagnn_tpu_torch.ops.gat_attention import (
    relational_gat_attention_nodes,
    resolve_backend,
)
from qagnn_tpu_torch.ops.gat_kernels import gat_projected_chained, kernel_d
from qagnn_tpu_torch.parallel.edge_shard_kernels import (
    edge_feature_moments_sharded,
    edge_hidden_sharded,
    gat_projected_sharded,
)


class EdgeEncoder(nn.Module):
    """Shared edge-feature MLP: Linear -> BatchNorm -> ReLU -> Linear
    (reference modeling/modeling_qagnn.py:30). BatchNorm statistics are
    those of the union of masked edge rows and all self-loop rows."""

    def __init__(self, hidden_size: int, n_feat: int, num_updates: int = 1,
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        self.dtype, self.mesh = dtype, mesh
        self.linear_0 = ProjParams(n_feat, hidden_size)
        self.linear_1 = ProjParams(hidden_size, hidden_size)
        self.bn = MaskedBatchNorm(hidden_size, num_updates=num_updates,
                                  mesh=mesh)

    def forward(self, edge_feat, weight=None, *, edge_ints=None,
                n_rel: int | None = None, n_ntype: int | None = None):
        """edge_feat: (rows, F) with a stat weight, or a list of
        (rows_i, F), weight_i parts sharing one statistic. Returns the
        linear_1 outputs (one per part).

        edge_ints = (edge_type, edge_src, edge_dst, node_type, edge_mask):
        the fused edge side. edge_feat is then only the self-loop rows; the
        edge rows' linear_0 + BN + ReLU run in the `edge_hidden` kernel and
        linear_1 is left to the caller. In train mode the masked edge rows
        enter the batch statistic through their closed-form moments (the
        feature-moments kernel; differentiable in W0, b0 by autograd).
        Returns ((h_edge (G, E, Dk), h_self), (W1, b1)): h_edge at the GAT
        kernels' width Dk = `kernel_d(D)`, zeros past D, which the layers
        carry as it is (no pad or slice of an edge-sized array); the
        parameters, the BatchNorm and its statistics keep width D."""
        cdt, mesh = self.dtype, self.mesh
        if edge_ints is not None:
            etype, esrc, edst, ntype, emask = edge_ints
            w0, b0 = self.linear_0.kernel, self.linear_0.bias
            x0_self = self.linear_0.apply_to(edge_feat, cdt)
            parts = [(x0_self, None)]
            if self.training:
                args = (etype, esrc, edst, ntype, emask, n_rel, n_ntype)
                hist, M, n_e = edge_feature_moments(*args) if mesh is None \
                    else edge_feature_moments_sharded(*args, mesh)
                s1, s2 = analytic_edge_moments(w0, b0, hist, M, n_e)
                parts.insert(0, MomentPart(s1, s2, n_e))
            res, (a, b) = self.bn(parts, return_affine=True)
            h_self = torch.relu(res[-1])
            # zero columns up to the kernels' width: h = relu(0 x + 0) = 0
            # there, and the pads' backward drops their gradients
            Dk = kernel_d(w0.shape[1])

            def wide(t):
                return t if t.shape[-1] == Dk \
                    else F.pad(t, (0, Dk - t.shape[-1]))
            args = (etype, esrc, edst, ntype, wide(w0), wide(b0), wide(a),
                    wide(b), n_rel, n_ntype, cdt)
            h_edge = edge_hidden(*args) if mesh is None \
                else edge_hidden_sharded(*args, mesh)
            return (h_edge, h_self), (self.linear_1.kernel,
                                      self.linear_1.bias)

        multi = isinstance(edge_feat, (tuple, list))
        parts = list(edge_feat) if multi else [(edge_feat, weight)]
        hs = self.bn([(self.linear_0.apply_to(f, cdt), w) for f, w in parts])
        outs = [self.linear_1.apply_to(torch.relu(h), cdt) for h in hs]
        return outs if multi else outs[0]


class GATConvE(nn.Module):
    """One relation-aware multi-head edge-attention layer (reference
    modeling/modeling_qagnn.py:380-484), followed by its output MLP
    Linear -> BN -> ReLU -> Linear."""

    def __init__(self, emb_dim: int, head_count: int = 4,
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        assert emb_dim % head_count == 0
        d = emb_dim
        self.emb_dim, self.head_count, self.dtype = d, head_count, dtype
        self.mesh = mesh
        self.query = ProjParams(2 * d, d)
        self.key_x = ProjParams(2 * d, d, use_bias=False)
        self.msg_x = ProjParams(2 * d, d, use_bias=False)
        self.key_e = ProjParams(d, d)
        self.msg_e = ProjParams(d, d)
        self.out_linear_0 = nn.Linear(d, d)
        self.out_bn = MaskedBatchNorm(d, mesh=mesh)
        self.out_linear_1 = nn.Linear(d, d)

    def _node_projections(self, x):
        d, cdt = self.emb_dim, self.dtype
        if isinstance(x, tuple):
            # (X, node_extra) not concatenated: linear-over-concat is the
            # sum of the two halves' products (qagnn_tpu/models/gnn.py:246)
            xb, extra = x
            half = xb.shape[-1]
            wcat = torch.cat([self.query.kernel, self.key_x.kernel,
                              self.msg_x.kernel], dim=1)
            out3 = xb.to(cdt) @ wcat[:half].to(cdt) \
                + extra.to(cdt) @ wcat[half:].to(cdt)
            return (out3[..., :d] + self.query.bias.to(cdt),
                    out3[..., d:2 * d], out3[..., 2 * d:])
        return (self.query.apply_to(x, cdt), self.key_x.apply_to(x, cdt),
                self.msg_x.apply_to(x, cdt))

    def forward(self, x, edge_src, edge_dst, edge_mask, edge_emb, self_emb, *,
                fused: bool, emb_proj=None, return_alpha: bool = False):
        """x: (G, N, 2D) or the pair (X, node_extra); edge_emb: (G, E, D),
        or on the fused path the encoder's (G, E, Dk) at the kernels'
        width; self_emb: (G, N, D). fused: run the GAT kernels, with
        emb_proj = (W1, b1) of the edge encoder's linear_1 when
        edge_emb/self_emb are its PRE-linear_1 hidden states; the result is
        then the pair (out, edge_emb passed through the op, unchanged) and
        the caller hands that embedding to the next layer. With a mesh the
        fused op is the edge-partitioned one, and the pair's embedding is
        edge_emb itself (no chaining)."""
        d, h, cdt = self.emb_dim, self.head_count, self.dtype
        dph = d // h
        G, N = (x[0] if isinstance(x, tuple) else x).shape[:2]
        query_x, key_x, msg_x = self._node_projections(x)

        if fused:
            wke, bke = self.key_e.kernel, self.key_e.bias
            wme, bme = self.msg_e.kernel, self.msg_e.bias
            if emb_proj is not None:
                # edge_emb = h W1 + b1, so key_e(edge_emb) =
                # h (W1 Wke) + (b1 Wke + bke), composed in f32
                w1, b1 = emb_proj
                wke, bke = w1 @ wke, b1 @ wke + bke
                wme, bme = w1 @ wme, b1 @ wme + bme

            def proj(t, w, b):
                return t.to(cdt) @ w.to(cdt) + b.to(cdt)

            args = (query_x / math.sqrt(dph), key_x, msg_x,
                    edge_emb.to(cdt), wke, bke, wme, bme,
                    proj(self_emb, wke, bke), proj(self_emb, wme, bme),
                    edge_src, edge_dst, edge_mask, h)
            if self.mesh is None:
                aggr, emb_next = gat_projected_chained(*args)
            else:
                aggr = gat_projected_sharded(*args, self.mesh)
                emb_next = edge_emb
        else:
            def heads(t):
                return t.reshape(*t.shape[:-1], h, dph)

            aggr = relational_gat_attention_nodes(
                heads(query_x / math.sqrt(dph)), heads(key_x), heads(msg_x),
                heads(self.key_e.apply_to(edge_emb, cdt)),
                heads(self.msg_e.apply_to(edge_emb, cdt)),
                heads(self.key_e.apply_to(self_emb, cdt)),
                heads(self.msg_e.apply_to(self_emb, cdt)),
                edge_src, edge_dst, edge_mask, backend="scatter",
                return_alpha=return_alpha)
            if return_alpha:
                aggr, alphas = aggr

        out = dense(aggr, self.out_linear_0, cdt)
        out = self.out_bn(out.reshape(G * N, d)).reshape(G, N, d)
        out = dense(torch.relu(out), self.out_linear_1, cdt)
        if fused:
            return out, emb_next
        return (out, alphas) if return_alpha else out


class QAGNNMessagePassing(nn.Module):
    """k-layer message passing with node-type/score feature injection
    (reference modeling/modeling_qagnn.py:7-95): node-type embedding,
    sinusoidal score embedding (basis 1.1^j), k GATConvE layers with GELU
    and dropout, residual GELU(Vh(H) + Vx(X)) with dropout."""

    def __init__(self, k: int, n_ntype: int, n_etype: int, hidden_size: int,
                 dropout: float = 0.1, head_count: int = 4,
                 backend: str | None = None,
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        D, half = hidden_size, hidden_size // 2
        self.k, self.n_ntype, self.n_etype = k, n_ntype, n_etype
        self.dropout = dropout
        self.hidden_size, self.backend, self.dtype = D, backend, dtype
        if mesh is not None and backend == "scatter":
            raise ValueError("the scatter backend is single-rank; on a "
                             "grid the GNN runs the fused kernels")
        self.mesh = mesh
        self.emb_node_type = nn.Linear(n_ntype, half)
        self.emb_score = nn.Linear(half, half)
        self.edge_encoder = EdgeEncoder(D, n_etype + 1 + 2 * n_ntype,
                                        num_updates=k, dtype=dtype,
                                        mesh=mesh)
        for i in range(k):
            self.add_module(f"gnn_layer_{i}",
                            GATConvE(D, head_count, dtype=dtype, mesh=mesh))
        self.Vh = nn.Linear(D, D)
        self.Vx = nn.Linear(D, D)

    def forward(self, H, node_type, node_score, edge_src, edge_dst, edge_type,
                edge_mask, *, return_alpha: bool = False):
        """H: (G, N, D) initial node features; node_type (G, N) int;
        node_score (G, N); edges (G, E) with a bool mask (with a mesh: this
        rank's E / n_model slots). Returns (G, N, D) [and ((k, G, E, H)
        edge alphas, (k, G, N, H) self alphas)]."""
        G, N, D = H.shape
        E = edge_src.shape[1]
        half, cdt = D // 2, self.dtype
        n_ntype, n_etype = self.n_ntype, self.n_etype
        ntype = node_type.long()

        type_emb = gelu(dense(F.one_hot(ntype, n_ntype).to(H.dtype),
                              self.emb_node_type, cdt))
        js = torch.pow(1.1, torch.arange(half, dtype=H.dtype,
                                         device=H.device))
        B = torch.sin(js[None, None, :] * node_score[:, :, None])
        score_emb = gelu(dense(B, self.emb_score, cdt))
        node_extra = torch.cat([type_emb, score_emb], dim=-1)

        # self-loop feature rows: relation n_etype, own type on both sides
        s_rel = torch.zeros((G, N, n_etype + 1), dtype=cdt, device=H.device)
        s_rel[..., n_etype] = 1.0
        s_type = F.one_hot(ntype, n_ntype).to(cdt)
        self_feat = torch.cat([s_rel, s_type, s_type], dim=-1)
        nfeat = self_feat.shape[-1]

        if self.mesh is not None and return_alpha:
            raise ValueError("the detail path (return_alpha) is single-rank")
        fused = self.mesh is not None or (
            resolve_backend(self.backend, H) == "cuda" and not return_alpha)
        src = edge_src.to(torch.int32).contiguous()
        dst = edge_dst.to(torch.int32).contiguous()
        mask = edge_mask.to(torch.bool).contiguous()
        emb_proj = None
        if fused:
            (edge_emb, self_emb), emb_proj = self.edge_encoder(
                self_feat.reshape(G * N, nfeat),
                edge_ints=(edge_type.to(torch.int32).contiguous(), src, dst,
                           node_type.to(torch.int32).contiguous(), mask),
                n_rel=n_etype + 1, n_ntype=n_ntype)
        else:
            # jax.nn.one_hot's: an id outside [0, n_etype] is a zero row,
            # as the fused branch's kernels give it no relation feature
            e_rel = (edge_type.long()[..., None] == torch.arange(
                n_etype + 1, device=H.device)).to(cdt)
            e_head = F.one_hot(torch.gather(ntype, 1, src.long()),
                               n_ntype).to(cdt)
            e_tail = F.one_hot(torch.gather(ntype, 1, dst.long()),
                               n_ntype).to(cdt)
            edge_feat = torch.cat([e_rel, e_head, e_tail], dim=-1)
            edge_emb, self_emb = self.edge_encoder(
                [(edge_feat.reshape(G * E, nfeat),
                  mask.reshape(-1).to(H.dtype)),
                 (self_feat.reshape(G * N, nfeat), None)])
            edge_emb = edge_emb.reshape(G, E, D)
        self_emb = self_emb.reshape(G, N, D)

        X = H
        alphas = []
        for i in range(self.k):
            if fused:
                xin = (X, node_extra)
            else:
                dt = torch.promote_types(X.dtype, node_extra.dtype)
                xin = torch.cat([X.to(dt), node_extra.to(dt)], dim=2)
            X = getattr(self, f"gnn_layer_{i}")(
                xin, src, dst, mask, edge_emb, self_emb, fused=fused,
                emb_proj=emb_proj, return_alpha=return_alpha)
            if return_alpha:
                X, layer_alphas = X
                alphas.append(layer_alphas)
            elif fused:
                # the embedding passed through the op: the next layer's
                # backward hands its d_edge_emb to this layer's as the carry
                X, edge_emb = X
            X = dropout(gelu(X), self.dropout, self.training)

        out = gelu(dense(H, self.Vh, cdt) + dense(X, self.Vx, cdt))
        out = dropout(out, self.dropout, self.training)
        if return_alpha:
            return out, (torch.stack([a[0] for a in alphas]),
                         torch.stack([a[1] for a in alphas]))
        return out
