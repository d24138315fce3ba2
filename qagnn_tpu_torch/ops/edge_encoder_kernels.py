"""The shared edge encoder's edge side on a hand-written CUDA kernel.

Counterpart of qagnn_tpu/ops/pallas_edge_encoder.py (forward). The encoder
is Linear(F -> D) -> BatchNorm -> ReLU -> Linear(D -> D) over one-hot feature
rows [onehot(rel) | onehot(type[src]) | onehot(type[dst])], F = n_rel +
2 * n_ntype. On the fused path linear_1 never runs (the GAT kernels compose
it into their edge projections) and `edge_hidden` emits
h = relu(a * (W0^T feat + b0) + b) for every edge slot, (a, b) being the
folded BatchNorm affine. `analytic_edge_moments` gives the closed-form
masked row sums of x0 = feat W0 + b0 that train-mode BatchNorm needs.
"""

from __future__ import annotations

import ctypes

import torch

from qagnn_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"edge_hidden_launch": [_P] * 9 + [_I] * 7 + [_P]}


def edge_hidden_plain(edge_type, src, dst, node_type, w0, b0, a, b, n_rel,
                      n_ntype, out_dtype):
    """(G, E, D) h in out_dtype; the three W0 rows are rounded to out_dtype
    and summed in f32, as the TPU kernel's one-hot contraction does."""
    w0c = w0.to(out_dtype).float()
    head = torch.gather(node_type.long(), 1, src.long())
    tail = torch.gather(node_type.long(), 1, dst.long())
    x0 = w0c[edge_type.long()] + w0c[n_rel + head] \
        + w0c[n_rel + n_ntype + tail] + b0.float()
    return torch.relu(a.float() * x0 + b.float()).to(out_dtype)


def edge_hidden(edge_type, src, dst, node_type, w0, b0, a, b, n_rel, n_ntype,
                out_dtype):
    """h = relu(a * (W0^T feat + b0) + b) for every edge slot, (G, E, D) in
    out_dtype. edge_type/src/dst: (G, E) int32; node_type: (G, N) int32;
    w0: (F, D) f32; b0/a/b: (D,) f32."""
    if not edge_type.is_cuda:
        return edge_hidden_plain(edge_type, src, dst, node_type, w0, b0, a, b,
                                 n_rel, n_ntype, out_dtype)
    G, E = edge_type.shape
    N = node_type.shape[1]
    F, D = w0.shape
    if F != n_rel + 2 * n_ntype:
        raise ValueError(f"w0 has {F} rows, expected {n_rel + 2 * n_ntype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"edge_hidden emits float32 or bfloat16, "
                        f"not {out_dtype}")
    checks = [(edge_type, "edge_type", torch.int32, (G, E)),
              (src, "src", torch.int32, (G, E)),
              (dst, "dst", torch.int32, (G, E)),
              (node_type, "node_type", torch.int32, (G, N)),
              (w0, "w0", torch.float32, (F, D))]
    checks += [(t, n, torch.float32, (D,)) for t, n in
               ((b0, "b0"), (a, "a"), (b, "b"))]
    for t, name, dtype, shape in checks:
        if not t.is_cuda or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: need a contiguous CUDA {dtype} tensor of shape "
                f"{shape}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((G, E, D), device=edge_type.device, dtype=out_dtype)
    err = _build.load("edge_hidden", _SIGNATURES).edge_hidden_launch(
        edge_type.data_ptr(), src.data_ptr(), dst.data_ptr(),
        node_type.data_ptr(), w0.data_ptr(), b0.data_ptr(), a.data_ptr(),
        b.data_ptr(), out.data_ptr(), G, E, N, D, n_rel, n_ntype,
        1 if out_dtype == torch.bfloat16 else 0,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "edge_hidden")
    _build.count_launch("edge_hidden")
    return out


def analytic_edge_moments(w0, b0, hist, M, n):
    """Closed-form masked-row sums of x0 = feat W0 + b0 and of x0^2:

        s1[d] = hist . W0[:, d] + n * b0[d]
        s2[d] = W0[:, d]^T M W0[:, d] + 2 b0[d] (hist . W0[:, d]) + n b0[d]^2

    hist (F,), M (F, F) and n are the masked feature histogram, second
    moment and row count.
    """
    w0 = w0.float()
    b0 = b0.float()
    hw = hist @ w0
    s1 = hw + n * b0
    quad = torch.sum(w0 * (M @ w0), dim=0)
    s2 = quad + 2.0 * b0 * hw + n * b0 * b0
    return s1, s2
