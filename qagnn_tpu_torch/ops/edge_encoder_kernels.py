"""The shared edge encoder's edge side on hand-written CUDA kernels.

Counterpart of qagnn_tpu/ops/pallas_edge_encoder.py. The encoder is
Linear(F -> D) -> BatchNorm -> ReLU -> Linear(D -> D) over one-hot feature
rows [onehot(rel) | onehot(type[src]) | onehot(type[dst])], F = n_rel +
2 * n_ntype. On the fused path linear_1 never runs (the GAT kernels compose
it into their edge projections) and

  * `edge_feature_moments` (csrc/edge_moments.cu) counts the masked slots'
    feature histogram, second moment and rows: data only, no gradient; one
    launch counts the (relation, head type, tail type) triples and expands
    them;
  * `analytic_edge_moments` turns them into the closed-form masked row sums
    of x0 = feat W0 + b0 that train-mode BatchNorm needs, in plain torch ops
    so that autograd carries the gradient through mean and variance;
  * `edge_hidden` (csrc/edge_hidden.cu) emits
    h = relu(a * (W0^T feat + b0) + b) for every edge slot, (a, b) being the
    folded BatchNorm affine, and is differentiable in W0, b0, a, b: its
    backward is the second kernel of csrc/edge_hidden.cu.

`edge_hidden` and its backward have two routes behind one entry point each
(`_hidden_route`). Route 1, bfloat16 at the widths every preset has
(csrc/edge_hidden_tc.cuh): persistent blocks hold W0 and a table of the
type rows' sums in shared memory; the backward streams dh through them and
forms dW0 as a one-hot product on tensor cores. Route 0, float32 and other
widths: the CUDA-core kernels of csrc/edge_hidden.cu.

Every kernel has a plain torch version here with the same arithmetic. A
wrapper takes the plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from qagnn_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"edge_hidden_launch": [_P] * 9 + [_I] * 8 + [_P],
               "edge_hidden_bwd_launch": [_P] * 12 + [_I] * 10 + [_P]}
_MOMENTS_SIGNATURES = {"edge_moments_launch": [_P] * 7 + [_I] * 5 + [_P]}
# the dynamic shared memory a block of csrc/edge_moments.cu may opt into
# (less room for its static flag)
MOMENTS_MAX_SMEM = 227 * 1024 - 64
BWD_BLOCKS = 512     # blocks (and rows of partials) of the hidden backward
# what route 1 takes (csrc/edge_hidden_tc.cuh: EH_MAX_D, EH_MAX_F, EH_MAX_U)
# and the slots of its tiles (EH_TILE)
TC_MAX_D, TC_MAX_F, TC_MAX_U = 256, 64, 8192
TC_TILE = 16


_require = _build.require


def _feature_rows(edge_type, src, dst, node_type, n_rel, n_ntype):
    """The three W0 rows (G, E) int64 that an edge slot's feature row sets."""
    head = torch.gather(node_type.long(), 1, src.long())
    tail = torch.gather(node_type.long(), 1, dst.long())
    return edge_type.long(), n_rel + head, n_rel + n_ntype + tail


# --------------------------------------------------------------------------
# feature moments of the masked slots
# --------------------------------------------------------------------------

def edge_feature_moments_plain(edge_type, src, dst, node_type, mask, n_rel,
                               n_ntype):
    F = n_rel + 2 * n_ntype
    m = mask.reshape(-1).bool()
    feats = torch.stack([r.reshape(-1)[m] for r in _feature_rows(
        edge_type, src, dst, node_type, n_rel, n_ntype)], dim=1)   # (n, 3)
    hist = torch.bincount(feats.reshape(-1), minlength=F)
    pairs = feats[:, :, None] * F + feats[:, None, :]
    M = torch.bincount(pairs.reshape(-1), minlength=F * F).reshape(F, F)
    return hist.float(), M.float(), m.sum().float()


def _moments_smem(n_rel, n_ntype):
    """Shared memory of the moments kernel's block: the T = n_rel *
    n_ntype^2 triple counts and the last block's tables (relation x type
    twice, type x type), int32."""
    return 4 * (n_rel * n_ntype ** 2 + 2 * n_rel * n_ntype + n_ntype ** 2)


_TABLES: dict = {}


def _moments_table(device, stream, T):
    """The moments kernel's ticket and table of T triple counts for
    launches on this device and stream: 1 + T int32, allocated zeroed once;
    the kernel leaves them at 0 after every launch. Launches on one stream
    run one after another, so no two use a table at once."""
    key = (torch.device(device).index, stream, T)
    if key not in _TABLES:
        _TABLES[key] = torch.zeros(1 + T, device=device, dtype=torch.int32)
    return _TABLES[key]


def edge_feature_moments(edge_type, src, dst, node_type, mask, n_rel,
                         n_ntype):
    """Masked feature histogram (F,), second moment feat^T feat (F, F) and
    row count () over all graphs' edge slots, f32 (exact integer counts).
    edge_type/src/dst: (G, E) int32; node_type: (G, N) int32; mask: (G, E)
    bool. No gradient flows through these. On CUDA tensors: one launch
    (csrc/edge_moments.cu), which writes the three outputs whole."""
    if not edge_type.is_cuda:
        return edge_feature_moments_plain(edge_type, src, dst, node_type,
                                          mask, n_rel, n_ntype)
    G, E = edge_type.shape
    N = node_type.shape[1]
    F = n_rel + 2 * n_ntype
    for t, name in ((edge_type, "edge_type"), (src, "src"), (dst, "dst")):
        _require(t, name, torch.int32, (G, E))
    _require(node_type, "node_type", torch.int32, (G, N))
    _require(mask, "mask", torch.bool, (G, E))
    if _moments_smem(n_rel, n_ntype) > MOMENTS_MAX_SMEM:
        raise ValueError(f"the moments kernel counts n_rel * n_ntype^2 "
                         f"triples in shared memory; n_rel={n_rel}, "
                         f"n_ntype={n_ntype} do not fit")
    dev = edge_type.device
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(F + F * F + 1, device=dev, dtype=torch.float32)
    err = _build.load("edge_moments", _MOMENTS_SIGNATURES).edge_moments_launch(
        edge_type.data_ptr(), src.data_ptr(), dst.data_ptr(),
        node_type.data_ptr(), mask.data_ptr(),
        _moments_table(dev, stream, n_rel * n_ntype ** 2).data_ptr(),
        out.data_ptr(), G, E, N, n_rel, n_ntype, stream)
    _build.check(err, "edge_moments")
    _build.count_launch("edge_moments")
    return out[:F], out[F:F + F * F].reshape(F, F), out[-1]


# --------------------------------------------------------------------------
# the hidden pass and its backward
# --------------------------------------------------------------------------

def _hidden_route(dtype, D, n_rel, n_ntype, route=None):
    """Route of `edge_hidden` and its backward: 1 (csrc/edge_hidden_tc.cuh)
    for bfloat16 at D % 8 == 0, D <= 256, F = n_rel + 2 n_ntype <= 64 and
    n_ntype^2 * D <= 8192 (the type table in shared memory); else 0, the
    CUDA-core kernels. Dtype and widths alone decide; `route` names one, 0 for
    bfloat16 to time the CUDA-core kernels beside route 1."""
    fits = dtype == torch.bfloat16 and D % 8 == 0 and 0 < D <= TC_MAX_D \
        and n_rel + 2 * n_ntype <= TC_MAX_F and n_ntype ** 2 * D <= TC_MAX_U
    if route is None:
        return 1 if fits else 0
    if route not in (0, 1) or (route == 1 and not fits):
        raise ValueError(f"no route {route} of the edge_hidden kernels for "
                         f"{dtype}, D={D}, n_rel={n_rel}, n_ntype={n_ntype}")
    return route


def _bwd_rows_scratch(route, n_edges):
    """int32 scratch of the backward's route 1: every slot's packed feature
    rows and 64-bit one-hot mask, 3 int32 a slot, over whole tiles."""
    return 3 * -(-n_edges // TC_TILE) * TC_TILE if route == 1 else 0


def _bwd_blocks(route, n_edges, n_sm):
    """Blocks of the backward kernel, each of which writes one (F + 3, D)
    row of partial sums: on route 0 up to BWD_BLOCKS blocks of at least 64
    slots; on route 1 one persistent block an SM at most, with a tile of
    16 slots at least."""
    if route == 1:
        return max(1, min(n_sm, -(-n_edges // TC_TILE)))
    return max(1, min(BWD_BLOCKS, -(-n_edges // 64)))


def _check_aligned(route, *ts):
    """Route 1 reads and writes rows in 16-byte pieces."""
    if route == 1 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError("route 1 of the edge_hidden kernels needs 16-byte "
                         "aligned w0, b0, a, b and h / dh")


def _x0(rows, w0, b0, out_dtype):
    """W0^T feat + b0 (G, E, D) f32: the three W0 rows are rounded to
    out_dtype and summed in f32, as the TPU kernel's one-hot contraction
    does."""
    w0c = w0.to(out_dtype).float()
    return w0c[rows[0]] + w0c[rows[1]] + w0c[rows[2]] + b0.float()


def edge_hidden_plain(edge_type, src, dst, node_type, w0, b0, a, b, n_rel,
                      n_ntype, out_dtype):
    rows = _feature_rows(edge_type, src, dst, node_type, n_rel, n_ntype)
    x0 = _x0(rows, w0, b0, out_dtype)
    return torch.relu(a.float() * x0 + b.float()).to(out_dtype)


def edge_hidden_backward_plain(edge_type, src, dst, node_type, w0, b0, a, b,
                               dh, n_rel, n_ntype):
    """(dW0 (F, D), db0, da, db (D,)) f32 from dh (G, E, D), summed over
    every slot; d_x0 is rounded to dh's dtype before it is scattered into
    dW0, while the three vector sums take the f32 values."""
    rows = _feature_rows(edge_type, src, dst, node_type, n_rel, n_ntype)
    x0 = _x0(rows, w0, b0, dh.dtype)
    D = w0.shape[1]
    d_pre = torch.where(a.float() * x0 + b.float() > 0, dh.float(), 0.0)
    d_x0 = d_pre * a.float()
    dxc = d_x0.to(dh.dtype).float().reshape(-1, D)
    dw0 = torch.zeros_like(w0, dtype=torch.float32)
    for r in rows:
        dw0.index_add_(0, r.reshape(-1), dxc)
    return (dw0, d_x0.sum((0, 1)), (d_pre * x0).sum((0, 1)),
            d_pre.sum((0, 1)))


def edge_hidden_forward(edge_type, src, dst, node_type, w0, b0, a, b, n_rel,
                        n_ntype, out_dtype, _route=None):
    """`edge_hidden` without the autograd graph. `_route` names a route
    (`_hidden_route`) to time it beside the other."""
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
    for t, name in ((edge_type, "edge_type"), (src, "src"), (dst, "dst")):
        _require(t, name, torch.int32, (G, E))
    _require(node_type, "node_type", torch.int32, (G, N))
    _require(w0, "w0", torch.float32, (F, D))
    for t, name in ((b0, "b0"), (a, "a"), (b, "b")):
        _require(t, name, torch.float32, (D,))
    route = _hidden_route(out_dtype, D, n_rel, n_ntype, _route)
    out = torch.empty((G, E, D), device=edge_type.device, dtype=out_dtype)
    _check_aligned(route, w0, b0, a, b, out)
    err = _build.load("edge_hidden", _SIGNATURES).edge_hidden_launch(
        edge_type.data_ptr(), src.data_ptr(), dst.data_ptr(),
        node_type.data_ptr(), w0.data_ptr(), b0.data_ptr(), a.data_ptr(),
        b.data_ptr(), out.data_ptr(), G, E, N, D, n_rel, n_ntype,
        1 if out_dtype == torch.bfloat16 else 0, route,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "edge_hidden")
    _build.count_launch("edge_hidden", route)
    return out


def edge_hidden_backward(edge_type, src, dst, node_type, w0, b0, a, b, dh,
                         n_rel, n_ntype, _route=None):
    """Gradients of `edge_hidden` in (w0, b0, a, b), f32, from the output
    cotangent dh (G, E, D) in the forward's output dtype. `_route` as in
    `edge_hidden_forward`."""
    if not dh.is_cuda:
        return edge_hidden_backward_plain(edge_type, src, dst, node_type, w0,
                                          b0, a, b, dh, n_rel, n_ntype)
    G, E = edge_type.shape
    N = node_type.shape[1]
    F, D = w0.shape
    if F != n_rel + 2 * n_ntype:
        raise ValueError(f"w0 has {F} rows, expected {n_rel + 2 * n_ntype}")
    if dh.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"edge_hidden takes a float32 or bfloat16 cotangent, "
                        f"not {dh.dtype}")
    route = _hidden_route(dh.dtype, D, n_rel, n_ntype, _route)
    if route == 0 and (D > 1024 or F * D * 4 > 200 * 1024):
        raise ValueError(f"the edge_hidden backward kernel takes D <= 1024 "
                         f"and F * D <= 51200; got F={F}, D={D}")
    for t, name in ((edge_type, "edge_type"), (src, "src"), (dst, "dst")):
        _require(t, name, torch.int32, (G, E))
    _require(node_type, "node_type", torch.int32, (G, N))
    _require(w0, "w0", torch.float32, (F, D))
    for t, name in ((b0, "b0"), (a, "a"), (b, "b")):
        _require(t, name, torch.float32, (D,))
    _require(dh, "dh", dh.dtype, (G, E, D))
    _check_aligned(route, w0, b0, a, b, dh)
    n_blocks = _bwd_blocks(route, G * E, torch.cuda.get_device_properties(
        dh.device).multi_processor_count)
    part = torch.empty((n_blocks, F + 3, D), device=dh.device,
                       dtype=torch.float32)
    rows = torch.empty(_bwd_rows_scratch(route, G * E), device=dh.device,
                       dtype=torch.int32)
    out = torch.empty((F + 3, D), device=dh.device, dtype=torch.float32)
    err = _build.load("edge_hidden", _SIGNATURES).edge_hidden_bwd_launch(
        edge_type.data_ptr(), src.data_ptr(), dst.data_ptr(),
        node_type.data_ptr(), w0.data_ptr(), b0.data_ptr(), a.data_ptr(),
        b.data_ptr(), dh.data_ptr(), part.data_ptr(),
        rows.data_ptr() if route == 1 else None, out.data_ptr(), G, E,
        N, D, F, n_rel, n_ntype, n_blocks,
        1 if dh.dtype == torch.bfloat16 else 0, route,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "edge_hidden_bwd")
    _build.count_launch("edge_hidden_bwd", route)
    return out[:F], out[F], out[F + 1], out[F + 2]


class _EdgeHidden(torch.autograd.Function):
    @staticmethod
    def forward(ctx, edge_type, src, dst, node_type, w0, b0, a, b, n_rel,
                n_ntype, out_dtype):
        ctx.save_for_backward(edge_type, src, dst, node_type, w0, b0, a, b)
        ctx.consts = (n_rel, n_ntype, out_dtype)
        return edge_hidden_forward(edge_type, src, dst, node_type, w0, b0, a,
                                   b, n_rel, n_ntype, out_dtype)

    @staticmethod
    def backward(ctx, dh):
        n_rel, n_ntype, out_dtype = ctx.consts
        dw0, db0, da, db = edge_hidden_backward(
            *ctx.saved_tensors, dh.to(out_dtype).contiguous(), n_rel,
            n_ntype)
        return (None,) * 4 + (dw0, db0, da, db) + (None,) * 3


def edge_hidden(edge_type, src, dst, node_type, w0, b0, a, b, n_rel, n_ntype,
                out_dtype):
    """h = relu(a * (W0^T feat + b0) + b) for every edge slot, (G, E, D) in
    out_dtype, differentiable in w0, b0, a, b. edge_type/src/dst: (G, E)
    int32; node_type: (G, N) int32; w0: (F, D) f32; b0/a/b: (D,) f32."""
    return _EdgeHidden.apply(edge_type, src, dst, node_type, w0, b0, a, b,
                             n_rel, n_ntype, out_dtype)


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
