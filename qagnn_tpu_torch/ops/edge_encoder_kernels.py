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
(`_hidden_route`). Route 1, bfloat16 and float32 at every width with F <= 64
(csrc/edge_hidden_tc.cuh): persistent blocks hold W0 and a table of the
type rows' sums in shared memory; the backward streams dh through them and
forms dW0 as a one-hot product on tensor cores (bf16, or tf32 with d_x0
split in two). Route 0, F > 64 and named to be timed beside route 1: the
CUDA-core kernels of csrc/edge_hidden.cu. Every quantity of both passes is
per column, so each route runs D's columns as slices whose width the wrapper
plans (`fwd_slices`, `bwd_slices`), all in one call that reads and writes
every slice's columns in place at the rows' stride D: route 0 a launch a
slice (at most 1024 column vectors forward, 1024 columns and an F x width
f32 dW0 in 200 KiB backward), route 1 one launch over all slices (the
forward's tables in half an SM's shared memory, the backward's 256 columns
of 16 warps and their rings in all of it).

Every kernel has a plain torch version here with the same arithmetic. A
wrapper takes the plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from qagnn_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"edge_hidden_launch": [_P] * 9 + [_I] * 9 + [_P],
               "edge_hidden_bwd_launch": [_P] * 12 + [_I] * 11 + [_P]}
_MOMENTS_SIGNATURES = {"edge_moments_launch": [_P] * 7 + [_I] * 5 + [_P]}
# the dynamic shared memory a block of csrc/edge_moments.cu may opt into
# (less room for its static flag)
MOMENTS_MAX_SMEM = 227 * 1024 - 64
BWD_BLOCKS = 512     # blocks (and rows of partials) of the hidden backward
# route 0 of the hidden backward: a thread a column and the F x D f32 dW0 in
# a block's shared memory (csrc/edge_hidden.cu launch_bwd)
BWD_MAX_THREADS, BWD_MAX_SMEM = 1024, 200 * 1024
# what route 1 takes and how it is laid out (csrc/edge_hidden_tc.cuh: EH_MAX_F
# rows of W0, EH_TILE slots a tile; shared memory of a block EH_SMEM, of the
# forward's tables EH_FWD_SMEM; EH_BWD_COLS columns of a backward slice; the
# backward ring's stages and cell bytes and the d_x0 tile's pitch, Ehb<T>)
TC_MAX_F, TC_TILE = 64, 16
TC_SMEM = 232448
TC_FWD_SMEM = TC_SMEM // 2
TC_BWD_COLS = 256
TC_RING = {torch.bfloat16: (8, 32, 24), torch.float32: (4, 48, 24)}


_require = _build.require


def _feature_rows(edge_type, src, dst, node_type, n_rel, n_ntype):
    """The three W0 rows (G, E) int64 that an edge slot's feature row sets.
    A relation id outside [0, n_rel) matches no relation column of the JAX
    package's one-hot (`_feat_onehot`, jax.nn.one_hot): its relation row is
    F = n_rel + 2 n_ntype, one past W0, which the plain versions read as a
    zero row and whose counts they drop; its type rows count as usual."""
    head = torch.gather(node_type.long(), 1, src.long())
    tail = torch.gather(node_type.long(), 1, dst.long())
    rel = edge_type.long()
    rel = torch.where((rel >= 0) & (rel < n_rel), rel, n_rel + 2 * n_ntype)
    return rel, n_rel + head, n_rel + n_ntype + tail


# --------------------------------------------------------------------------
# feature moments of the masked slots
# --------------------------------------------------------------------------

def edge_feature_moments_plain(edge_type, src, dst, node_type, mask, n_rel,
                               n_ntype):
    F = n_rel + 2 * n_ntype
    m = mask.reshape(-1).bool()
    feats = torch.stack([r.reshape(-1)[m] for r in _feature_rows(
        edge_type, src, dst, node_type, n_rel, n_ntype)], dim=1)   # (n, 3)
    # row F (no relation) counted, then dropped
    hist = torch.bincount(feats.reshape(-1), minlength=F + 1)[:F]
    pairs = feats[:, :, None] * (F + 1) + feats[:, None, :]
    M = torch.bincount(pairs.reshape(-1), minlength=(F + 1) ** 2) \
        .reshape(F + 1, F + 1)[:F, :F]
    return hist.float(), M.float(), m.sum().float()


def _triples(n_rel, n_ntype):
    """The moments kernel's triple counts: (relation, head type, tail type)
    for the n_rel relations and one bucket of slots with no relation (an id
    outside [0, n_rel)), n_ntype^2 each."""
    return (n_rel + 1) * n_ntype ** 2


def _moments_smem(n_rel, n_ntype):
    """Shared memory of the moments kernel's block: the `_triples` counts
    and the last block's tables (relation x type twice, for the n_rel
    relations only; type x type), int32."""
    return 4 * (_triples(n_rel, n_ntype) + 2 * n_rel * n_ntype + n_ntype ** 2)


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
        raise ValueError(f"the moments kernel counts (n_rel + 1) * n_ntype^2 "
                         f"triples in shared memory; n_rel={n_rel}, "
                         f"n_ntype={n_ntype} do not fit")
    dev = edge_type.device
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(F + F * F + 1, device=dev, dtype=torch.float32)
    err = _build.load("edge_moments", _MOMENTS_SIGNATURES).edge_moments_launch(
        edge_type.data_ptr(), src.data_ptr(), dst.data_ptr(),
        node_type.data_ptr(), mask.data_ptr(),
        _moments_table(dev, stream, _triples(n_rel, n_ntype)).data_ptr(),
        out.data_ptr(), G, E, N, n_rel, n_ntype, stream)
    _build.check(err, "edge_moments")
    _build.count_launch("edge_moments")
    return out[:F], out[F:F + F * F].reshape(F, F), out[-1]


# --------------------------------------------------------------------------
# the hidden pass and its backward
# --------------------------------------------------------------------------

def _round(x: int, m: int) -> int:
    return -(-x // m) * m


def _tc_tables_bytes(F, width, n_ntype, dtype) -> int:
    """Shared memory of route 1's tables for a slice of `width` columns,
    padded to 8: W0 in the compute dtype with a zero row after it (in
    16-byte units), then the n_ntype^2 rows of U in f32."""
    wp = _round(width, 8)
    size = 2 if dtype == torch.bfloat16 else 4
    return _round((F + 1) * wp * size, 16) + n_ntype ** 2 * wp * 4


def _tc_bwd_smem(F, width, n_ntype, dtype) -> int:
    """Shared memory of route 1's backward block for a slice of `width`
    columns: the tables, then for each of its 16-column warps a ring of
    stages x 32 cells and a 16-slot tile of d_x0."""
    stages, cell, pitch = TC_RING[dtype]
    size = 2 if dtype == torch.bfloat16 else 4
    warp = stages * 32 * cell + TC_TILE * pitch * size
    return _tc_tables_bytes(F, width, n_ntype, dtype) \
        + -(-width // 16) * warp


def _spans(D: int, width: int) -> list[tuple[int, int]]:
    return [(c, min(c + width, D)) for c in range(0, D, width)]


def _fewest_slices(D, unit, first, fits):
    """The slices of the fewest, from `first` on, whose width (all of D for
    one slice, else ceil(D / n) rounded up to `unit`) `fits`."""
    for n in range(first, D + 1):
        width = D if n == 1 else _round(-(-D // n), unit)
        if fits(width):
            return _spans(D, width)
    raise ValueError(f"no slice of D={D} fits")


def tc_fwd_slices(D, F, n_ntype, dtype) -> list[tuple[int, int]]:
    """[(c0, c1)] of route 1's forward over D columns: all of D where W0
    and U at D fit in half an SM's shared memory (two blocks of 8 warps an
    SM), else the fewest slices of a multiple of 8 columns that do; the
    kernel's warps walk a row of a slice 512 bytes (256 columns in bf16,
    128 in f32) at a time."""
    return _fewest_slices(D, 8, 1, lambda w: _tc_tables_bytes(
        F, w, n_ntype, dtype) <= TC_FWD_SMEM)


def tc_bwd_slices(D, F, n_ntype, dtype) -> list[tuple[int, int]]:
    """[(c0, c1)] of route 1's backward over D columns: the fewest slices
    of at most 256 columns (a warp each 16), a multiple of 16 where there
    are several, whose block fits in an SM's shared memory."""
    return _fewest_slices(D, 16, -(-D // TC_BWD_COLS), lambda w: w
                          <= TC_BWD_COLS and _tc_bwd_smem(
                              F, w, n_ntype, dtype) <= TC_SMEM)


def _hidden_route(dtype, D, n_rel, n_ntype, route=None):
    """Route of `edge_hidden` and its backward: 1 (csrc/edge_hidden_tc.cuh)
    for bfloat16 and float32 at every D >= 1 where F = n_rel + 2 n_ntype <=
    64 (a slot's one-hot row is a 64-bit mask; every F <= 64 leaves room
    for a slice's tables); else 0, the CUDA-core kernels. Dtype and widths
    alone decide; `route` names one, 0 to time the CUDA-core kernels beside
    route 1."""
    fits = dtype in (torch.bfloat16, torch.float32) and D >= 1 \
        and n_rel + 2 * n_ntype <= TC_MAX_F
    if route is None:
        return 1 if fits else 0
    if route not in (0, 1) or (route == 1 and not fits):
        raise ValueError(f"no route {route} of the edge_hidden kernels for "
                         f"{dtype}, D={D}, n_rel={n_rel}, n_ntype={n_ntype}")
    return route


def fwd_slices(route, D, F, n_ntype, dtype) -> list[tuple[int, int]]:
    """The column slices of a forward call on `route`."""
    return tc_fwd_slices(D, F, n_ntype, dtype) if route == 1 \
        else fwd_col_slices(D, dtype)


def bwd_slices(route, D, F, n_ntype, dtype) -> list[tuple[int, int]]:
    """The column slices of a backward call on `route`."""
    return tc_bwd_slices(D, F, n_ntype, dtype) if route == 1 \
        else bwd_col_slices(F, D)


def _bwd_rows_scratch(route, n_edges):
    """int32 scratch of the backward's route 1: every slot's packed feature
    rows and 64-bit one-hot mask, 3 int32 a slot, over whole tiles, packed
    once for all the call's column slices."""
    return 3 * -(-n_edges // TC_TILE) * TC_TILE if route == 1 else 0


def _bwd_blocks(route, n_edges, n_sm, n_slices=1):
    """Blocks of the backward kernel, each of which writes one (F + 3, D)
    row of partial sums (each slice its columns): on route 0 up to
    BWD_BLOCKS blocks of at least 64 slots; on route 1 persistent blocks,
    one an SM at most over all `n_slices` slices (one wave), with a tile of
    16 slots at least."""
    if route == 1:
        return max(1, min(n_sm // n_slices, -(-n_edges // TC_TILE)))
    return max(1, min(BWD_BLOCKS, -(-n_edges // 64)))


class BwdPlan(NamedTuple):
    """What one backward call launches: its column slices (the kernel reads
    each slice's columns of dh in place, at dh's row stride D), its blocks
    (a row of partial sums each), the int32 scratch of route 1's packed rows
    (one pass of edge_rows_kernel for all the slices) and the partial sums'
    shape."""
    slices: list
    n_blocks: int
    rows: int
    part: tuple


def bwd_plan(route, n_edges, D, F, n_ntype, dtype, n_sm) -> BwdPlan:
    slices = bwd_slices(route, D, F, n_ntype, dtype)
    n_blocks = _bwd_blocks(route, n_edges, n_sm, len(slices))
    return BwdPlan(slices, n_blocks, _bwd_rows_scratch(route, n_edges),
                   (n_blocks, F + 3, D))


def _check_aligned(route, *ts):
    """Route 1 reads and writes rows in 16-byte pieces."""
    if route == 1 and any(t.data_ptr() % 16 for t in ts):
        raise ValueError("route 1 of the edge_hidden kernels needs 16-byte "
                         "aligned w0, b0, a, b and h / dh")


def _x0(rows, w0, b0, out_dtype):
    """W0^T feat + b0 (G, E, D) f32: the three W0 rows are rounded to
    out_dtype and summed in f32, as the TPU kernel's one-hot contraction
    does; relation row F (no relation) is a zero row."""
    w0c = w0.to(out_dtype).float()
    w0c = torch.cat([w0c, w0c.new_zeros((1, w0c.shape[1]))])
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
    dw0 = w0.new_zeros((w0.shape[0] + 1, D), dtype=torch.float32)
    for r in rows:
        dw0.index_add_(0, r.reshape(-1), dxc)
    return (dw0[:-1], d_x0.sum((0, 1)), (d_pre * x0).sum((0, 1)),
            d_pre.sum((0, 1)))


def fwd_col_slices(D: int, dtype) -> list[tuple[int, int]]:
    """[(c0, c1)] of route 0's forward launches over D columns: every output
    column is its own, and a block's row of threads takes a vector of 8
    columns in bf16, 4 in f32 (1 where D is not a multiple of it), at most
    1024 vectors; one launch where D fits, else the fewest slices, all but
    the last of the widest width that fits."""
    vec = 8 if dtype == torch.bfloat16 else 4
    return _spans(D, 1024 * (vec if D % vec == 0 else 1))


def edge_hidden_forward(edge_type, src, dst, node_type, w0, b0, a, b, n_rel,
                        n_ntype, out_dtype, _route=None):
    """`edge_hidden` without the autograd graph: one call over D's column
    slices (`fwd_slices`). `_route` names a route (`_hidden_route`) to time
    it beside the other."""
    F, D = w0.shape
    route = _hidden_route(out_dtype, D, n_rel, n_ntype, _route)
    if not edge_type.is_cuda:
        return edge_hidden_plain(edge_type, src, dst, node_type, w0, b0, a, b,
                                 n_rel, n_ntype, out_dtype)
    G, E = edge_type.shape
    N = node_type.shape[1]
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
    out = torch.empty((G, E, D), device=edge_type.device, dtype=out_dtype)
    _check_aligned(route, w0, b0, a, b, out)
    (c0, c1), *_ = fwd_slices(route, D, F, n_ntype, out_dtype)
    err = _build.load("edge_hidden", _SIGNATURES).edge_hidden_launch(
        edge_type.data_ptr(), src.data_ptr(), dst.data_ptr(),
        node_type.data_ptr(), w0.data_ptr(), b0.data_ptr(), a.data_ptr(),
        b.data_ptr(), out.data_ptr(), G, E, N, D, n_rel, n_ntype,
        1 if out_dtype == torch.bfloat16 else 0, route, c1 - c0,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "edge_hidden")
    _build.count_launch("edge_hidden", route)
    return out


def bwd_col_slices(F: int, D: int) -> list[tuple[int, int]]:
    """[(c0, c1)] of route 0's backward launches over D columns: every
    quantity of the backward is per column, and a launch takes at most 1024
    columns and F x width f32 of dW0 in 200 KiB of shared memory; one launch
    where D fits, else the fewest slices, all but the last of the widest
    width, a multiple of 8, that fits."""
    width = min(BWD_MAX_THREADS, BWD_MAX_SMEM // (4 * F))
    if D <= width:
        return [(0, D)]
    width -= width % 8
    if width == 0:
        raise ValueError(f"the edge_hidden backward kernel takes F <= "
                         f"{BWD_MAX_SMEM // 32} rows of W0; got F={F}")
    return _spans(D, width)


def edge_hidden_backward(edge_type, src, dst, node_type, w0, b0, a, b, dh,
                         n_rel, n_ntype, _route=None):
    """Gradients of `edge_hidden` in (w0, b0, a, b), f32, from the output
    cotangent dh (G, E, D) in the forward's output dtype: one call over D's
    column slices (`bwd_slices`), each reading its columns of dh in place.
    `_route` as in `edge_hidden_forward`."""
    F, D = w0.shape
    route = _hidden_route(dh.dtype, D, n_rel, n_ntype, _route)
    if not dh.is_cuda:
        return edge_hidden_backward_plain(edge_type, src, dst, node_type, w0,
                                          b0, a, b, dh, n_rel, n_ntype)
    G, E = edge_type.shape
    N = node_type.shape[1]
    if F != n_rel + 2 * n_ntype:
        raise ValueError(f"w0 has {F} rows, expected {n_rel + 2 * n_ntype}")
    if dh.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"edge_hidden takes a float32 or bfloat16 cotangent, "
                        f"not {dh.dtype}")
    for t, name in ((edge_type, "edge_type"), (src, "src"), (dst, "dst")):
        _require(t, name, torch.int32, (G, E))
    _require(node_type, "node_type", torch.int32, (G, N))
    _require(w0, "w0", torch.float32, (F, D))
    for t, name in ((b0, "b0"), (a, "a"), (b, "b")):
        _require(t, name, torch.float32, (D,))
    _require(dh, "dh", dh.dtype, (G, E, D))
    _check_aligned(route, w0, b0, a, b, dh)
    plan = bwd_plan(route, G * E, D, F, n_ntype, dh.dtype,
                    torch.cuda.get_device_properties(
                        dh.device).multi_processor_count)
    part = torch.empty(plan.part, device=dh.device, dtype=torch.float32)
    rows = torch.empty(plan.rows, device=dh.device, dtype=torch.int32)
    out = torch.empty((F + 3, D), device=dh.device, dtype=torch.float32)
    err = _build.load("edge_hidden", _SIGNATURES).edge_hidden_bwd_launch(
        edge_type.data_ptr(), src.data_ptr(), dst.data_ptr(),
        node_type.data_ptr(), w0.data_ptr(), b0.data_ptr(), a.data_ptr(),
        b.data_ptr(), dh.data_ptr(), part.data_ptr(),
        rows.data_ptr() if route == 1 else None, out.data_ptr(), G, E,
        N, D, F, n_rel, n_ntype, plan.n_blocks,
        1 if dh.dtype == torch.bfloat16 else 0, route,
        plan.slices[0][1] - plan.slices[0][0],
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
