// Backward of the projected relational GAT op: pass 1 and pass 2.
//
// Replaces the TPU kernels
//   `_bwd1_proj_kernel` (qagnn_tpu/ops/pallas_gat.py:765, via
//   `_proj_bwd_pass1` :1095) -> gat_bwd_pass1
//   `_bwd2_proj_kernel` (qagnn_tpu/ops/pallas_gat.py:849, via
//   `_proj_bwd_pass2` :1156) -> gat_bwd_pass2
//
// With e = exp(min(s - gmax, 0)) over masked edges, recomputed from the
// forward's scores, and alpha = e * scale[src]:
//
// Pass 1 (message side), g being the output cotangent rounded to the compute
//   dtype: msg = nm[src] + emb W_me + b_me; d_msg = alpha * g[dst];
//   d_alpha = <msg, g[dst]> per head; dnm[src] += d_msg;
//   dscale[src] += d_alpha * e; demb = d_msg W_me^T (+ carry);
//   dW_me = emb^T d_msg; db_me = sum d_msg. A head wider than 256 features
//   runs as column slices, one launch each (`part`, gat_common.cuh): each
//   slice adds its f32 d_alpha to the slices' before it, only the last adds
//   the whole d_alpha * e into dscale (rounded once, as on the TPU).
//   A pass of more than one launch (head groups, column slices) makes no
//   demb product in its launches (demb null): each writes its d_msg rows
//   into its columns of one (G, E, HD) array (rows ld_cot apart), and one
//   more launch forms demb = d_msg W_me^T + carry over all HD columns in
//   f32 and rounds it once, as the TPU's one launch over all columns does
//   (ROADMAP C17; each launch's bf16 demb had been the next one's carry,
//   one rounding a launch): route 1 gat_demb.cu `gat_demb_tc` (wgmma fed
//   by TMA), route 0 gat_bwd_demb below.
// Pass 2 (score side): d_s = (d_alpha * scale[src] + d_denom[src]) * e;
//   dekb = d_s * nq[src]; dnq[src] += d_s * (nk[dst] + emb W_ke + b_ke);
//   dnk[dst] += dekb; demb += dekb W_ke^T; dW_ke = emb^T dekb;
//   db_ke = sum dekb. Of several launches, likewise: the demb launch adds
//   dekb W_ke^T over all columns into pass 1's demb in place.
// d_msg, dekb and the dnq term are rounded to the compute dtype before the
// products and scatters, the bias gradients sum the f32 values, and demb is
// stored in the embedding's dtype after each pass, as on the TPU. So are the
// per-source scale and d_denom as gathered, alpha, d_s and the dscale term
// d_alpha * e: the TPU packs scale and d_denom into compute-dtype node planes,
// broadcasts alpha and d_s by compute-dtype products and scatters the dscale
// term in the compute dtype (pallas_gat.py:825, :845, :902, :1081, :1146). The node
// accumulators dnm, dscale, dnq, dnk arrive seeded with the self-loop
// cotangents. Masked edges are skipped: their d_msg / dekb rows are written
// as zeros, so demb there is the carry (or 0) and nothing of them enters a
// sum.
//
// On the TPU one resident block accumulates dW and db over a sequential
// grid and the three products of a pass (emb W, cot W^T, emb^T cot, 2 G E D
// HD operations each: 21 GFLOP at G=64, E=4096, D=HD=200) run on the MXU.
// Blocks run in parallel here, and there are two routes behind each entry
// point: the tensor-core route (1) in both dtypes, and the CUDA-core kernels
// of this file (route 0) when the caller names them.
//
// bfloat16, the main path: tensor cores (gat_bwd_tc.cuh, mma_tile.cuh). Every
// operand is a bf16 value already (emb, W rounded to the compute dtype, the
// rounded cotangent), so `mma.sync` with f32 accumulators computes the same
// sums. Four launches: persistent blocks with W resident in shared memory
// whose warps each take 16 edges at a time through product 1, the row-wise
// epilogue (gathers, cotangent, scatters, head sums) and product 2 from the
// cotangent tile still in shared memory; the cotangent goes to device memory
// once, for a tensor-core dW launch split over edge ranges; two reductions of
// the dW and db partials. No transposed copy of W, no atomics on dW or db.
// Past D = 256 the edge launch streams W's rows through shared memory twice a
// round of units, once for each product against W (gat_bwd_tc.cuh), so a
// column launch is one edge launch at any D, with no f32 projection in
// device memory.
//
// float32: the same four launches on the tf32 tensor cores, each product
// split (mma_tile.cuh): hi = tf32(x) and lo = x - hi for every operand, then
// a_lo b_hi + a_hi b_lo + a_hi b_hi in f32 accumulators, three m16n8k8 tf32
// products a step. What is left out, a_lo b_lo and lo's own truncation, is
// at most about 2^-20 of |a| |b| a product: the passes hold their plain
// versions within 1.7e-5 of the largest value on the card (sums of another
// order), inside the 1e-4 the f32 path is kept to. W's f32 rows would leave
// room for three warps beside them at D = HD = 200, so the edge launch
// streams them at every D, from W itself (no rounding), through a ring of
// 32-row chunks (TcStream32Shape). Its bound is the tf32 rate, 495 TFLOP/s
// for a third as many f32-accurate operations; what holds it back on the
// card is the split's integer work beside each `mma.sync` (no wgmma here)
// and the warps' lockstep through the ring: the epilogue and the streams of
// every warp of a block fall in the same stretch, with no product beside
// them. On the H100 (NVIDIA H100 80GB HBM3, 700 W limit; shapes as below,
// f32; chip_smoke.py, the CUDA-core route timed in turns on the same
// inputs) a call of pass 1 / 2 takes 1.79 / 1.73 ms at D = HD = 200
// (route 0 3.49 / 3.31 ms, the plain version 3.95 / 3.85; bound 0.28 ms),
// 8.6 / 8.6 ms at gnn_dim 512 (16.3 / 15.9; 12.8 / 13.0; 1.84) and 41.1 /
// 40.7 ms at 1040 (87.8 / 83.2; 48.2 / 48.7; 7.75).
//
// route 0, the CUDA-core kernels of this file, in full f32 (or bf16). Four
// launches as well:
//   1. the edge kernel: the per-edge projection (register-tiled, as the
//      forward), the per-edge cotangents, the node scatters by 16-byte
//      atomicAdd, d_msg / dekb written once to a scratch array in the compute
//      dtype, and each block's partial bias gradient;
//   2. demb = scratch W^T (+ carry / + pass 1's demb), the same tiled product
//      with the transposed weight;
//   3. dW partials: emb^T scratch split over the edges, each block a range of
//      edges and 40 output columns, every partial written once;
//   4. one reduction of the dW and db partials.
// They run when the wrappers are asked for route 0, which is how the two
// routes are timed side by side.
//
// On the H100 (NVIDIA H100 80GB HBM3, 700 W limit; G=64, N=200, E=4096,
// D=HD=200, 4 heads, bf16, 25% of slots masked; medians of 20 launches by
// CUDA events): the bound is bytes, about 330 MB per pass (emb, carry or demb
// in, demb out, scores, d_alpha, nodes), 0.10 ms, against 64 us of operations
// at the bf16 tensor-core peak. The CUDA-core route takes 3.37 ms (pass 1)
// and 3.38 ms (pass 2), about 3 ms of it f32 FMAs at 19-20 TFLOP/s. The
// tensor-core route takes 0.57 ms and 0.56 ms: edge kernel 0.42 / 0.40 ms,
// dW 0.14 ms, reductions 11 us. Switched off one at a time, the products
// account for about 0.12 ms of the edge kernel, the epilogue's arithmetic
// and shared-memory staging for 0.10-0.16 ms, the gathers, scatters and
// streams for 0.19 ms: the last is the per-edge traffic through L2 that the
// unprojected op's backward kernels (gat_unproj.cu) take 0.18 and 0.26 ms
// for by themselves, and the three overlap only in part, since registers
// (104 f32 accumulators a lane) hold a block to 8 warps that each run their
// stages in turn. Two warps on each unit (16 warps a block, the column
// tiles split between them) gained 7% on pass 1 and 1% on pass 2 and were
// not kept. At gnn_dim 512 (2 column launches of 256, D = 512) a call of
// pass 1 / 2 takes 2.83-2.85 / 2.90-2.91 ms, at 1040 (8 launches of 128 /
// 136 columns) 13.76-13.84 / 13.66-13.67 ms, against 4.11-4.12 / 3.62-3.63
// and 22.37-22.39 / 22.03 ms for the sliced design it replaced, in turns on
// one card; dW takes 0.31 ms a launch at 512 x 256 and 0.51-0.52 ms at
// 1040 x 136.
#include "gat_common.cuh"
#include "gat_bwd_tc.cuh"
#include "reduce_partials.cuh"

namespace {

constexpr int DW_COLS = 40;              // output columns of a dW block
constexpr int DW_TX = DW_COLS / 8;       // column threads of a dW block

// exp(min(s - gmax, 0)) of a masked edge
__device__ __forceinline__ float edge_exp(const float* __restrict__ scores,
                                          const float* __restrict__ gmax,
                                          long long g, int h, int e, int E,
                                          int H) {
  return expf(fminf(scores[(g * H + h) * E + e] - gmax[g * H + h], 0.0f));
}

// The block's partial bias gradient: every thread hands in the sums over
// its edges of its 8 columns; the TY partials of a column are added up
// through s_part (TY x HD floats) and written to row `block` of db_part.
__device__ __forceinline__ void block_bias_partial(const float sum[8], int tx,
                                                   int ty, int HD,
                                                   float* s_part,
                                                   float* __restrict__ db_part,
                                                   long long block) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s_part[ty * HD + column(tx, j, HD)] = sum[j];
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < HD) {
    float v = 0.0f;
    for (int t = 0; t < TY; ++t) v += s_part[t * HD + tid];
    db_part[block * HD + tid] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_HD)
bwd1_edge_kernel(const T* __restrict__ gout, const T* __restrict__ nm,
                 const T* __restrict__ emb, const float* __restrict__ w_me,
                 const float* __restrict__ b_me,
                 const float* __restrict__ scores,
                 const float* __restrict__ gmax,
                 const float* __restrict__ scale,
                 const int32_t* __restrict__ src,
                 const int32_t* __restrict__ dst,
                 const uint8_t* __restrict__ mask, T* __restrict__ dmsg,
                 float* __restrict__ dalpha, float* __restrict__ dnm,
                 float* __restrict__ dscale, float* __restrict__ db_part,
                 int E, int N, int D, int HD, int H, int part, int ldc) {
  __shared__ __align__(16) float s_emb[KC][TEP];
  __shared__ float s_alpha[TE][MAX_H];
  __shared__ float s_e[TE][MAX_H];
  __shared__ int s_head0[2][MAX_HD / 8];
  extern __shared__ __align__(16) float s_w[];   // then s_red, then s_part
  const long long g = blockIdx.y;
  const int e0 = blockIdx.x * TE;
  const int tid = threadIdx.x, nthreads = blockDim.x, ntx = HD / 8;
  const int tx = tid % ntx, ty = tid / ntx;
  const int dph = HD / H;

  if (tid < 2 * ntx)
    s_head0[tid / ntx][tid % ntx] = column(tid % ntx, 4 * (tid / ntx), HD) / dph;
  // e and alpha per (edge, head); 0 for masked and padded slots
  for (int idx = tid; idx < TE * H; idx += nthreads) {
    const int el = idx / H, h = idx % H, e = e0 + el;
    float ee = 0.0f, a = 0.0f;
    if (e < E && mask[g * E + e]) {
      ee = edge_exp(scores, gmax, g, h, e, E, H);
      a = round_to<T>(
          ee * round_to<T>(scale[(g * N + src[g * E + e]) * H + h]));
    }
    s_e[el][h] = ee;
    s_alpha[el][h] = a;
  }

  float acc[EPT][8];
  edge_projection<T>(emb, w_me, g, e0, E, D, HD, s_emb, s_w, acc);

  // the projection ended on a barrier: s_w is free for the partial sums
  float* s_red = s_w;
  int head[8];
  float bias[8], dbsum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    head[j] = column(tx, j, HD) / dph;
    bias[j] = b_me[column(tx, j, HD)];
    dbsum[j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int el = ty * EPT + i, e = e0 + el;
    float first[2] = {0.0f, 0.0f}, next[2] = {0.0f, 0.0f};
    if (e < E) {
      float dm[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) dm[j] = 0.0f;
      if (mask[g * E + e]) {
        const long long s_row = (g * N + src[g * E + e]) * HD;
        const long long d_row = (g * N + dst[g * E + e]) * HD;
        float m[8], gd[8];
        load_row<T, 4>(nm + s_row + 4 * tx, m);
        load_row<T, 4>(nm + s_row + HD / 2 + 4 * tx, m + 4);
        load_row<T, 4>(gout + d_row + 4 * tx, gd);
        load_row<T, 4>(gout + d_row + HD / 2 + 4 * tx, gd + 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = (m[j] + acc[i][j] + bias[j]) * gd[j];
          if (head[j] == head[j & 4]) first[j / 4] += p;
          else next[j / 4] += p;
          const float d = s_alpha[el][head[j]] * gd[j];
          dbsum[j] += d;
          dm[j] = round_to<T>(d);
        }
        atomicAdd(reinterpret_cast<float4*>(dnm + s_row + 4 * tx),
                  make_float4(dm[0], dm[1], dm[2], dm[3]));
        atomicAdd(reinterpret_cast<float4*>(dnm + s_row + HD / 2 + 4 * tx),
                  make_float4(dm[4], dm[5], dm[6], dm[7]));
      }
      T* row = dmsg + (g * E + e) * ldc;
      store_row4<T>(row + 4 * tx, dm);
      store_row4<T>(row + HD / 2 + 4 * tx, dm + 4);
    }
#pragma unroll
    for (int run = 0; run < 2; ++run) {
      s_red[((run * ntx + tx) * 2) * RED_ROW + el] = first[run];
      s_red[((run * ntx + tx) * 2 + 1) * RED_ROW + el] = next[run];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < TE * H; idx += nthreads) {
    const int h = idx / TE, el = idx % TE, e = e0 + el;
    if (e >= E) continue;
    float v = 0.0f;
    if (mask[g * E + e]) {
      for (int run = 0; run < 2; ++run)
        for (int t = 0; t < ntx; ++t) {
          const int h0 = s_head0[run][t];
          if (h0 == h) v += s_red[((run * ntx + t) * 2) * RED_ROW + el];
          else if (h0 + 1 == h)
            v += s_red[((run * ntx + t) * 2 + 1) * RED_ROW + el];
        }
      if (part & PART_ADD) v += dalpha[(g * H + h) * E + e];
      if (!(part & PART_OPEN))
        atomicAdd(&dscale[(g * N + src[g * E + e]) * H + h],
                  round_to<T>(v * s_e[el][h]));
    }
    dalpha[(g * H + h) * E + e] = v;
  }
  __syncthreads();
  block_bias_partial(dbsum, tx, ty, HD, s_w, db_part,
                     g * gridDim.x + blockIdx.x);
}

template <typename T>
__global__ void __launch_bounds__(MAX_HD)
bwd2_edge_kernel(const T* __restrict__ nq, const T* __restrict__ nk,
                 const T* __restrict__ emb, const float* __restrict__ w_ke,
                 const float* __restrict__ b_ke,
                 const float* __restrict__ scores,
                 const float* __restrict__ gmax,
                 const float* __restrict__ dalpha,
                 const float* __restrict__ scale,
                 const float* __restrict__ d_denom,
                 const int32_t* __restrict__ src,
                 const int32_t* __restrict__ dst,
                 const uint8_t* __restrict__ mask, T* __restrict__ dekb,
                 float* __restrict__ dnq, float* __restrict__ dnk,
                 float* __restrict__ db_part, int E, int N, int D, int HD,
                 int H, int ldc) {
  __shared__ __align__(16) float s_emb[KC][TEP];
  __shared__ float s_ds[TE][MAX_H];
  extern __shared__ __align__(16) float s_w[];   // then s_part
  const long long g = blockIdx.y;
  const int e0 = blockIdx.x * TE;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tx = tid % (HD / 8), ty = tid / (HD / 8);
  const int dph = HD / H;

  // d_s per (edge, head); 0 for masked and padded slots
  for (int idx = tid; idx < TE * H; idx += nthreads) {
    const int el = idx / H, h = idx % H, e = e0 + el;
    float ds = 0.0f;
    if (e < E && mask[g * E + e]) {
      const long long node = (g * N + src[g * E + e]) * H + h;
      ds = round_to<T>(score_cotangent(
          dalpha[(g * H + h) * E + e], round_to<T>(scale[node]),
          round_to<T>(d_denom[node]), edge_exp(scores, gmax, g, h, e, E, H)));
    }
    s_ds[el][h] = ds;
  }

  float acc[EPT][8];
  edge_projection<T>(emb, w_ke, g, e0, E, D, HD, s_emb, s_w, acc);

  int head[8];
  float bias[8], dbsum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    head[j] = column(tx, j, HD) / dph;
    bias[j] = b_ke[column(tx, j, HD)];
    dbsum[j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int el = ty * EPT + i, e = e0 + el;
    if (e >= E) continue;
    float dk[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) dk[j] = 0.0f;
    if (mask[g * E + e]) {
      const long long s_row = (g * N + src[g * E + e]) * HD;
      const long long d_row = (g * N + dst[g * E + e]) * HD;
      float q[8], k[8], dq[8];
      load_row<T, 4>(nq + s_row + 4 * tx, q);
      load_row<T, 4>(nq + s_row + HD / 2 + 4 * tx, q + 4);
      load_row<T, 4>(nk + d_row + 4 * tx, k);
      load_row<T, 4>(nk + d_row + HD / 2 + 4 * tx, k + 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float ds = s_ds[el][head[j]];
        const float d = ds * q[j];
        dbsum[j] += d;
        dk[j] = round_to<T>(d);
        dq[j] = round_to<T>(ds * (k[j] + acc[i][j] + bias[j]));
      }
      atomicAdd(reinterpret_cast<float4*>(dnq + s_row + 4 * tx),
                make_float4(dq[0], dq[1], dq[2], dq[3]));
      atomicAdd(reinterpret_cast<float4*>(dnq + s_row + HD / 2 + 4 * tx),
                make_float4(dq[4], dq[5], dq[6], dq[7]));
      atomicAdd(reinterpret_cast<float4*>(dnk + d_row + 4 * tx),
                make_float4(dk[0], dk[1], dk[2], dk[3]));
      atomicAdd(reinterpret_cast<float4*>(dnk + d_row + HD / 2 + 4 * tx),
                make_float4(dk[4], dk[5], dk[6], dk[7]));
    }
    T* row = dekb + (g * E + e) * ldc;
    store_row4<T>(row + 4 * tx, dk);
    store_row4<T>(row + HD / 2 + 4 * tx, dk + 4);
  }
  // the projection ended on a barrier and nothing used s_w since
  block_bias_partial(dbsum, tx, ty, HD, s_w, db_part,
                     g * gridDim.x + blockIdx.x);
}

// out[g, e, z C : z C + C] = a[g, e, :] wt_z (+ the same columns of add),
// z = blockIdx.z the slice of out's columns: a (G, E, K), wt the transposed
// weight in slices, (slices, K, C) slice-major, out and add rows of ldo
// columns. `add` may be null or `out` itself (every thread reads its own
// elements before it writes them).
template <typename T>
__global__ void __launch_bounds__(MAX_HD)
demb_kernel(const T* __restrict__ a, const float* __restrict__ wt,
            const T* add, T* out, int E, int K, int C, int ldo) {
  __shared__ __align__(16) float s_a[KC][TEP];
  extern __shared__ __align__(16) float s_w[];
  wt += (long long)blockIdx.z * K * C;
  out += (long long)blockIdx.z * C;
  if (add != nullptr) add += (long long)blockIdx.z * C;
  const long long g = blockIdx.y;
  const int e0 = blockIdx.x * TE;
  const int tx = threadIdx.x % (C / 8), ty = threadIdx.x / (C / 8);
  float acc[EPT][8];
  edge_projection<T>(a, wt, g, e0, E, K, C, s_a, s_w, acc);
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = e0 + ty * EPT + i;
    if (e >= E) continue;
    const long long row = (g * E + e) * ldo;
    if (add != nullptr) {
      float c[8];
      load_row<T, 4>(add + row + 4 * tx, c);
      load_row<T, 4>(add + row + C / 2 + 4 * tx, c + 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += c[j];
    }
    store_row4<T>(out + row + 4 * tx, acc[i]);
    store_row4<T>(out + row + C / 2 + 4 * tx, acc[i] + 4);
  }
}

// part[s, d, c] = sum over the rows r of range s of a[r, d] * b[r, c]:
// a (R, D) the edge embedding, b (R, HD) the cotangent rows (ldb apart),
// both over all graphs' edges. A block takes the DS rows d of slice blockIdx.z,
// DW_COLS columns and one range of rows; a thread keeps 8 x 8 of the output
// in registers. The rows are the depth of this product, so both operands
// are staged as they lie.
template <typename T>
__global__ void __launch_bounds__(MAX_HD / 8 * DW_TX)
dw_partial_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  float* __restrict__ part, long long R, long long chunk,
                  int D, int DS, int HD, int ldb) {
  __shared__ __align__(16) float s_a[KC][MAX_HD];
  __shared__ __align__(16) float s_b[KC][DW_COLS];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tx = tid % DW_TX, ty = tid / DW_TX;
  const int c0 = blockIdx.x * DW_COLS;
  const int d0 = blockIdx.z * DS;
  const long long r_begin = blockIdx.y * chunk;
  const long long r_end = r_begin + chunk < R ? r_begin + chunk : R;
  const int d8 = DS / 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (long long r0 = r_begin; r0 < r_end; r0 += KC) {
    for (int idx = tid; idx < KC * d8; idx += nthreads) {
      const int r = idx / d8, dc = (idx % d8) * 8;
      float v[8];
      if (r0 + r < r_end) {
        load_row<T, 8>(a + (r0 + r) * D + d0 + dc, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.0f;
      }
      *reinterpret_cast<float4*>(&s_a[r][dc]) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&s_a[r][dc + 4]) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
    for (int idx = tid; idx < KC * DW_TX; idx += nthreads) {
      const int r = idx / DW_TX, cc = (idx % DW_TX) * 8;
      float v[8];
      if (r0 + r < r_end && c0 + cc < HD) {
        load_row<T, 8>(b + (r0 + r) * ldb + c0 + cc, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.0f;
      }
      *reinterpret_cast<float4*>(&s_b[r][cc]) =
          make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&s_b[r][cc + 4]) =
          make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s_a[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s_a[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s_b[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s_b[kk][tx * 8 + 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
  if (c0 + tx * 8 >= HD) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* row = part + ((long long)blockIdx.y * D + d0 + ty * 8 + i) * HD +
                 c0 + tx * 8;
    *reinterpret_cast<float4*>(row) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// DS: the rows of W's slices, which divide D (gat_kernels.d_slices)
bool shapes_ok(int D, int DS, int HD, int H) {
  return D > 0 && D % 8 == 0 && DS > 0 && DS % 8 == 0 && DS <= MAX_HD &&
         D % DS == 0 && HD > 0 && HD % 8 == 0 && HD <= MAX_HD && H > 0 &&
         H <= MAX_H && HD % H == 0 && HD / H >= 4;
}

size_t edge_smem(int HD) {
  int n = KC * HD;
  if (red_floats(HD) > n) n = red_floats(HD);
  return sizeof(float) * n;
}

// demb = cot W^T (+ the same columns of add) on CUDA cores: a (64-slot
// tile, graph, slice of D / DS) block each; cot (G, E, HD) with rows HD
// apart, wt: W^T in slices, (D / DS, HD, DS).
template <typename T>
void demb_launch(const T* cot, const float* wt, const T* add, T* demb,
                 int G, int E, int D, int DS, int HD, cudaStream_t s) {
  demb_kernel<T><<<dim3((E + TE - 1) / TE, G, D / DS), DS / 8 * TY,
                   sizeof(float) * KC * DS, s>>>(cot, wt, add, demb, E, HD,
                                                 DS, D);
}

// launches 2-4 of a pass: demb (none where demb is null: the pass leaves
// it to its one demb launch) and the dW partials, each with a grid dimension over
// the D / DS slices of W's rows (slice z writes columns [z DS, z DS + DS)
// of demb and those rows of the partials), then the two reductions. wt:
// W^T in slices, (D / DS, HD, DS); cot's rows ldc apart.
template <typename T>
void finish_pass(const T* emb, const T* cot, const float* wt, const T* add,
                 T* demb, float* dw_part, float* db_part, float* dw,
                 float* db, int G, int E, int D, int DS, int HD, int ldc,
                 int n_split, cudaStream_t s) {
  const dim3 grid((E + TE - 1) / TE, G);
  if (demb != nullptr)
    demb_launch<T>(cot, wt, add, demb, G, E, D, DS, HD, s);
  const long long R = (long long)G * E;
  long long chunk = (R + n_split - 1) / n_split;
  chunk = (chunk + KC - 1) / KC * KC;
  dw_partial_kernel<T>
      <<<dim3((HD + DW_COLS - 1) / DW_COLS, n_split, D / DS), DS / 8 * DW_TX,
         0, s>>>(emb, cot, dw_part, R, chunk, D, DS, HD, ldc);
  reduce_partials_kernel<<<(D * HD + 31) / 32, dim3(32, 8), 0, s>>>(
      dw_part, dw, n_split, D * HD);
  reduce_partials_kernel<<<(HD + 31) / 32, dim3(32, 8), 0, s>>>(
      db_part, db, (int)(grid.x * grid.y), HD);
}

// route 1 of pass 1 in T (gat_bwd_tc.cuh's arguments from the entry
// point's; pass 2 below likewise)
template <typename T>
int pass1_tc(const void* gout, const void* nm, const void* emb,
             const void* w_me, const void* b_me, const void* scores,
             const void* gmax, const void* scale, const void* src,
             const void* dst, const void* mask, const void* carry,
             void* dmsg, void* demb, void* dalpha, void* dnm, void* dscale,
             void* db_part, void* db, const void* w_stream, int G, int N,
             int E, int D, int HD, int H, int d_slice, int warps,
             int n_blocks, int part, int ld_cot, void* stream) {
  TcArgs<T> a = {};
  a.rows_src = (const T*)nm;
  a.rows_dst = (const T*)gout;
  a.emb = (const T*)emb;
  a.w = (const float*)w_me;
  a.bias = (const float*)b_me;
  a.scores = (const float*)scores;
  a.gmax = (const float*)gmax;
  a.scale = (const float*)scale;
  a.src = (const int32_t*)src;
  a.dst = (const int32_t*)dst;
  a.mask = (const uint8_t*)mask;
  a.add = (const T*)carry;
  a.cot = (T*)dmsg;
  a.demb = (T*)demb;
  a.dalpha_out = (float*)dalpha;
  a.acc_src = (float*)dnm;
  a.dscale = (float*)dscale;
  a.db_part = (float*)db_part;
  a.G = G; a.N = N; a.E = E; a.D = D; a.HD = HD; a.H = H; a.DS = d_slice;
  a.part = part;
  a.ldc = ld_cot;
  a.ws = (const T*)w_stream;
  return launch_pass_tc<1>(a, (float*)db, warps, n_blocks,
                           (cudaStream_t)stream);
}

template <typename T>
int pass2_tc(const void* nq, const void* nk, const void* emb,
             const void* w_ke, const void* b_ke, const void* scores,
             const void* gmax, const void* dalpha, const void* scale,
             const void* d_denom, const void* src, const void* dst,
             const void* mask, void* dekb, void* demb, void* dnq, void* dnk,
             void* db_part, void* db, const void* w_stream, int G, int N,
             int E, int D, int HD, int H, int d_slice, int warps,
             int n_blocks, int ld_cot, void* stream) {
  TcArgs<T> a = {};
  a.rows_src = (const T*)nq;
  a.rows_dst = (const T*)nk;
  a.emb = (const T*)emb;
  a.w = (const float*)w_ke;
  a.bias = (const float*)b_ke;
  a.scores = (const float*)scores;
  a.gmax = (const float*)gmax;
  a.scale = (const float*)scale;
  a.dalpha_in = (const float*)dalpha;
  a.d_denom = (const float*)d_denom;
  a.src = (const int32_t*)src;
  a.dst = (const int32_t*)dst;
  a.mask = (const uint8_t*)mask;
  a.add = (const T*)demb;
  a.cot = (T*)dekb;
  a.demb = (T*)demb;
  a.acc_src = (float*)dnq;
  a.acc_dst = (float*)dnk;
  a.db_part = (float*)db_part;
  a.G = G; a.N = N; a.E = E; a.D = D; a.HD = HD; a.H = H; a.DS = d_slice;
  a.ldc = ld_cot;
  a.ws = (const T*)w_stream;
  return launch_pass_tc<2>(a, (float*)db, warps, n_blocks,
                           (cudaStream_t)stream);
}

}  // namespace

// dtype: 0 = float32 node/edge arrays, 1 = bfloat16. Takes D a multiple of
// 8, in slices of d_slice rows (a multiple of 8 up to 256 that divides D),
// HD a multiple of 8 up to 256, H <= 8 heads of at least 4 features, 16-byte
// aligned arrays. carry may be null. dmsg (G, E, HD), its rows ld_cot
// elements apart (HD, or a wider array's columns: a multiple of 8), gets the
// cotangent rows d_msg; dw_part (n_split, D, HD) is scratch on route 0 and
// must be null on route 1, which makes no dW (dw and n_split are not read;
// the wrapper's one `gat_dw_tc` launch a pass, csrc/gat_dw.cu, makes it
// from d_msg). demb null: no
// demb product (carry is not read), which a pass of several column launches
// leaves to one demb launch over all of their dmsg columns (gat_demb.cu
// `gat_demb_tc`, or gat_bwd_demb on route 0). route 0, the CUDA-core
// kernels (either dtype): the
// edge kernel takes any D, the demb and dW launches a slice of W's rows a
// block (a grid dimension); w_t is w transposed in slices, (D / d_slice,
// HD, d_slice); db_part (G * ceil(E / 64), HD) is scratch; warps, n_blocks
// and w_stream are not read. route 1, the tensor-core kernels (either
// dtype): w_t is not read; the edge kernel runs once, n_blocks blocks of
// `warps` warps, in bf16 with W resident in shared memory (D = d_slice <=
// 256) or, given w_stream (W rounded to bf16, (D, HD); null otherwise), its
// rows streamed through shared memory at any D; in f32 always streamed,
// from w_stream (W itself, f32, which must be given); db_part is
// (n_blocks, HD). Either way the
// node-side outputs (dalpha, dnm, dscale; dnq, dnk in pass 2) and db are
// written by one pass over the edges only, and demb with no atomics. part
// (PART_ADD | PART_OPEN, gat_common.cuh; 0 for whole heads): a column slice
// of a head wider than 256 features, given its columns of gout, nm, w_me
// (and w_me_t) and b_me, which adds its d_alpha to the slices' before it in
// dalpha; only the last adds the whole d_alpha * e into dscale.
extern "C" int gat_bwd_pass1(
    const void* gout, const void* nm, const void* emb, const void* w_me,
    const void* w_me_t, const void* b_me, const void* scores,
    const void* gmax, const void* scale, const void* src, const void* dst,
    const void* mask, const void* carry, void* dmsg, void* demb, void* dalpha,
    void* dnm, void* dscale, void* dw_part, void* db_part, void* dw, void* db,
    const void* w_stream, int G, int N, int E, int D, int HD, int H,
    int n_split, int d_slice, int dtype, int route, int warps, int n_blocks,
    int part, int ld_cot, void* stream) {
  if (!shapes_ok(D, d_slice, HD, H) ||
      (route == 0 ? dw_part == nullptr || n_split <= 0 : dw_part != nullptr) ||
      part < 0 ||
      part > 3 || ld_cot < HD || ld_cot % 8 != 0 || !aligned16(gout) ||
      !aligned16(nm) || !aligned16(emb) || !aligned16(w_me) ||
      !aligned16(w_me_t) || !aligned16(carry) || !aligned16(dmsg) ||
      !aligned16(demb) || !aligned16(dnm) || !aligned16(dw_part) ||
      (route != 0 && route != 1) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  if (route == 1)
    return dtype == 1
               ? pass1_tc<bf16>(gout, nm, emb, w_me, b_me, scores, gmax,
                                scale, src, dst, mask, carry, dmsg, demb,
                                dalpha, dnm, dscale, db_part, db, w_stream,
                                G, N, E, D, HD, H, d_slice, warps, n_blocks,
                                part, ld_cot, stream)
               : pass1_tc<float>(gout, nm, emb, w_me, b_me, scores, gmax,
                                 scale, src, dst, mask, carry, dmsg, demb,
                                 dalpha, dnm, dscale, db_part, db, w_stream,
                                 G, N, E, D, HD, H, d_slice, warps, n_blocks,
                                 part, ld_cot, stream);
  const dim3 grid((E + TE - 1) / TE, G);
  const int threads = HD / 8 * TY;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    bwd1_edge_kernel<T><<<grid, threads, edge_smem(HD), s>>>(
        (const T*)gout, (const T*)nm, (const T*)emb, (const float*)w_me,
        (const float*)b_me, (const float*)scores, (const float*)gmax,
        (const float*)scale, (const int32_t*)src, (const int32_t*)dst,
        (const uint8_t*)mask, (T*)dmsg, (float*)dalpha, (float*)dnm,
        (float*)dscale, (float*)db_part, E, N, D, HD, H, part, ld_cot);
    finish_pass<T>((const T*)emb, (const T*)dmsg, (const float*)w_me_t,
                   (const T*)carry, (T*)demb, (float*)dw_part,
                   (float*)db_part, (float*)dw, (float*)db, G, E, D, d_slice,
                   HD, ld_cot, n_split, s);
  } else {
    typedef float T;
    bwd1_edge_kernel<T><<<grid, threads, edge_smem(HD), s>>>(
        (const T*)gout, (const T*)nm, (const T*)emb, (const float*)w_me,
        (const float*)b_me, (const float*)scores, (const float*)gmax,
        (const float*)scale, (const int32_t*)src, (const int32_t*)dst,
        (const uint8_t*)mask, (T*)dmsg, (float*)dalpha, (float*)dnm,
        (float*)dscale, (float*)db_part, E, N, D, HD, H, part, ld_cot);
    finish_pass<T>((const T*)emb, (const T*)dmsg, (const float*)w_me_t,
                   (const T*)carry, (T*)demb, (float*)dw_part,
                   (float*)db_part, (float*)dw, (float*)db, G, E, D, d_slice,
                   HD, ld_cot, n_split, s);
  }
  return (int)cudaGetLastError();
}

// demb holds pass 1's result and is updated in place, or is null (no demb
// product, as in pass 1). dekb gets the cotangent rows (rows ld_cot apart),
// and dw_part, db_part, route, warps, n_blocks and w_stream mean what they
// do in pass 1.
extern "C" int gat_bwd_pass2(
    const void* nq, const void* nk, const void* emb, const void* w_ke,
    const void* w_ke_t, const void* b_ke, const void* scores,
    const void* gmax, const void* dalpha, const void* scale,
    const void* d_denom, const void* src, const void* dst, const void* mask,
    void* dekb, void* demb, void* dnq, void* dnk, void* dw_part,
    void* db_part, void* dw, void* db, const void* w_stream, int G, int N,
    int E, int D, int HD, int H, int n_split, int d_slice, int dtype,
    int route, int warps, int n_blocks, int ld_cot, void* stream) {
  if (!shapes_ok(D, d_slice, HD, H) ||
      (route == 0 ? dw_part == nullptr || n_split <= 0 : dw_part != nullptr) ||
      ld_cot < HD ||
      ld_cot % 8 != 0 || !aligned16(nq) ||
      !aligned16(nk) || !aligned16(emb) || !aligned16(w_ke) ||
      !aligned16(w_ke_t) || !aligned16(dekb) || !aligned16(demb) ||
      !aligned16(dnq) || !aligned16(dnk) || !aligned16(dw_part) ||
      (route != 0 && route != 1) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  if (route == 1)
    return dtype == 1
               ? pass2_tc<bf16>(nq, nk, emb, w_ke, b_ke, scores, gmax, dalpha,
                                scale, d_denom, src, dst, mask, dekb, demb,
                                dnq, dnk, db_part, db, w_stream, G, N, E, D,
                                HD, H, d_slice, warps, n_blocks, ld_cot,
                                stream)
               : pass2_tc<float>(nq, nk, emb, w_ke, b_ke, scores, gmax,
                                 dalpha, scale, d_denom, src, dst, mask, dekb,
                                 demb, dnq, dnk, db_part, db, w_stream, G, N,
                                 E, D, HD, H, d_slice, warps, n_blocks,
                                 ld_cot, stream);
  const dim3 grid((E + TE - 1) / TE, G);
  const int threads = HD / 8 * TY;
  const size_t smem = sizeof(float) * KC * HD;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    bwd2_edge_kernel<T><<<grid, threads, smem, s>>>(
        (const T*)nq, (const T*)nk, (const T*)emb, (const float*)w_ke,
        (const float*)b_ke, (const float*)scores, (const float*)gmax,
        (const float*)dalpha, (const float*)scale, (const float*)d_denom,
        (const int32_t*)src, (const int32_t*)dst, (const uint8_t*)mask,
        (T*)dekb, (float*)dnq, (float*)dnk, (float*)db_part, E, N, D, HD, H,
        ld_cot);
    finish_pass<T>((const T*)emb, (const T*)dekb, (const float*)w_ke_t,
                   (const T*)demb, (T*)demb, (float*)dw_part,
                   (float*)db_part, (float*)dw, (float*)db, G, E, D, d_slice,
                   HD, ld_cot, n_split, s);
  } else {
    typedef float T;
    bwd2_edge_kernel<T><<<grid, threads, smem, s>>>(
        (const T*)nq, (const T*)nk, (const T*)emb, (const float*)w_ke,
        (const float*)b_ke, (const float*)scores, (const float*)gmax,
        (const float*)dalpha, (const float*)scale, (const float*)d_denom,
        (const int32_t*)src, (const int32_t*)dst, (const uint8_t*)mask,
        (T*)dekb, (float*)dnq, (float*)dnk, (float*)db_part, E, N, D, HD, H,
        ld_cot);
    finish_pass<T>((const T*)emb, (const T*)dekb, (const float*)w_ke_t,
                   (const T*)demb, (T*)demb, (float*)dw_part,
                   (float*)db_part, (float*)dw, (float*)db, G, E, D, d_slice,
                   HD, ld_cot, n_split, s);
  }
  return (int)cudaGetLastError();
}

// demb = cot W^T (+ add), rounded to the dtype once: the demb product of a
// backward pass whose column launches ran with demb null, over all HD
// columns of their cotangent rows (ROADMAP C17), on CUDA cores
// (`demb_kernel`, W rounded as it loads it): route 0 of `bwd_demb`, whose
// route 1 is csrc/gat_demb.cu `gat_demb_tc`. cot (G, E, HD) contiguous, add
// (G, E, D) or null, demb (G, E, D); add may be demb (pass 2, in place).
// w_t is W^T in slices of d_slice of its rows, (D / d_slice, HD, d_slice).
// D and HD multiples of 8 (any size), 16-byte aligned arrays.
extern "C" int gat_bwd_demb(const void* cot, const void* w_t,
                            const void* add, void* demb, int G, int E, int D,
                            int HD, int d_slice, int dtype, void* stream) {
  if (D <= 0 || D % 8 != 0 || HD <= 0 || HD % 8 != 0 || G < 0 || E < 0 ||
      !aligned16(cot) || !aligned16(w_t) || !aligned16(add) ||
      !aligned16(demb) || (dtype != 0 && dtype != 1) || w_t == nullptr ||
      d_slice <= 0 || d_slice % 8 != 0 || d_slice > MAX_HD ||
      D % d_slice != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    typedef __nv_bfloat16 T;
    demb_launch<T>((const T*)cot, (const float*)w_t, (const T*)add,
                   (T*)demb, G, E, D, d_slice, HD, s);
  } else {
    typedef float T;
    demb_launch<T>((const T*)cot, (const float*)w_t, (const T*)add,
                   (T*)demb, G, E, D, d_slice, HD, s);
  }
  return (int)cudaGetLastError();
}

// dW = emb^T cot over all G E slots, f32: `dw_tc_kernel` (mma.sync from a
// cp.async ring, gat_bwd_tc.cuh) over all HD columns in n_split slot
// ranges and W's rows in slices of d_slice, then the sum of the partials:
// route 0 of `bwd_dw`, whose route 1 is csrc/gat_dw.cu `gat_dw_tc`. emb
// (G, E, D), cot (G, E, HD) contiguous, dw_part (n_split, D, HD) scratch,
// dw (D, HD). D a multiple of d_slice (a multiple of 8 up to 256), HD a
// multiple of 8 (any size), 16-byte aligned arrays.
extern "C" int gat_bwd_dw(const void* emb, const void* cot, void* dw_part,
                          void* dw, int G, int E, int D, int HD, int d_slice,
                          int n_split, int dtype, void* stream) {
  if (D <= 0 || D % 8 != 0 || HD <= 0 || HD % 8 != 0 || G < 0 || E < 0 ||
      d_slice <= 0 || d_slice % 8 != 0 || d_slice > MAX_HD ||
      D % d_slice != 0 || n_split <= 0 || emb == nullptr || cot == nullptr ||
      dw_part == nullptr || dw == nullptr || !aligned16(emb) ||
      !aligned16(cot) || !aligned16(dw_part) || !aligned16(dw) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)G * E == 0)
    return (int)cudaMemsetAsync(dw, 0, (size_t)D * HD * sizeof(float), s);
  if (dtype == 1) {
    TcArgs<bf16> a = {};
    a.emb = (const bf16*)emb;
    a.cot = (bf16*)cot;
    a.G = G; a.E = E; a.D = D; a.HD = HD; a.DS = d_slice; a.ldc = HD;
    return (int)launch_dw_tc(a, (float*)dw_part, (float*)dw, n_split, s);
  }
  TcArgs<float> a = {};
  a.emb = (const float*)emb;
  a.cot = (float*)cot;
  a.G = G; a.E = E; a.D = D; a.HD = HD; a.DS = d_slice; a.ldc = HD;
  return (int)launch_dw_tc(a, (float*)dw_part, (float*)dw, n_split, s);
}
