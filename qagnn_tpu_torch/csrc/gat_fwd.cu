// Forward of the projected relational GAT op: pass A (two launches) and
// pass C. Edges are batched per graph, (G, E) with local node indices and a
// mask; heads are head-major (feature h * dph + j).
//
// Replaces the TPU kernels
//   `_scores_proj_kernel` (qagnn_tpu/ops/pallas_gat.py:650, via
//   `_proj_pass_a` :966) -> gat_pass_a_scores + gat_pass_a_denoms
//   `_aggr_proj_kernel`   (qagnn_tpu/ops/pallas_gat.py:716, via
//   `_proj_pass_c` :988)  -> gat_pass_c
//
// Pass A (scores): per edge, ekb = emb[e] W_ke + b_ke, then per head
//   s = <nq[src], nk[dst] + ekb>, stored as scores (G, H, E) f32 (0 at a
//   masked slot, which nothing reads), and the max over masked edges per
//   (graph, head) by an atomic max on the float.
// Pass A (denominators), once the torch glue has folded the self-loop scores
//   into gmax: denom[g, src, h] += exp(min(s - gmax, 0)) and
//   deg[g, src] += 1 over masked edges, by atomicAdd. The TPU kernel keeps a
//   running max and rescales its denominators online only because its grid
//   runs in order; blocks here run in parallel, so the max comes first.
// Pass C: per edge, msg = nm[src] + emb[e] W_me + b_me and
//   alpha = round(exp(min(s - gmax, 0)) * round(scale[src, h]));
//   out[g, dst] += round(alpha * msg) by 16-byte atomicAdd into an f32
//   accumulator that the caller seeded with the self-loop term. round() is
//   to the compute dtype (the identity in f32), at the three places where
//   the TPU kernel rounds: it packs the scale into its compute-dtype node
//   plane, rounds alpha before the per-head broadcast and the weighted
//   message before the scatter. Masked edges are skipped, so their values
//   never enter.
//
// Bound on the H100 (G=64, N=200, E=4096, D=HD=200, bf16): the per-edge
// projection is 2*G*E*D*HD = 21 GFLOP per pass, against roughly 100-130 MB
// of traffic, so with tensor cores the passes are bound by bytes. Two routes
// behind each entry point, chosen in Python by dtype and widths alone:
//
// bfloat16, the main path: tensor cores (gat_fwd_tc.cuh, on the pieces it
// shares with the backward in gat_tc_common.cuh and mma_tile.cuh). Every
// operand of the projection is a bf16 value already (emb, W rounded to the
// compute dtype as on the TPU), so `mma.sync` with f32 accumulators computes
// the TPU kernel's sums. One launch a pass: persistent blocks with W resident
// in shared memory, each warp on 16 edge slots at a time, the row-wise
// epilogue after an f32 stage.
//
// On the H100 (NVIDIA H100 80GB HBM3, 700 W limit; the shapes above, 25% of
// slots masked; medians of 20 launches by CUDA events): the tensor-core
// route takes 0.235 ms for pass A's scores and 0.214 ms for pass C, against
// 1.10 and 1.05 ms for the CUDA-core kernels on the same bf16 inputs and
// bytes bounds of 28 and 32 us. As in the backward, the product (about 60 us
// of shared-memory-bound `mma.sync`), the node gathers through L2 and the
// epilogue's arithmetic run in turn within each warp, and registers (about
// 200 a lane) hold a block to 8 warps. Issuing the first group's gathers
// before the product gained 3.5% on pass A; gathering 8 rows at a time in
// pass C lost 1%. Pass A keeps its head sums' values in local memory (a
// 64-128 byte stack frame, as backward pass 1 does); a `selp` select in
// `warp_sums` did not remove it and gained nothing.
//
// float32 (and bfloat16 when asked for, to time the two side by side): the
// CUDA-core kernels below, in full f32 (TF32 would change the values). The
// projection is a register-tiled product: a block takes 64 edges and every
// output column; K is staged in slices of 32, the edge embedding k-major and
// the weight (rounded to the compute dtype) row-major in shared memory; each
// thread keeps 8 edges x 8 columns in registers and reads them with four
// 16-byte shared loads per 64 FMAs (19-20 TFLOP/s, about 1.05 ms a pass at
// the shapes above). Its columns are two runs of four, 4*tx and HD/2 + 4*tx,
// so a quarter-warp's 16-byte loads hit distinct banks. The per-head sums
// of the scores are partials per run, added up per (edge, head) from shared
// memory without atomics (shared float atomics on one address from many
// lanes serialise).
#include "gat_common.cuh"
#include "gat_fwd_tc.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(MAX_HD)
pass_a_scores_kernel(const T* __restrict__ nq, const T* __restrict__ nk,
                     const T* __restrict__ emb, const float* __restrict__ w_ke,
                     const float* __restrict__ b_ke,
                     const int32_t* __restrict__ src,
                     const int32_t* __restrict__ dst,
                     const uint8_t* __restrict__ mask,
                     float* __restrict__ scores, float* __restrict__ m_edge,
                     int E, int N, int D, int HD, int H) {
  __shared__ __align__(16) float s_emb[KC][TEP];
  __shared__ int s_head0[2][MAX_HD / 8];
  __shared__ float s_max[MAX_H];
  extern __shared__ __align__(16) float s_w[];   // then s_red
  const long long g = blockIdx.y;
  const int e0 = blockIdx.x * TE;
  const int tid = threadIdx.x, nthreads = blockDim.x, ntx = HD / 8;
  const int tx = tid % ntx, ty = tid / ntx;
  const int dph = HD / H;

  if (tid < 2 * ntx)
    s_head0[tid / ntx][tid % ntx] = column(tid % ntx, 4 * (tid / ntx), HD) / dph;
  if (tid < MAX_H) s_max[tid] = NEG;

  float acc[EPT][8];
  edge_projection<T>(emb, w_ke, g, e0, E, D, HD, s_emb, s_w, acc);

  // the projection ended on a barrier: s_w is free for the partial sums
  float* s_red = s_w;
  int head[8];
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    head[j] = column(tx, j, HD) / dph;
    bias[j] = b_ke[column(tx, j, HD)];
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int el = ty * EPT + i, e = e0 + el;
    float first[2] = {0.0f, 0.0f}, next[2] = {0.0f, 0.0f};
    if (e < E && mask[g * E + e]) {       // a masked slot scores 0
      const long long s_row = (g * N + src[g * E + e]) * HD;
      const long long d_row = (g * N + dst[g * E + e]) * HD;
      float q[8], k[8];
      load_row<T, 4>(nq + s_row + 4 * tx, q);
      load_row<T, 4>(nq + s_row + HD / 2 + 4 * tx, q + 4);
      load_row<T, 4>(nk + d_row + 4 * tx, k);
      load_row<T, 4>(nk + d_row + HD / 2 + 4 * tx, k + 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = q[j] * (k[j] + (acc[i][j] + bias[j]));
        if (head[j] == head[j & 4]) first[j / 4] += p;
        else next[j / 4] += p;
      }
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
    for (int run = 0; run < 2; ++run)
      for (int t = 0; t < ntx; ++t) {
        const int h0 = s_head0[run][t];
        if (h0 == h) v += s_red[((run * ntx + t) * 2) * RED_ROW + el];
        else if (h0 + 1 == h)
          v += s_red[((run * ntx + t) * 2 + 1) * RED_ROW + el];
      }
    scores[(g * H + h) * E + e] = v;
    if (mask[g * E + e]) atomic_max_float(&s_max[h], v);
  }
  __syncthreads();
  if (tid < H && s_max[tid] > NEG)
    atomic_max_float(&m_edge[g * H + tid], s_max[tid]);
}

__global__ void pass_a_denoms_kernel(const float* __restrict__ scores,
                                     const float* __restrict__ gmax,
                                     const int32_t* __restrict__ src,
                                     const uint8_t* __restrict__ mask,
                                     float* __restrict__ denom,
                                     float* __restrict__ deg,
                                     long long n_edges, int E, int N, int H) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_edges || !mask[i]) return;
  const long long g = i / E;
  const int e = (int)(i % E);
  const long long node = g * N + src[i];
  for (int h = 0; h < H; ++h) {
    const float x = scores[(g * H + h) * E + e] - gmax[g * H + h];
    atomicAdd(&denom[node * H + h], expf(fminf(x, 0.0f)));
  }
  atomicAdd(&deg[node], 1.0f);
}

template <typename T>
__global__ void __launch_bounds__(MAX_HD)
pass_c_kernel(const T* __restrict__ nm, const T* __restrict__ emb,
              const float* __restrict__ w_me, const float* __restrict__ b_me,
              const float* __restrict__ scores, const float* __restrict__ gmax,
              const float* __restrict__ scale,
              const int32_t* __restrict__ src,
              const int32_t* __restrict__ dst,
              const uint8_t* __restrict__ mask, float* __restrict__ out,
              int E, int N, int D, int HD, int H) {
  __shared__ __align__(16) float s_emb[KC][TEP];
  __shared__ float s_alpha[TE][MAX_H];
  extern __shared__ __align__(16) float s_w[];
  const long long g = blockIdx.y;
  const int e0 = blockIdx.x * TE;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tx = tid % (HD / 8), ty = tid / (HD / 8);
  const int dph = HD / H;

  // alpha per (edge, head), rounded to T with the scale it is made from;
  // 0 for masked and padded slots
  for (int idx = tid; idx < TE * H; idx += nthreads) {
    const int el = idx / H, h = idx % H, e = e0 + el;
    float a = 0.0f;
    if (e < E && mask[g * E + e]) {
      const float x = scores[(g * H + h) * E + e] - gmax[g * H + h];
      a = round_to<T>(expf(fminf(x, 0.0f)) *
                      round_to<T>(scale[(g * N + src[g * E + e]) * H + h]));
    }
    s_alpha[el][h] = a;
  }

  float acc[EPT][8];
  edge_projection<T>(emb, w_me, g, e0, E, D, HD, s_emb, s_w, acc);

  int head[8];
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    head[j] = column(tx, j, HD) / dph;
    bias[j] = b_me[column(tx, j, HD)];
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int el = ty * EPT + i, e = e0 + el;
    if (e >= E || !mask[g * E + e]) continue;
    const long long s_row = (g * N + src[g * E + e]) * HD;
    const long long d_row = (g * N + dst[g * E + e]) * HD;
    float m[8], v[8];
    load_row<T, 4>(nm + s_row + 4 * tx, m);
    load_row<T, 4>(nm + s_row + HD / 2 + 4 * tx, m + 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = round_to<T>(s_alpha[el][head[j]] *
                         (m[j] + (acc[i][j] + bias[j])));
    atomicAdd(reinterpret_cast<float4*>(out + d_row + 4 * tx),
              make_float4(v[0], v[1], v[2], v[3]));
    atomicAdd(reinterpret_cast<float4*>(out + d_row + HD / 2 + 4 * tx),
              make_float4(v[4], v[5], v[6], v[7]));
  }
}

bool shapes_ok(int D, int HD, int H) {
  return D > 0 && D % 8 == 0 && HD > 0 && HD % 8 == 0 && HD <= MAX_HD &&
         H > 0 && H <= MAX_H && HD % H == 0;
}

// route 0: the CUDA-core kernels, either dtype; route 1: tensor cores,
// bfloat16 with D <= 256 and heads of at least 4 features
bool route_ok(int route, int dtype, int D, int HD, int H) {
  return route == 0 ||
         (route == 1 && dtype == 1 && D <= MAX_HD && HD / H >= 4);
}

}  // namespace

// dtype: 0 = float32 node/edge inputs, 1 = bfloat16. Takes D % 8 == 0,
// HD % 8 == 0, HD <= 256, H <= 8 and 16-byte aligned arrays. route 0 runs a
// (64-edge tile, graph) grid and reads neither warps nor n_blocks; route 1
// runs n_blocks persistent blocks of `warps` warps (see route_ok). Every
// slot's score is written, 0 where the slot is masked.
extern "C" int gat_pass_a_scores(const void* nq, const void* nk,
                                 const void* emb, const void* w_ke,
                                 const void* b_ke, const void* src,
                                 const void* dst, const void* mask,
                                 void* scores, void* m_edge, int G, int N,
                                 int E, int D, int HD, int H, int dtype,
                                 int route, int warps, int n_blocks,
                                 void* stream) {
  if (!shapes_ok(D, HD, H) || !route_ok(route, dtype, D, HD, H) ||
      !aligned16(nq) || !aligned16(nk) || !aligned16(emb) ||
      !aligned16(w_ke))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    TcFwdArgs a = {};
    a.rows_src = (const bf16*)nq;
    a.rows_dst = (const bf16*)nk;
    a.emb = (const bf16*)emb;
    a.w = (const float*)w_ke;
    a.bias = (const float*)b_ke;
    a.src = (const int32_t*)src;
    a.dst = (const int32_t*)dst;
    a.mask = (const uint8_t*)mask;
    a.scores_out = (float*)scores;
    a.m_edge = (float*)m_edge;
    a.G = G; a.N = N; a.E = E; a.D = D; a.HD = HD; a.H = H;
    return launch_fwd_tc<1>(a, warps, n_blocks, s);
  }
  const dim3 grid((E + TE - 1) / TE, G);
  const int threads = HD / 8 * TY;
  const size_t smem = sizeof(float) * (KC * HD > red_floats(HD)
                                           ? KC * HD : red_floats(HD));
  if (dtype == 1)
    pass_a_scores_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(
        (const __nv_bfloat16*)nq, (const __nv_bfloat16*)nk,
        (const __nv_bfloat16*)emb, (const float*)w_ke, (const float*)b_ke,
        (const int32_t*)src, (const int32_t*)dst, (const uint8_t*)mask,
        (float*)scores, (float*)m_edge, E, N, D, HD, H);
  else
    pass_a_scores_kernel<float><<<grid, threads, smem, s>>>(
        (const float*)nq, (const float*)nk, (const float*)emb,
        (const float*)w_ke, (const float*)b_ke, (const int32_t*)src,
        (const int32_t*)dst, (const uint8_t*)mask, (float*)scores,
        (float*)m_edge, E, N, D, HD, H);
  return (int)cudaGetLastError();
}

extern "C" int gat_pass_a_denoms(const void* scores, const void* gmax,
                                 const void* src, const void* mask,
                                 void* denom, void* deg, int G, int N, int E,
                                 int H, void* stream) {
  const long long n_edges = (long long)G * E;
  if (n_edges == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_edges + threads - 1) / threads);
  pass_a_denoms_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)gmax, (const int32_t*)src,
      (const uint8_t*)mask, (float*)denom, (float*)deg, n_edges, E, N, H);
  return (int)cudaGetLastError();
}

// route, warps and n_blocks as in gat_pass_a_scores. out is the f32
// accumulator, added to in place.
extern "C" int gat_pass_c(const void* nm, const void* emb, const void* w_me,
                          const void* b_me, const void* scores,
                          const void* gmax, const void* scale,
                          const void* src, const void* dst, const void* mask,
                          void* out, int G, int N, int E, int D, int HD,
                          int H, int dtype, int route, int warps,
                          int n_blocks, void* stream) {
  if (!shapes_ok(D, HD, H) || !route_ok(route, dtype, D, HD, H) ||
      !aligned16(nm) || !aligned16(emb) || !aligned16(w_me) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    TcFwdArgs a = {};
    a.rows_src = (const bf16*)nm;
    a.emb = (const bf16*)emb;
    a.w = (const float*)w_me;
    a.bias = (const float*)b_me;
    a.scores = (const float*)scores;
    a.gmax = (const float*)gmax;
    a.scale = (const float*)scale;
    a.src = (const int32_t*)src;
    a.dst = (const int32_t*)dst;
    a.mask = (const uint8_t*)mask;
    a.out = (float*)out;
    a.G = G; a.N = N; a.E = E; a.D = D; a.HD = HD; a.H = H;
    return launch_fwd_tc<3>(a, warps, n_blocks, s);
  }
  const dim3 grid((E + TE - 1) / TE, G);
  const int threads = HD / 8 * TY;
  const size_t smem = sizeof(float) * KC * HD;
  if (dtype == 1)
    pass_c_kernel<__nv_bfloat16><<<grid, threads, smem, s>>>(
        (const __nv_bfloat16*)nm, (const __nv_bfloat16*)emb,
        (const float*)w_me, (const float*)b_me, (const float*)scores,
        (const float*)gmax, (const float*)scale, (const int32_t*)src,
        (const int32_t*)dst, (const uint8_t*)mask, (float*)out, E, N, D, HD,
        H);
  else
    pass_c_kernel<float><<<grid, threads, smem, s>>>(
        (const float*)nm, (const float*)emb, (const float*)w_me,
        (const float*)b_me, (const float*)scores, (const float*)gmax,
        (const float*)scale, (const int32_t*)src, (const int32_t*)dst,
        (const uint8_t*)mask, (float*)out, E, N, D, HD, H);
  return (int)cudaGetLastError();
}
