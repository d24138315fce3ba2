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
//   s = <nq[src], nk[dst] + ekb>, stored as scores (G, H, E) f32, and the
//   max over masked edges per (graph, head) by an atomic max on the float.
// Pass A (denominators), once the torch glue has folded the self-loop scores
//   into gmax: denom[g, src, h] += exp(min(s - gmax, 0)) and
//   deg[g, src] += 1 over masked edges, by atomicAdd. The TPU kernel keeps a
//   running max and rescales its denominators online only because its grid
//   runs in order; blocks here run in parallel, so the max comes first.
// Pass C: per edge, msg = nm[src] + emb[e] W_me + b_me and
//   alpha = exp(min(s - gmax, 0)) * scale[src, h]; out[g, dst] += alpha * msg
//   by 16-byte atomicAdd into an f32 accumulator that the caller seeded with
//   the self-loop term. Masked edges are skipped, so their values never
//   enter.
//
// Bound on the H100 (G=64, N=200, E=4096, D=HD=200, bf16): the per-edge
// projection is 2*G*E*D*HD = 21 GFLOP per pass, against roughly 120-140 MB
// of traffic, so with tensor cores the passes are bound by bytes. This
// version runs the projection on CUDA cores in f32 (67 TFLOP/s peak, 0.31 ms
// for 21 GFLOP), which makes it bound by operations. It is a register-tiled
// product: a block takes 64 edges and every output column; K is staged in
// slices of 32, the edge embedding k-major and the weight (rounded to the
// compute dtype, as on the TPU) row-major in shared memory; each thread keeps
// 8 edges x 8 columns in registers and reads them with four 16-byte shared
// loads per 64 FMAs. Its columns are two runs of four, 4*tx and HD/2 + 4*tx,
// so a quarter-warp's 16-byte loads hit distinct banks. The per-head sums
// of the scores are partials per run, added up per (edge, head) from shared
// memory without atomics (shared float atomics on one address from many
// lanes serialise). (A first version kept a 4 x 16 tile read by scalar
// shared loads, five loads per 16 FMAs, and ran pass A in 3.3 ms and pass C
// in 2.2 ms.) Tensor cores are later work.
#include "gat_common.cuh"

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
    if (e < E) {
      const long long s_row = (g * N + src[g * E + e]) * HD;
      const long long d_row = (g * N + dst[g * E + e]) * HD;
      float q[8], k[8];
      load_row<T, 4>(nq + s_row + 4 * tx, q);
      load_row<T, 4>(nq + s_row + HD / 2 + 4 * tx, q + 4);
      load_row<T, 4>(nk + d_row + 4 * tx, k);
      load_row<T, 4>(nk + d_row + HD / 2 + 4 * tx, k + 4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = q[j] * (k[j] + acc[i][j] + bias[j]);
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

  // alpha per (edge, head); 0 for masked and padded slots
  for (int idx = tid; idx < TE * H; idx += nthreads) {
    const int el = idx / H, h = idx % H, e = e0 + el;
    float a = 0.0f;
    if (e < E && mask[g * E + e]) {
      const float x = scores[(g * H + h) * E + e] - gmax[g * H + h];
      a = expf(fminf(x, 0.0f)) * scale[(g * N + src[g * E + e]) * H + h];
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
      v[j] = s_alpha[el][head[j]] * (m[j] + acc[i][j] + bias[j]);
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

}  // namespace

// dtype: 0 = float32 node/edge inputs, 1 = bfloat16. Takes D % 8 == 0,
// HD % 8 == 0, HD <= 256, H <= 8 and 16-byte aligned arrays.
extern "C" int gat_pass_a_scores(const void* nq, const void* nk,
                                 const void* emb, const void* w_ke,
                                 const void* b_ke, const void* src,
                                 const void* dst, const void* mask,
                                 void* scores, void* m_edge, int G, int N,
                                 int E, int D, int HD, int H, int dtype,
                                 void* stream) {
  if (!shapes_ok(D, HD, H) || !aligned16(nq) || !aligned16(nk) ||
      !aligned16(emb) || !aligned16(w_ke))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  const dim3 grid((E + TE - 1) / TE, G);
  const int threads = HD / 8 * TY;
  const size_t smem = sizeof(float) * (KC * HD > red_floats(HD)
                                           ? KC * HD : red_floats(HD));
  cudaStream_t s = (cudaStream_t)stream;
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

extern "C" int gat_pass_c(const void* nm, const void* emb, const void* w_me,
                          const void* b_me, const void* scores,
                          const void* gmax, const void* scale,
                          const void* src, const void* dst, const void* mask,
                          void* out, int G, int N, int E, int D, int HD,
                          int H, int dtype, void* stream) {
  if (!shapes_ok(D, HD, H) || !aligned16(nm) || !aligned16(emb) ||
      !aligned16(w_me) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  if ((long long)G * E == 0) return (int)cudaGetLastError();
  const dim3 grid((E + TE - 1) / TE, G);
  const int threads = HD / 8 * TY;
  const size_t smem = sizeof(float) * KC * HD;
  cudaStream_t s = (cudaStream_t)stream;
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
