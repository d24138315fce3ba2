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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TE = 64;          // edges per block
constexpr int KC = 32;          // depth of one staged slice of D
constexpr int EPT = 8;          // edges per thread
constexpr int TY = TE / EPT;    // threads along the edges
constexpr int TEP = TE + 4;     // padded row of the k-major embedding slice
constexpr int MAX_HD = 256;     // HD / 8 column threads, at most 32
constexpr int MAX_H = 8;
constexpr float NEG = -1e30f;

template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// n = 4 or 8 consecutive values of T at p (16-byte aligned for 8 bf16 or
// 4 f32, 8-byte aligned for 4 bf16), as f32
template <typename T, int n>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float* v) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < n; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else if constexpr (n == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
  } else {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(h[j]);
  }
}

// max on a float in memory (global or shared): signed-int order for values
// with a clear sign bit, reversed unsigned order for those with it set
// (-0.0 included)
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

// the thread's 8 output columns: 4*tx + j and HD/2 + 4*tx + j, j < 4
__device__ __forceinline__ int column(int tx, int j, int HD) {
  return (j < 4 ? 0 : HD / 2 - 4) + 4 * tx + j;
}

// acc[i][j] = sum_k emb[g, e0 + ty*EPT + i, k] * W[k, column(tx, j)] for the
// block's TE edges, with W rounded to T. Rows past E are zero.
template <typename T>
__device__ __forceinline__ void edge_projection(
    const T* __restrict__ emb, const float* __restrict__ w, long long g,
    int e0, int E, int D, int HD, float (*s_emb)[TEP], float* s_w,
    float acc[EPT][8]) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tx = tid % (HD / 8), ty = tid / (HD / 8);
  const int hd4 = HD / 4;
#pragma unroll
  for (int i = 0; i < EPT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < D; k0 += KC) {
    // TE x KC slice of the embedding, 8 values per load, stored k-major
    for (int idx = tid; idx < TE * (KC / 8); idx += nthreads) {
      const int r = idx / (KC / 8), kc = (idx % (KC / 8)) * 8;
      const int e = e0 + r, k = k0 + kc;
      float v[8];
      if (e < E && k < D) {
        load_row<T, 8>(emb + ((g * E + e) * D + k), v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) s_emb[kc + j][r] = v[j];
    }
    // KC x HD slice of the weight, rounded to T
    for (int idx = tid; idx < KC * hd4; idx += nthreads) {
      const int r = idx / hd4, c = (idx % hd4) * 4, k = k0 + r;
      float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (k < D) {
        q = *reinterpret_cast<const float4*>(w + (long long)k * HD + c);
        q.x = round_to<T>(q.x); q.y = round_to<T>(q.y);
        q.z = round_to<T>(q.z); q.w = round_to<T>(q.w);
      }
      *reinterpret_cast<float4*>(s_w + r * HD + c) = q;
    }
    __syncthreads();
    const int kmax = min(KC, D - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s_emb[kk][ty * EPT]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s_emb[kk][ty * EPT + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(s_w + kk * HD + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(s_w + kk * HD + HD / 2 + 4 * tx);
      const float av[EPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < EPT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
}

// Pass A's per-head sums: a run of four columns spans at most two heads
// (dph >= 4), so each thread leaves, per edge and run, the partial dot
// product of the run's first head and of the next one in s_red, laid out
// [run][column thread][slot][edge] with a padded edge row; one thread per
// (edge, head) then adds up the partials that belong to its head.
constexpr int RED_ROW = TE + 1;

__host__ __device__ constexpr int red_floats(int HD) {
  return 2 * (HD / 8) * 2 * RED_ROW;
}

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

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

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
