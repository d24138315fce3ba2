// Device helpers shared by the GAT kernels (gat_fwd.cu, gat_bwd.cu,
// gat_unproj.cu): typed row loads and stores, the float atomic max, and the
// register-tiled per-edge product that every pass of the projected op runs.
//
// The product: a block takes TE = 64 rows (edges of one graph) and every
// output column; the depth is staged in slices of KC = 32, the row operand
// k-major and the weight (rounded to the compute dtype, as on the TPU)
// row-major in shared memory; each thread keeps 8 rows x 8 columns in
// registers and reads them with four 16-byte shared loads per 64 FMAs. Its
// columns are two runs of four, 4*tx and C/2 + 4*tx, so a quarter-warp's
// 16-byte loads hit distinct banks.
#pragma once
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


// n = 4 values as T at p (16-byte aligned for f32, 8-byte for bf16)
template <typename T>
__device__ __forceinline__ void store_row4(T* __restrict__ p, const float* v) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    alignas(8) __nv_bfloat16 h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __float2bfloat16(v[j]);
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  }
}

// Per-head sums over a thread tile's columns (pass A's scores, backward
// pass 1's d_alpha): a run of four columns spans at most two heads
// (dph >= 4), so each thread leaves, per edge and run, the partial dot
// product of the run's first head and of the next one in s_red, laid out
// [run][column thread][slot][edge] with a padded edge row; one thread per
// (edge, head) then adds up the partials that belong to its head.
constexpr int RED_ROW = TE + 1;

__host__ __device__ constexpr int red_floats(int HD) {
  return 2 * (HD / 8) * 2 * RED_ROW;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace
